"""The split of the flash-attention backward's dQ key walk, on the CPU.

Where a short query sequence leaves the dQ kernel's grid below one wave of
the card's SMs, ``flash_attention.dq_splits`` cuts each block's key walk
into ranges (``key_range`` in the kernels, ``dq_key_ranges`` here), each
block writes an f32 partial dq, and the last kernel sums the partials in
range order.  The kernels run only on the card
(``tests/test_torch_cuda.py``); here the rule is held at the
training shapes, and a plain torch emulation of the split -- the softmax's
dS over each range's keys times those keys, for every 64-row tile of
folded rows as the kernels cut them -- is held to the port's plain gradient
and to ``jax.vjp`` of the JAX package's ``repro.kernels.ref
.reference_attention`` on the same numpy inputs, within the atol = rtol =
1e-5 of ``tests/test_torch_trainer.py::test_attention_gradient_matches_jax``
(f32 sums in another order).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref

H100_SMS = 132

#: (B, S, Sk, H, Hk) of one attention call at the training shapes of
#: chip_smoke.py's phases 13 and 30-32 (and llama4's and stablelm-12b's
#: layers), with the ranges the rule gives on an H100: whisper's
#: cross-attention (64 decoder positions against 1500 frames, 48 dQ blocks)
#: is the only one split.
TRAINING_SHAPES = {
    "tinyllama_phase13": ((2, 512, 512, 32, 4), 1),
    "phi35_phase30": ((1, 512, 512, 32, 8), 1),
    "whisper_encoder_phase31": ((4, 1500, 1500, 12, 12), 1),
    "whisper_decoder_self_phase31": ((4, 64, 64, 12, 12), 1),
    "whisper_cross_phase31": ((4, 64, 1500, 12, 12), 3),
    "internvl2_phase32": ((4, 768, 768, 14, 2), 1),
    "llama4": ((1, 512, 512, 40, 8), 1),
    "stablelm12b": ((1, 512, 512, 32, 8), 1),
}


@pytest.mark.parametrize("name", list(TRAINING_SHAPES))
def test_dq_splits_at_the_training_shapes(name):
    shape, want = TRAINING_SHAPES[name]
    assert fa.dq_splits(*shape, H100_SMS) == want


def _dq_blocks(B, S, H, Hk):
    return math.ceil(S * (H // Hk) / fa.DQ_ROW_TILE) * B * Hk


@pytest.mark.parametrize("sms", [132, 114, 16])
def test_dq_splits_rule(sms):
    """1 exactly where the row tiles fill the SMs; never more ranges than
    key tiles, nor one shorter than ``DQ_MIN_RANGE_TILES``; no more than
    one wave's worth of blocks asked for."""
    for B in (1, 2, 4):
        for S in (1, 16, 64, 100, 512, 1500):
            for Sk in (1, 37, 64, 150, 200, 1000, 1500, 8192):
                for H, Hk in ((1, 1), (2, 1), (12, 12), (32, 8), (14, 2)):
                    n = fa.dq_splits(B, S, Sk, H, Hk, sms)
                    blocks = _dq_blocks(B, S, H, Hk)
                    tiles = math.ceil(Sk / fa.DQ_KEY_TILE)
                    assert 1 <= n <= tiles
                    if blocks >= sms:
                        assert n == 1
                    if n > 1:
                        assert tiles // n >= fa.DQ_MIN_RANGE_TILES
                        assert (n - 1) * blocks < sms


def dq_key_ranges(n_tiles, splits):
    """The key tiles ``[t0, t1)`` of each range of a dQ block that sees
    ``n_tiles`` tiles, as the kernels' ``key_range`` cuts them: runs of
    ``ceil(n_tiles / splits)``, the last ones shorter or empty."""
    per = -(-n_tiles // splits)
    return [(min(n_tiles, z * per), min(n_tiles, z * per + per)) for z in range(splits)]


def test_dq_key_ranges_cover_the_walk_in_order():
    for n_tiles in (0, 1, 2, 5, 24, 47):
        for splits in (1, 2, 3, 8):
            ranges = dq_key_ranges(n_tiles, splits)
            assert len(ranges) == splits
            per = -(-n_tiles // splits)
            at = 0
            for t0, t1 in ranges:
                assert t0 == at and t0 <= t1 and t1 - t0 <= per
                at = t1
            assert at == n_tiles


def split_dq(q, k, v, dout, causal, splits, tile=fa.DQ_KEY_TILE):
    """dq the way the split kernels form it, in plain f32 torch: per
    64-row tile of folded (position, group member) rows, its visible key
    tiles cut by ``dq_key_ranges``, one partial dS[:, keys] k[keys] per range,
    the partials summed in range order and scaled once."""
    B, S, H, hd = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    G = H // Hk
    rows = S * G

    def fold(x):  # (B, S, H, hd) -> (B, Hk, S * G, hd), row = pos * G + g
        return x.float().reshape(B, S, Hk, G, hd).permute(0, 2, 1, 3, 4).reshape(B, Hk, rows, hd)

    qf, df = fold(q), fold(dout)
    of = fold(ref.reference_attention(q, k, v, causal=causal))
    kf, vf = (t.float().permute(0, 2, 1, 3) for t in (k, v))  # (B, Hk, Sk, hd)
    scale = 1.0 / math.sqrt(hd)
    s = qf @ kf.transpose(-1, -2) * scale
    pos = torch.arange(rows) // G
    if causal:
        s = s.masked_fill(pos[:, None] < torch.arange(Sk)[None, :], -1e30)
    p = torch.softmax(s, dim=-1)
    D = (df * of).sum(-1, keepdim=True)
    ds = p * (df @ vf.transpose(-1, -2) - D)
    parts = torch.zeros((splits, B, Hk, rows, hd))
    for r0 in range(0, rows, fa.DQ_ROW_TILE):
        r1 = min(r0 + fa.DQ_ROW_TILE, rows)
        n = math.ceil(Sk / tile)
        if causal:
            n = min(n, int(pos[r1 - 1]) // tile + 1)
        for z, (t0, t1) in enumerate(dq_key_ranges(n, splits)):
            k0, k1 = t0 * tile, min(t1 * tile, Sk)
            parts[z, :, :, r0:r1] = ds[:, :, r0:r1, k0:k1] @ kf[:, :, k0:k1]
    dq = torch.zeros((B, Hk, rows, hd))
    for part in parts:
        dq = dq + part
    dq = dq * scale
    return dq.reshape(B, Hk, S, G, hd).permute(0, 2, 1, 3, 4).reshape(B, S, H, hd), parts


#: Short-query shapes cut for the CPU (B, S, Sk, H, Hk, hd, causal): S = 16
#: against Sk = 200 with G = 2 (2 ranges at 132 SMs), also causal (the
#: second range then sees no key), and MQA at Sk = 450 (4 ranges).
SHORT_QUERY_CASES = [
    (1, 16, 200, 2, 1, 16, False),
    (1, 16, 200, 2, 1, 16, True),
    (2, 8, 450, 4, 1, 8, False),
]


def _inputs(case, seed=4):
    B, S, Sk, H, Hk, hd, _ = case
    rng = np.random.default_rng(seed)
    q, dout = (rng.standard_normal((B, S, H, hd)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((B, Sk, Hk, hd)).astype(np.float32) for _ in range(2))
    return q, k, v, dout


@pytest.mark.parametrize("case", SHORT_QUERY_CASES, ids=lambda c: "-".join(map(str, c)))
def test_split_dq_sums_to_the_whole_gradient(case):
    B, S, Sk, H, Hk, hd, causal = case
    splits = fa.dq_splits(B, S, Sk, H, Hk, H100_SMS)
    assert splits > 1
    q, k, v, dout = (torch.from_numpy(a) for a in _inputs(case))
    dq, parts = split_dq(q, k, v, dout, causal, splits)
    want = ref.reference_attention_backward(q, k, v, dout, causal=causal)[0]
    torch.testing.assert_close(dq, want, atol=1e-5, rtol=1e-5)
    if causal:  # no query sees past key 15: every range after the first is empty
        assert not parts[1:].any()
    else:
        assert all(p.abs().max() > 0 for p in parts)


@pytest.mark.parametrize("case", SHORT_QUERY_CASES, ids=lambda c: "-".join(map(str, c)))
def test_split_dq_matches_jax_vjp(case):
    B, S, Sk, H, Hk, hd, causal = case
    q, k, v, dout = _inputs(case)
    _, vjp = jax.vjp(lambda a, b, c: jref.reference_attention(a, b, c, causal=causal),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = np.asarray(vjp(jnp.asarray(dout))[0])
    splits = fa.dq_splits(B, S, Sk, H, Hk, H100_SMS)
    got, _ = split_dq(*(torch.from_numpy(a) for a in (q, k, v, dout)), causal, splits)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
