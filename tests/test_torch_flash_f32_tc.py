"""The f32 flash attention on 3xTF32 tensor cores, and the embedding lookup
on DTensors (ROADMAP C19), on the CPU.

The f32 bodies of ``csrc/flash_attention.cu`` and
``csrc/flash_attention_bwd.cu`` run every product as three TF32 ones on
``mma.sync``: each operand split into a big part, rounded to TF32 as
``cvt.rna`` does (add 0x1000 to the f32 bits, keep the top 19), and the
remainder, which the tensor core reads with its low 13 bits dropped; big *
big + big * small + small * big is summed in f32.  The forward's key walk is
cut into ranges (``flash_attention.dq_splits``) where its row tiles leave the
card's SMs idle, each range's unnormalised output, running max and sum
merged in range order.  The kernels run only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``); here a plain torch
emulation of that arithmetic -- the rounding, the 3xTF32 products, the ranged
walk in the log2 domain with its masks and its guard for a range that holds
no key a row may see, the merge and the log-sum-exp, and the backward's five
products recomputing P from that log-sum-exp -- is held on numpy-seeded
inputs to the JAX package's ``repro.kernels.ref.reference_attention`` (atol =
rtol = 2e-5, tests/test_kernels.py:43) and to ``jax.vjp`` of it (1e-4 of each
gradient's max |grad|, the backward kernels' tolerance on the card).  One
TF32 product instead of three misses the forward's tolerance.

The split rule is held at the shapes the families launch: only whisper's
f32 cross-attention (64 decoder positions against 1500 frames) splits, into
3 ranges on an H100's 132 SMs; bf16 never does.

C19: ``models/modules.py:embedding_lookup`` on DTensors looks up each rank's
ids in its own columns of the table.  In a gloo group of 4 ranks (2 'data' x
2 'model', the serving plan's layout: ids split on the batch, the table's D
on 'model') the output equals the plain lookup and the JAX gather, each
rank holding (B/2, S, D/2), and the table's gradient equals the plain one;
with the table split on its vocab the lookup falls back to DTensor's rule
and agrees too.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _dist_ranks as dr
from repro.kernels import ref as jref
from repro.models import modules as jmodules
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref
from test_torch_flash_bwd_split import dq_key_ranges

H100_SMS = 132
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
NEG = -1e30
TILE = fa.DQ_KEY_TILE
FWD_TOL = 2e-5
BWD_TOL = 1e-4

# ------------------------------------------------------------- arithmetic


def tf32_round(x):
    """x rounded to TF32 as ``split_tf32`` (``cvt.rna``) does: 0x1000 added
    to the f32 bits, the low 13 bits cleared (-8192 is 0xFFFFE000)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -8192).view(torch.float32)


def tf32_read(x):
    """An f32 register as the tensor core reads it as TF32: the low 13 bits
    dropped."""
    return (x.contiguous().view(torch.int32) & -8192).view(torch.float32)


def split(x):
    big = tf32_round(x)
    return big, tf32_read(x - big)


def mma3(a, b):
    """a @ b in 3xTF32: small * big + big * small + big * big, f32 sums."""
    ab, as_ = split(a)
    bb, bs = split(b)
    return as_ @ bb + ab @ bs + ab @ bb


def mma1(a, b):
    """a @ b as one TF32 product."""
    return tf32_round(a) @ tf32_round(b)


def fold(x, Hk):
    """(B, S, H, hd) -> (B, Hk, S * G, hd), row = position * G + group member."""
    B, S, H, hd = x.shape
    G = H // Hk
    return x.float().reshape(B, S, Hk, G, hd).permute(0, 2, 1, 3, 4).reshape(B, Hk, S * G, hd)


def unfold(x, S, H):
    B, Hk, rows, hd = x.shape
    return x.reshape(B, Hk, S, H // Hk, hd).permute(0, 2, 1, 3, 4).reshape(B, S, H, hd)


def range_walk(qr, kf, vf, pos, t0, t1, causal, mm):
    """One block's walk over key tiles [t0, t1) for its rows qr (B, Hk, R,
    hd) at positions pos: the online softmax in the log2 domain of the
    scaled scores, masked scores at -1e30 -> (o unnormalised, m, l).  A row
    that sees no key of the range keeps m = -1e30 and stores l = 0, o = 0."""
    B, Hk, R, hd = qr.shape
    Sk = kf.shape[2]
    scale_log2 = LOG2E / math.sqrt(hd)
    m = torch.full((B, Hk, R), NEG)
    l = torch.zeros((B, Hk, R))
    o = torch.zeros((B, Hk, R, hd))
    for kt in range(t0, t1):
        k0, k1 = kt * TILE, min(kt * TILE + TILE, Sk)
        s = mm(qr, kf[:, :, k0:k1].transpose(-1, -2)) * scale_log2
        if causal:
            s = s.masked_fill(torch.arange(k0, k1)[None, :] > pos[:, None], NEG)
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None])
        l = l * corr + p.sum(-1)
        o = o * corr[..., None] + mm(p, vf[:, :, k0:k1])
        m = m_new
    none = m <= NEG
    return o.masked_fill(none[..., None], 0.0), m, l.masked_fill(none, 0.0)


def merge(parts):
    """The ranges' (o, m, l) in range order -> (out, lse in natural log)."""
    m = parts[0][1]
    for _, mz, _ in parts[1:]:
        m = torch.maximum(m, mz)
    o, l = torch.zeros_like(parts[0][0]), torch.zeros_like(m)
    for oz, mz, lz in parts:
        w = torch.exp2(mz - m)
        l = l + lz * w
        o = o + oz * w[..., None]
    l = l.clamp_min(1e-30)
    return o / l[..., None], (m + torch.log2(l)) * LN2


def forward_emulated(q, k, v, causal, splits, mm=mma3):
    """The f32 forward as the kernels form it -> (out (B, S, H, hd), lse
    (B, H, S), each 64-row tile's ranges' (o, m, l))."""
    B, S, H, hd = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    G = H // Hk
    qf = fold(q, Hk)
    kf, vf = (t.float().permute(0, 2, 1, 3) for t in (k, v))
    rows = S * G
    pos = torch.arange(rows) // G
    out = torch.zeros((B, Hk, rows, hd))
    lse = torch.zeros((B, Hk, rows))
    blocks = []
    for r0 in range(0, rows, fa.DQ_ROW_TILE):
        r1 = min(r0 + fa.DQ_ROW_TILE, rows)
        n = math.ceil(Sk / TILE)
        if causal:
            n = min(n, int(pos[r1 - 1]) // TILE + 1)
        parts = [range_walk(qf[:, :, r0:r1], kf, vf, pos[r0:r1], t0, t1, causal, mm)
                 for t0, t1 in dq_key_ranges(n, splits)]
        out[:, :, r0:r1], lse[:, :, r0:r1] = merge(parts)
        blocks.append(parts)
    lse = lse.reshape(B, Hk, S, G).permute(0, 1, 3, 2).reshape(B, H, S)
    return unfold(out, S, H), lse, blocks


def backward_emulated(q, k, v, o, lse, dout, causal):
    """The five products in 3xTF32, P recomputed from the merged lse ->
    (dq, dk, dv); dk and dv sum their KV head's G query heads."""
    B, S, H, hd = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    G = H // Hk
    qf, of, df = fold(q, Hk), fold(o, Hk), fold(dout, Hk)
    kf, vf = (t.float().permute(0, 2, 1, 3) for t in (k, v))
    lsef = lse.reshape(B, Hk, G, S).permute(0, 1, 3, 2).reshape(B, Hk, S * G)
    scale = 1.0 / math.sqrt(hd)
    p = torch.exp2(mma3(qf, kf.transpose(-1, -2)) * (scale * LOG2E) - lsef[..., None] * LOG2E)
    if causal:
        p = p.masked_fill(torch.arange(Sk)[None, :] > (torch.arange(S * G) // G)[:, None], 0.0)
    D = (df * of).sum(-1, keepdim=True)
    ds = p * (mma3(df, vf.transpose(-1, -2)) - D)
    dv = mma3(p.transpose(-1, -2), df)
    dk = mma3(ds.transpose(-1, -2), qf) * scale
    dq = mma3(ds, kf) * scale
    return unfold(dq, S, H), dk.permute(0, 2, 1, 3), dv.permute(0, 2, 1, 3)


# ------------------------------------------------------------------ cases

#: (B, S, Sk, H, Hk, hd, causal): whisper's cross-attention cut to B 1, H 2
#: (64 queries against 1500 frames, 12 ranges at 132 SMs); a ragged causal
#: one whose later tiles' walks split in two (300 positions, one head); and
#: S = 16 against Sk = 200 causal with G = 2, whose second range lies past
#: every row's limit.
CASES = [(1, 64, 1500, 2, 2, 64, False), (1, 300, 300, 1, 1, 32, True),
         (1, 16, 200, 2, 1, 64, True)]


def _inputs(case, seed=27):
    B, S, Sk, H, Hk, hd, _ = case
    rng = np.random.default_rng(seed)
    q, dout = (rng.standard_normal((B, S, H, hd)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((B, Sk, Hk, hd)).astype(np.float32) for _ in range(2))
    return q, k, v, dout


def _jax_lse(q, k, causal):
    """The rows' natural log-sum-exp, in float64 numpy -> (B, H, S)."""
    B, S, H, hd = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    kk = np.repeat(k.astype(np.float64), H // Hk, axis=2)
    s = np.einsum("bshd,bkhd->bhsk", q.astype(np.float64), kk) / math.sqrt(hd)
    if causal:
        s = np.where(np.arange(Sk)[None, :] > np.arange(S)[:, None], -1e30, s)
    top = s.max(-1, keepdims=True)
    return (top + np.log(np.exp(s - top).sum(-1, keepdims=True)))[..., 0]


def test_tf32_rounding_matches_cvt_rna():
    """Ties round away from zero, the result keeps 10 mantissa bits, and big
    + small is x within 2^-21 |x| (the small part read as TF32)."""
    one_ulp = 2.0 ** -10
    x = torch.tensor([1.0 + one_ulp / 2, -(1.0 + one_ulp / 2), 1.0 + one_ulp / 4, 3.0],
                     dtype=torch.float32)
    want = torch.tensor([1.0 + one_ulp, -(1.0 + one_ulp), 1.0, 3.0])
    assert torch.equal(tf32_round(x), want)
    y = torch.from_numpy(np.random.default_rng(0).standard_normal(10000).astype(np.float32))
    big, small = split(y)
    assert not (big.view(torch.int32) & 0x1FFF).any()
    assert ((big + small - y).abs() <= 2.0 ** -21 * y.abs()).all()


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_ranged_forward_matches_jax(case):
    B, S, Sk, H, Hk, hd, causal = case
    q, k, v, _ = _inputs(case)
    splits = fa.dq_splits(B, S, Sk, H, Hk, H100_SMS)
    assert splits > 1
    got, lse, blocks = forward_emulated(*(torch.from_numpy(a) for a in (q, k, v)), causal,
                                        splits)
    want = np.asarray(jref.reference_attention(jnp.asarray(q), jnp.asarray(k),
                                               jnp.asarray(v), causal=causal))
    np.testing.assert_allclose(got.numpy(), want, atol=FWD_TOL, rtol=FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), _jax_lse(q, k, causal), atol=FWD_TOL,
                               rtol=FWD_TOL)
    for parts in blocks:
        for o, m, l in parts:
            assert torch.isfinite(o).all() and torch.isfinite(l).all()
            # A range with no key a row sees carries no weight into the merge.
            none = m <= NEG
            assert not l[none].any() and not o[none].any()
    if causal and S < TILE:
        assert all((parts[1][1] <= NEG).all() for parts in blocks)


def test_a_range_past_the_rows_limit_adds_nothing():
    """Rows at positions 0..15 against keys 64..127 of a causal walk: every
    score is masked, the range stores l = 0 and o = 0 (not 64 masked keys'
    mean), and merged with the range that holds their keys it changes
    nothing, bit for bit."""
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs((1, 16, 200, 1, 1, 32, True)))
    qf, kf, vf = fold(q, 1), k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
    pos = torch.arange(16)
    seen = range_walk(qf, kf, vf, pos, 0, 1, True, mma3)
    past = range_walk(qf, kf, vf, pos, 1, 2, True, mma3)
    assert (past[1] <= NEG).all() and not past[2].any() and not past[0].any()
    alone, merged = merge([seen]), merge([seen, past])
    assert torch.equal(alone[0], merged[0]) and torch.equal(alone[1], merged[1])


def test_one_tf32_product_misses_the_tolerance():
    """Why three products: one TF32 product (11 bits an operand) puts
    whisper's cross-attention beyond 2e-5, where 3xTF32 holds it."""
    case = CASES[0]
    q, k, v, _ = _inputs(case)
    want = np.asarray(jref.reference_attention(jnp.asarray(q), jnp.asarray(k),
                                               jnp.asarray(v), causal=False))
    got, _, _ = forward_emulated(*(torch.from_numpy(a) for a in (q, k, v)), False, 1,
                                 mm=mma1)
    excess = np.abs(got.numpy() - want) - FWD_TOL * np.abs(want)
    assert excess.max() > FWD_TOL


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_backward_on_the_merged_lse_matches_jax_vjp(case):
    B, S, Sk, H, Hk, hd, causal = case
    q, k, v, dout = _inputs(case)
    splits = fa.dq_splits(B, S, Sk, H, Hk, H100_SMS)
    tq, tk, tv, td = (torch.from_numpy(a) for a in (q, k, v, dout))
    o, lse, _ = forward_emulated(tq, tk, tv, causal, splits)
    got = backward_emulated(tq, tk, tv, o, lse, td, causal)
    _, vjp = jax.vjp(lambda a, b, c: jref.reference_attention(a, b, c, causal=causal),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for name, g, w in zip(("dq", "dk", "dv"), got, vjp(jnp.asarray(dout))):
        w = np.asarray(w)
        err = np.abs(g.numpy() - w).max()
        assert err <= BWD_TOL * np.abs(w).max(), (name, err)
    # And the port's plain gradient, the kernels' yardstick on the card.
    plain = ref.reference_attention_backward(tq, tk, tv, td, causal=causal)
    for g, w in zip(got, plain):
        assert (g - w).abs().max() <= BWD_TOL * w.abs().max()


# ------------------------------------------------------------- split rule

#: (B, S, Sk, H, Hk, dtype) of the attention calls the families make on the
#: card (phases 8, 13 and 21-33), with the key ranges of the forward there:
#: whisper's f32 cross-attention (48 row blocks) is the only one split.
FAMILY_SHAPES = {
    "whisper_encoder_f32": ((4, 1500, 1500, 12, 12), torch.float32, 1),
    "whisper_cross_f32": ((4, 64, 1500, 12, 12), torch.float32, 3),
    "whisper_decoder_self_bf16": ((4, 64, 64, 12, 12), torch.bfloat16, 1),
    "tinyllama_bf16": ((4, 512, 512, 32, 4), torch.bfloat16, 1),
    "tinyllama_train_f32": ((2, 512, 512, 32, 4), torch.float32, 1),
    "phi35_bf16": ((4, 512, 512, 32, 8), torch.bfloat16, 1),
    "llama4_bf16": ((4, 512, 512, 40, 8), torch.bfloat16, 1),
    "internvl2_bf16": ((4, 768, 768, 14, 2), torch.bfloat16, 1),
}


@pytest.mark.parametrize("name", list(FAMILY_SHAPES))
def test_forward_key_splits_at_the_family_shapes(name):
    shape, dtype, want = FAMILY_SHAPES[name]
    assert fa.forward_key_splits(dtype, *shape, H100_SMS) == want


def test_forward_key_splits_follow_the_dq_rule():
    """The forward reuses the backward's rule for f32 and never splits bf16."""
    for shape in [(1, 16, 200, 2, 1), (4, 64, 1500, 12, 12), (1, 64, 8192, 1, 1),
                  (2, 512, 512, 32, 4)]:
        for sms in (132, 16):
            assert (fa.forward_key_splits(torch.float32, *shape, sms)
                    == fa.dq_splits(*shape, sms))
            assert fa.forward_key_splits(torch.bfloat16, *shape, sms) == 1


# ------------------------------------------------- embedding lookup (C19)


def test_embedding_lookup_on_dtensors_in_four_ranks(tmp_path):
    """Ids split on 'data', the table's D on 'model': each rank holds (B/2,
    S, D/2) of the output, which equals the plain lookup and the JAX gather,
    and the table's gradient equals the plain one.  Split on the vocab, the
    table takes DTensor's rule and agrees as well."""
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=dr.run_embedding_rank, args=(r, str(tmp_path)))
             for r in range(4)]
    for p in procs:
        p.start()
    table, ids, weight = dr.embed_inputs()
    want = np.asarray(jmodules.embedding_lookup({"table": jnp.asarray(table)},
                                                jnp.asarray(ids)))
    t = torch.from_numpy(table).requires_grad_()
    plain = t.index_select(0, torch.from_numpy(ids).reshape(-1)).reshape(*ids.shape, -1)
    (plain * torch.from_numpy(weight)).sum().backward()
    for p in procs:
        p.join(dr.TIMEOUT.total_seconds())
    alive = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        p.terminate()
    assert not alive, f"ranks {alive} still running"
    np.testing.assert_allclose(plain.detach().numpy(), want, rtol=0, atol=0)
    B, S, D = want.shape
    for r in range(4):
        res = torch.load(tmp_path / f"embed-{r}.pt", weights_only=False)
        assert "error" not in res, res.get("error")
        data, model = divmod(r, 2)
        got = res["d_split"]
        assert got["placements"] == [("Shard", 0), ("Shard", 2)]
        assert tuple(got["local"].shape) == (B // 2, S, D // 2)
        np.testing.assert_array_equal(
            got["local"].numpy(),
            want[data * B // 2:(data + 1) * B // 2, :, model * D // 2:(model + 1) * D // 2])
        np.testing.assert_array_equal(got["full"].numpy(), want)
        torch.testing.assert_close(got["grad"], t.grad.chunk(2, 1)[model], atol=1e-6,
                                   rtol=1e-6)
        fallback = res["vocab_split"]
        np.testing.assert_array_equal(fallback["full"].numpy(), want)
        torch.testing.assert_close(fallback["grad"], t.grad.chunk(2, 0)[model], atol=1e-6,
                                   rtol=1e-6)
