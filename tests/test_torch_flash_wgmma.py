"""The bf16 flash attention on Hopper's wgmma, fed by TMA, on the CPU.

The bf16 bodies of ``csrc/flash_attention.cu`` and
``csrc/flash_attention_bwd.cu`` fold the G query heads of a KV head into
the rows of a tile, as the TPU kernel does, but TMA loads a tile as one box
of a 5-D view (hd, G, Hk, S, B) of q: P = 64 // G whole positions of all G
heads, P * G real rows of the 64 a warpgroup's product takes.  For G = 5 or
7 a tile holds 60 or 63 real rows; the rest are padding that no box fills
(the kernel zeroes them), that gets no weight and that the output box never
stores.  The forward's row tile holds two such tiles (one consumer
warpgroup each) and walks key tiles of 128 (64 at hd 128 and 160) up to
its causal limit, each
warpgroup stopping at its own, masking only the tiles that straddle a
limit; P is rounded to bf16 as the A operand of P V; a persistent grid of
at most one block an SM walks the row tiles, heaviest first
(``fwd_walks``).  The backward's dK/dV block holds 64
keys and streams the query rows of a group of heads, head after head, in
tiles of 64 (32 at hd 128 and 160) from the tile holding its first key;
its two consumer warpgroups (one at hd 128 and 160) take the streamed
tiles in turn, each summing its own, and the second's sums are added to
the first's; P^T and dS^T are
rounded to bf16 before dV += P^T dO and dK += dS^T q; each KV head's
group shares are summed in group order, or written as they are where one
group holds all G heads (``flash_attention.dkdv_head_groups``).  Its dQ
block is one padded folded tile walking key tiles of 64; dS is rounded to
bf16 before dQ += dS k.  The kernels run only on the card
(``tests/test_torch_cuda.py``,
``chip_smoke.py``); here a plain torch emulation of that tile plan, with
the plan's boxes and grids from ``flash_attention.wgmma_plan`` and its
tiles read from the kernel sources' tile structs, is held on
numpy-seeded bf16 inputs to the JAX package's
``repro.kernels.ref.reference_attention`` (atol = rtol = 2e-2, the bf16
gate of tests/test_kernels.py) and to ``jax.vjp`` of it (2e-2 of each
gradient's max |grad|, the backward kernels' bf16 gate on the card), over
G = 1, 4, 5, 7 and 8, every head dim, causal and not, ragged S and Sk (the
backward on a subset that holds each of them, on cards of 1, 3 and 132
SMs, so the dK/dV grid runs one group of all heads, several, and one head
a group).  The plan itself is held at every shape the families launch:
each position's row stored exactly once, each row tile walked once by the
persistent blocks, each (key tile, head) pair in exactly one head group,
no padding row stored, the grids as the C entries compute them.
"""

import importlib.util
import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as fa

LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
NEG = -1e30
TOL = 2e-2


def bf16(x):
    """x rounded to bf16 and widened back, as a bf16 operand is read."""
    return x.to(torch.bfloat16).float()


CSRC = Path(fa.__file__).resolve().parent / "csrc"


def tile_constant(source: str, struct: str, name: str, hd: int) -> int:
    """``struct<HD>::name`` at ``hd`` as the kernel source fixes it: a
    number, or ``HD <= a ? b : c``."""
    text = (CSRC / source).read_text()
    body = re.search(rf"struct {struct} {{(.*?)\n}};", text, re.S)
    assert body, f"{source} has no struct {struct}"
    expr = re.search(rf"static constexpr int {name} = ([^;]+);", body.group(1))
    assert expr, f"{struct} has no {name}"
    if m := re.fullmatch(r"HD <= (\d+) \? (\d+) : (\d+)", expr.group(1)):
        return int(m[2]) if hd <= int(m[1]) else int(m[3])
    return int(expr.group(1))


def fwd_keys(hd: int) -> int:
    """Keys of the bf16 forward's K/V tiles (``FwdTile::kKeys``)."""
    return tile_constant("flash_attention.cu", "FwdTile", "kKeys", hd)


#: Keys of the bf16 dQ kernel's K/V tiles (``DqTile::kKeys``, at every head dim).
DQ_KEYS = tile_constant("flash_attention_bwd.cu", "DqTile", "kKeys", 64)


# ---------------------------------------------------------------- forward


def folded_tile(x, b, kvh, p0, P, G):
    """A padded folded tile of x (B, S, H, hd): row r < P * G is position
    p0 + r // G, head kvh * G + r % G; positions past S and the padding
    rows are zeros (TMA's fill past the edge, the kernel's zeroing) ->
    (tile (64, hd), row positions (64,), heads (64,), real rows (64,))."""
    S, hd = x.shape[1], x.shape[3]
    r = torch.arange(fa.WGMMA_ROWS)
    pos, head = p0 + r // G, kvh * G + r % G
    real = (r < P * G) & (pos < S)
    tile = torch.zeros((fa.WGMMA_ROWS, hd))
    tile[real] = x[b, pos[real], head[real]].float()
    return tile, pos, head, real


def key_tile(x, b, kvh, k0, keys):
    """Keys k0 .. k0 + keys of x (B, Sk, Hk, hd), zero past Sk (TMA's fill)."""
    Sk, hd = x.shape[1], x.shape[3]
    tile = torch.zeros((keys, hd))
    n = max(0, min(keys, Sk - k0))
    tile[:n] = x[b, k0:k0 + n, kvh].float()
    return tile


def fwd_walks(plan: dict, causal: bool) -> list[list[tuple[int, int]]]:
    """The bf16 forward's row tiles, (row tile, b * Hk + kvh), in the order
    each of the plan's blocks walks them (``csrc/flash_attention.cu``'s
    ``fwd_item`` and ``fwd_walk``): item j is row tile ``j // (B * Hk)``
    counted from the last when causal (heaviest first), from the first when
    not, of pair ``j % (B * Hk)``; round k of block x's walk is item ``k *
    blocks + x`` for even k, ``k * blocks + blocks - 1 - x`` for odd k."""
    tiles, n_bh = plan["fwd_grid"]
    blocks = plan["fwd_blocks"]
    tile = (lambda t: tiles - 1 - t) if causal else (lambda t: t)
    walks = []
    for x in range(blocks):
        items = [k * blocks + (blocks - 1 - x if k % 2 else x)
                 for k in range(-(-tiles * n_bh // blocks))]
        walks.append([(tile(j // n_bh), j % n_bh) for j in items if j < tiles * n_bh])
    return walks


def forward_emulated(q, k, v, causal, sms=132):
    """The bf16 forward as the wgmma body forms it on a card of ``sms`` SMs
    -> (out f32 (B, S, H, hd), lse (B, H, S), the number of times each (b,
    s, h) row was stored)."""
    B, S, H, hd = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    G = H // Hk
    plan = fa.wgmma_plan(B, S, Sk, H, Hk, hd, causal=causal, sms=sms)
    P, keys = plan["positions"], fwd_keys(hd)
    assert plan["fwd_grid"][1] == B * Hk
    scale_log2 = LOG2E / math.sqrt(hd)
    out = torch.zeros((B, S, H, hd))
    lse = torch.zeros((B, H, S))
    stored = torch.zeros((B, S, H), dtype=torch.int64)
    for walk in fwd_walks(plan, causal):
        for tile, bh in walk:
            b, kvh = divmod(bh, Hk)
            cta_p0 = tile * fa.FWD_CONSUMERS * P
            n_tiles = math.ceil(Sk / keys)
            if causal:
                n_tiles = min(n_tiles, (min(cta_p0 + fa.FWD_CONSUMERS * P, S) - 1) // keys + 1)
            kt_all, vt_all = (key_tile(x, b, kvh, 0, n_tiles * keys) for x in (k, v))
            for w in range(fa.FWD_CONSUMERS):
                p0 = cta_p0 + w * P
                if p0 >= S:
                    continue
                qt, pos, head, real = folded_tile(q, b, kvh, p0, P, G)
                n_mine = n_tiles
                if causal:
                    n_mine = min(n_tiles, (min(p0 + P, S) - 1) // keys + 1)
                m = torch.full((fa.WGMMA_ROWS,), NEG)
                l = torch.zeros(fa.WGMMA_ROWS)
                o = torch.zeros((fa.WGMMA_ROWS, hd))
                for kt in range(n_mine):
                    k0 = kt * keys
                    s = qt @ kt_all[k0:k0 + keys].T * scale_log2
                    if (causal and k0 + keys - 1 > p0) or k0 + keys > Sk:
                        key = torch.arange(k0, k0 + keys)
                        if causal:
                            s = s.masked_fill(key[None, :] > pos[:, None], NEG)
                        s = s.masked_fill(key[None, :] >= Sk, -math.inf)
                    m_new = torch.maximum(m, s.amax(-1))
                    corr = torch.exp2(m - m_new)
                    p = torch.exp2(s - m_new[:, None])
                    l = l * corr + p.sum(-1)
                    o = o * corr[:, None] + bf16(p) @ vt_all[k0:k0 + keys]
                    m = m_new
                l = l.clamp_min(1e-30)
                out[b, pos[real], head[real]] = (o / l[:, None])[real]
                lse[b, head[real], pos[real]] = ((m + torch.log2(l)) * LN2)[real]
                stored[b, pos[real], head[real]] += 1
    return out, lse, stored


# --------------------------------------------------------------- backward


def backward_emulated(q, k, v, o, lse, dout, causal, sms=132):
    """The bf16 backward as the wgmma bodies form it on a card of ``sms``
    SMs: D from the bf16 output; the dK/dV blocks' head groups, their
    streamed tiles taken in turn by the consumer warpgroups and the second's
    sums added to the first's, the groups' shares summed per KV head in
    group order (or stored as they are from one group); the dQ blocks'
    padded folded tiles -> (dq, dk, dv) f32."""
    B, S, H, hd = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    G = H // Hk
    plan = fa.wgmma_plan(B, S, Sk, H, Hk, hd, causal=causal, sms=sms)
    P, rows = plan["positions"], fa.dkdv_rows(hd)
    scale = 1.0 / math.sqrt(hd)
    D = (dout.float() * o.float()).sum(-1).permute(0, 2, 1)  # (B, H, S)
    groups = fa.dkdv_head_groups(B, S, Sk, H, Hk, hd, causal, sms)
    per = plan["dkdv_heads"]
    assert plan["dkdv_grid"] == (math.ceil(Sk / fa.DKDV_KEYS), B * Hk, groups)
    assert per == math.ceil(G / groups) and (groups - 1) * per < G
    shares = torch.zeros((2, groups, B, Sk, Hk, hd))
    q_tiles = math.ceil(S / rows)
    for b in range(B):
        for kvh in range(Hk):
            for z in range(groups):
                heads = [kvh * G + z * per + i for i in range(per) if z * per + i < G]
                for blk in range(plan["dkdv_grid"][0]):
                    kw = blk * fa.DKDV_KEYS
                    kt, vt = key_tile(k, b, kvh, kw, 64), key_tile(v, b, kvh, kw, 64)
                    key = torch.arange(kw, kw + 64)
                    C = fa.dkdv_consumers(hd)
                    sums = torch.zeros((C, 2, 64, hd))  # each consumer warpgroup's
                    stream = [(h, t) for h in heads
                              for t in range(kw // rows if causal else 0, q_tiles)]
                    for i, (h, t) in enumerate(stream):
                        row0 = t * rows
                        n = min(rows, S - row0)
                        qt, dt = torch.zeros((rows, hd)), torch.zeros((rows, hd))
                        qt[:n] = q[b, row0:row0 + n, h].float()
                        dt[:n] = dout[b, row0:row0 + n, h].float()
                        lse_t, d_t = torch.zeros(rows), torch.zeros(rows)
                        lse_t[:n], d_t[:n] = lse[b, h, row0:row0 + n], D[b, h, row0:row0 + n]
                        pos = torch.arange(row0, row0 + rows)
                        live = (pos[None, :] < S) & (key[:, None] < Sk)
                        if causal:
                            live &= key[:, None] <= pos[None, :]
                        st = kt @ qt.T * (scale * LOG2E) - lse_t[None, :] * LOG2E
                        pt = torch.where(live, torch.exp2(st), 0.0)
                        dst = pt * (vt @ dt.T - d_t[None, :])
                        w = i % C
                        sums[w, 0] += bf16(dst) @ qt
                        sums[w, 1] += bf16(pt) @ dt
                    gk, gv = sums[0]
                    for w in range(1, C):
                        gk, gv = gk + sums[w, 0], gv + sums[w, 1]
                    n_keys = min(64, Sk - kw)
                    shares[0, z, b, kw:kw + n_keys, kvh] = gk[:n_keys]
                    shares[1, z, b, kw:kw + n_keys, kvh] = gv[:n_keys]
    dk, dv = shares[0, 0].clone(), shares[1, 0].clone()
    for z in range(1, groups):
        dk += shares[0, z]
        dv += shares[1, z]
    dk *= scale
    dq = torch.zeros((B, S, H, hd))
    assert plan["dq_grid"] == (math.ceil(S / P), B * Hk)
    for b in range(B):
        for kvh in range(Hk):
            for tile in range(plan["dq_grid"][0]):
                p0 = tile * P
                qt, pos, head, real = folded_tile(q, b, kvh, p0, P, G)
                dt = folded_tile(dout, b, kvh, p0, P, G)[0]
                lse_r = torch.zeros(fa.WGMMA_ROWS)
                d_r = torch.zeros(fa.WGMMA_ROWS)
                lse_r[real] = lse[b, head[real], pos[real]]
                d_r[real] = D[b, head[real], pos[real]]
                n_tiles = math.ceil(Sk / DQ_KEYS)
                if causal:
                    n_tiles = min(n_tiles, (min(p0 + P, S) - 1) // DQ_KEYS + 1)
                acc = torch.zeros((fa.WGMMA_ROWS, hd))
                for kt in range(n_tiles):
                    k0 = kt * DQ_KEYS
                    key = torch.arange(k0, k0 + DQ_KEYS)
                    kt_, vt = (key_tile(x, b, kvh, k0, DQ_KEYS) for x in (k, v))
                    live = real[:, None] & (key[None, :] < Sk)
                    if causal:
                        live &= key[None, :] <= pos[:, None]
                    s = qt @ kt_.T
                    s = s * (scale * LOG2E) - lse_r[:, None] * LOG2E
                    p = torch.where(live, torch.exp2(s), 0.0)
                    ds = p * (dt @ vt.T - d_r[:, None])
                    acc += bf16(ds) @ kt_
                dq[b, pos[real], head[real]] = acc[real] * scale
    return dq, dk, dv


# ------------------------------------------------------------------ cases

#: (B, S, Sk, Hk): ragged S and Sk, S != Sk both ways, two forward blocks or
#: more, and a second dK/dV key block.
SHAPES = [(1, 37, 150, 1), (1, 70, 29, 2)]
GROUPS = (1, 4, 5, 7, 8)
HEAD_DIMS = (32, 64, 128, 160)
#: (G, hd, causal) of the backward's cases: every G, every head dim and both
#: masks at least once (each case is a jax.vjp, so not the whole product).
BWD_CASES = [(1, 32, True), (1, 160, False), (4, 64, True), (4, 128, False),
             (5, 64, True), (5, 160, True), (5, 128, False), (7, 32, False),
             (7, 128, True), (8, 64, False), (8, 160, True), (8, 32, True)]
#: SMs of the cards the emulations plan for, a case's by (G + hd) % 3: one
#: SM (one dK/dV head group of all G heads, dk and dv stored as they are;
#: one persistent forward block walking every row tile), three (several
#: groups and blocks), an H100's 132 (one head a group at these sizes).
SMS = (1, 3, 132)


def _case_inputs(B, S, Sk, H, Hk, hd, seed):
    rng = np.random.default_rng(seed)
    q, dout = (rng.standard_normal((B, S, H, hd)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((B, Sk, Hk, hd)).astype(np.float32) for _ in range(2))
    # bf16 inputs, carried as the f32 values they hold (numpy has no bf16).
    return [bf16(torch.from_numpy(a)).numpy() for a in (q, k, v, dout)]


def _jax_attention(q, k, v, causal):
    return jref.reference_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    causal=causal)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("G", GROUPS)
def test_tile_plan_forward_matches_jax(G, hd, causal):
    """Every padded tile, key tile and mask as the body walks them, P in
    bf16, against the JAX reference; each (b, s, h) row stored once; the lse
    against the plain scores'."""
    B, S, Sk, Hk = SHAPES[(G + hd) % 2]
    H = G * Hk
    q, k, v, _ = _case_inputs(B, S, Sk, H, Hk, hd, seed=G * 1000 + hd)
    got, lse, stored = forward_emulated(*(torch.from_numpy(a) for a in (q, k, v)), causal,
                                        sms=SMS[(G + hd) % 3])
    assert (stored == 1).all()
    want = np.asarray(_jax_attention(q, k, v, causal))
    np.testing.assert_allclose(bf16(got).numpy(), want, atol=TOL, rtol=TOL)
    kk = np.repeat(k.astype(np.float64), G, axis=2)
    s = np.einsum("bshd,bkhd->bhsk", q.astype(np.float64), kk) / math.sqrt(hd)
    if causal:
        s = np.where(np.arange(Sk)[None, :] > np.arange(S)[:, None], NEG, s)
    top = s.max(-1, keepdims=True)
    lse_want = (top + np.log(np.exp(s - top).sum(-1, keepdims=True)))[..., 0]
    np.testing.assert_allclose(lse.numpy(), lse_want, atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("G, hd, causal", BWD_CASES,
                         ids=[f"{g}-{hd}-{'causal' if c else 'full'}" for g, hd, c in BWD_CASES])
def test_tile_plan_backward_matches_jax_vjp(G, hd, causal):
    """The dK/dV and dQ tile plans (the dK/dV head groups and consumer
    warpgroups in the kernel's summation order), P^T / dS^T / dS in bf16
    before the accumulating products and the forward's bf16 output in D,
    within 2e-2 of each gradient's max |grad| of ``jax.vjp`` of the JAX
    reference."""
    B, S, Sk, Hk = SHAPES[(G + hd + 1) % 2]
    H = G * Hk
    sms = SMS[(G + hd) % 3]
    q, k, v, dout = _case_inputs(B, S, Sk, H, Hk, hd, seed=G * 1000 + hd + 7)
    tq, tk, tv, td = (torch.from_numpy(a) for a in (q, k, v, dout))
    o, lse, _ = forward_emulated(tq, tk, tv, causal, sms=sms)
    got = backward_emulated(tq, tk, tv, bf16(o), lse, td, causal, sms=sms)
    _, vjp = jax.vjp(lambda a, b, c: jref.reference_attention(a, b, c, causal=causal),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for name, g, w in zip(("dq", "dk", "dv"), got, vjp(jnp.asarray(dout))):
        w = np.asarray(w)
        err = np.abs(bf16(g).numpy() - w).max()
        assert err <= TOL * np.abs(w).max(), (name, err, np.abs(w).max())


def test_padding_rows_carry_no_weight():
    """G = 7: the 64th row of a tile is padding.  Filled with huge values
    instead of the kernel's zeros, it changes no stored row: rows are
    independent in both products."""
    q, k, v, _ = _case_inputs(1, 20, 40, 7, 1, 64, seed=5)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    plan = fa.wgmma_plan(1, 20, 40, 7, 1, 64, causal=True, sms=132)
    assert plan["rows"] == 63 and plan["padding"] == 1
    qt, pos, head, real = folded_tile(tq, 0, 0, 0, plan["positions"], 7)
    s = qt @ key_tile(tk, 0, 0, 0, 128).T
    qt[~real] = 1e4
    s_pad = qt @ key_tile(tk, 0, 0, 0, 128).T
    assert torch.equal(s[real], s_pad[real])


# ------------------------------------------------------------------- plan

#: (B, S, Sk, H, Hk, hd) of every bf16 attention call the families make on
#: the card (chip_smoke.py's phases 2, 8, 12, 13 and 21-33) and the test
#: cases of ATTN_CASES with G = 1, 2, 4, 5, 7 and 8.
FAMILY_SHAPES = {
    "tinyllama_prefill": (4, 512, 512, 32, 4, 64),
    "tinyllama_train": (2, 512, 512, 32, 4, 64),
    "phi35": (4, 512, 512, 32, 8, 128),
    "phi35_train": (1, 512, 512, 32, 8, 128),
    "llama4": (4, 512, 512, 40, 8, 128),
    "llama4_train": (1, 512, 512, 40, 8, 128),
    "stablelm_train": (1, 512, 512, 32, 8, 160),
    "internvl2": (4, 768, 768, 14, 2, 64),
    "whisper_decoder_self": (4, 64, 64, 12, 12, 64),
    "large": (1, 8192, 8192, 32, 4, 64),
    "ragged_hd160": (2, 100, 37, 8, 2, 160),
    "mqa_hd32": (1, 128, 128, 4, 1, 32),
}


@pytest.mark.parametrize("name", list(FAMILY_SHAPES))
def test_plan_covers_every_row_once(name):
    """Each folded tile holds P * G <= 64 real rows, the padding the rest;
    the forward's and dQ's row tiles cover positions 0 .. S - 1 once each,
    no tile starts past S; the persistent forward blocks (at most one an
    SM) walk every row tile of every (batch, KV head) once, causal ones
    heaviest first; the dK/dV blocks cover the keys, and their head groups
    every head of each KV head once."""
    B, S, Sk, H, Hk, hd = FAMILY_SHAPES[name]
    G = H // Hk
    for causal in (True, False):
        plan = fa.wgmma_plan(B, S, Sk, H, Hk, hd, causal=causal, sms=132)
        P = plan["positions"]
        assert P == 64 // G and plan["rows"] == P * G <= 64
        assert plan["padding"] == 64 - P * G and plan["padding"] < G
        per_block = fa.FWD_CONSUMERS * P
        x, y = plan["fwd_grid"]
        assert y == B * Hk and (x - 1) * per_block < S <= x * per_block
        starts = [t * per_block + w * P for t in range(x) for w in range(fa.FWD_CONSUMERS)]
        covered = sorted(p for p0 in starts if p0 < S for p in range(p0, min(p0 + P, S)))
        assert covered == list(range(S))
        walks = fwd_walks(plan, causal)
        assert len(walks) == plan["fwd_blocks"] == min(x * y, 132)
        items = [item for walk in walks for item in walk]
        assert sorted(items) == [(t, bh) for t in range(x) for bh in range(y)]
        for walk in walks:  # causal: each block's tiles heaviest (latest) first
            tiles = [t for t, _ in walk]
            assert tiles == sorted(tiles, reverse=causal)
        x, y = plan["dq_grid"]
        assert y == B * Hk and (x - 1) * P < S <= x * P
        x, y, groups = plan["dkdv_grid"]
        assert y == B * Hk and (x - 1) * fa.DKDV_KEYS < Sk <= x * fa.DKDV_KEYS
        per = plan["dkdv_heads"]
        heads = sorted(z * per + i for z in range(groups) for i in range(per) if z * per + i < G)
        assert heads == list(range(G)) and (groups - 1) * per < G


@pytest.mark.parametrize("name", list(FAMILY_SHAPES))
def test_dkdv_head_groups_keep_the_grid_balanced(name):
    """The dK/dV head groups at an H100's 132 SMs: the heaviest block's
    streamed tiles a warpgroup are within the grid's average per
    warpgroup slot (or the groups are one head each).  Causal training shapes: tinyllama's (G =
    8, hd 64) and internvl2's (G = 7) run groups of two heads, the hd 128
    and 160 ones one head a group, as the rule's arithmetic gives."""
    B, S, Sk, H, Hk, hd = FAMILY_SHAPES[name]
    G = H // Hk
    rows, C = fa.dkdv_rows(hd), fa.dkdv_consumers(hd)
    walks = [max(0, -(-S // rows) - x * fa.DKDV_KEYS // rows) for x in range(-(-Sk // 64))]
    mean = G * B * Hk * sum(walks) / (132 * C)
    groups = fa.dkdv_head_groups(B, S, Sk, H, Hk, hd, True, 132)
    per = -(-G // groups)
    assert per == 1 or -(-per * walks[0] // C) <= mean
    want = {"tinyllama_train": 4, "internvl2": 4, "phi35_train": 4, "llama4_train": 5,
            "stablelm_train": 4}
    if name in want:
        assert groups == want[name]


@pytest.mark.parametrize("name", list(FAMILY_SHAPES))
def test_backward_dq_splits_on_the_plan(name):
    """The bf16 dQ grid's key ranges follow ``dq_splits`` on its own row
    tiles (ceil(S / P)), f32's on 64-row tiles; every family shape fills an
    H100 whole; the kernels a call follow the head groups and the ranges."""
    B, S, Sk, H, Hk, hd = FAMILY_SHAPES[name]
    plan = fa.wgmma_plan(B, S, Sk, H, Hk, hd, causal=True, sms=132)
    tiles = plan["dq_grid"][0]
    assert (fa.backward_dq_splits(torch.bfloat16, B, S, Sk, H, Hk, hd, 132)
            == fa.dq_splits(B, S, Sk, H, Hk, 132, row_tiles=tiles))
    assert (fa.backward_dq_splits(torch.float32, B, S, Sk, H, Hk, hd, 132)
            == fa.dq_splits(B, S, Sk, H, Hk, 132))
    assert fa.backward_dq_splits(torch.bfloat16, B, S, Sk, H, Hk, hd, 132) == 1
    groups = plan["dkdv_grid"][2]
    assert fa.backward_head_groups(torch.bfloat16, B, S, Sk, H, Hk, hd, True, 132) == groups
    assert fa.backward_head_groups(torch.float32, B, S, Sk, H, Hk, hd, True, 132) == H // Hk
    assert fa.bwd_kernels(torch.bfloat16, groups, 1, hd) == (3 if groups == 1 else 4)
    assert fa.bwd_kernels(torch.bfloat16, 1, 2, hd) == 4
    assert fa.bwd_kernels(torch.float32, 1, 1, 128) == 4
    # The f32 wgmma body (hd 32, 64) writes dk and dv itself at one head group too.
    assert fa.bwd_kernels(torch.float32, 1, 1, 64) == 3
    assert fa.bwd_kernels(torch.float32, 2, 1, 64) == fa.bwd_kernels(torch.float32, 1, 3, 32) == 4


def test_tiles_by_head_dim():
    """The tiles that keep each bf16 body within its registers and shared
    memory, at hd 32, 64, 128 and 160, read from the kernel sources; the
    wrapper's plan holds the same consumers and keys as the C structs."""
    assert [fwd_keys(hd) for hd in fa.HEAD_DIMS] == [128, 128, 64, 64]
    assert [fa.dkdv_rows(hd) for hd in fa.HEAD_DIMS] == [64, 64, 32, 32]
    assert DQ_KEYS == 64
    for hd in fa.HEAD_DIMS:
        assert tile_constant("flash_attention.cu", "FwdTile", "kConsumers", hd) == fa.FWD_CONSUMERS
        assert tile_constant("flash_attention_bwd.cu", "DkdvTile", "kKeys", hd) == fa.DKDV_KEYS
        assert tile_constant("flash_attention_bwd.cu", "DkdvTile", "kRows", hd) == fa.dkdv_rows(hd)
        assert (tile_constant("flash_attention_bwd.cu", "DkdvTile", "kConsumers", hd)
                == fa.dkdv_consumers(hd))
        assert tile_constant("flash_attention_bwd.cu", "DqTile", "kKeys", hd) == DQ_KEYS


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_asks_hgmma_of_the_wgmma_bodies():
    """The smoke run's SASS check: HMMA and HGMMA both count as tensor-core
    instructions, and the ``wgmma`` bodies (``*_wgmma_kernel``: bf16, and f32
    at hd 32 and 64) are held to HGMMA alone, so an ``mma.sync`` body under
    that name would fail it."""
    cs = _chip_smoke()
    sass = """
        Function : _ZN12_GLOBAL__N_127flash_fwd_bf16_wgmma_kernelILi64ELb1EEEv14CUtensorMap_st
        /*0100*/   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT ;
        /*0110*/   UTMALDG.4D [UR8], [UR10] ;
        Function : _ZN12_GLOBAL__N_125flash_bwd_dq_wgmma_kernelILi64ELb0EEEv14CUtensorMap_st
        /*0100*/   HMMA.16816.F32.BF16 R4, R12, R20, R4 ;
        Function : _ZN12_GLOBAL__N_129flash_fwd_tf32x3_wgmma_kernelILi64ELb0EEEv14CUtensorMap_st
        /*0100*/   HGMMA.64x64x8.F32.TF32 R24, R56, gdesc[UR4], R24 ;
        Function : _ZN12_GLOBAL__N_127flash_fwd_tf32x3_mma_kernelILi128ELb0EEEvPKfS2_S2_Pf
        /*0100*/   HMMA.1688.F32.TF32 R4, R12, R20, R4 ;
    """
    both = cs.sass_tensor_core_counts(sass)
    hgmma = cs.sass_tensor_core_counts(sass, r"\bHGMMA\.")
    assert list(both.values()) == [1, 1, 1, 1] and list(hgmma.values()) == [1, 0, 1, 0]
    wgmma = {fn: n for fn, n in hgmma.items() if cs.WGMMA_MARK in fn}
    # The f32 wgmma body is held to HGMMA too; the hd 128 mma.sync one is not.
    assert len(wgmma) == 3 and not all(wgmma.values())
    assert [n for fn, n in wgmma.items() if "tf32x3" in fn] == [1]
    assert set(cs.WGMMA_LIBS) == {"flash_attention", "flash_attention_bwd"}
