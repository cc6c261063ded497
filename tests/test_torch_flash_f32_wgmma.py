"""The f32 flash-attention bodies on wgmma in 3xTF32 (hd 32 and 64), on the CPU.

The kernels (``csrc/flash_attention.cu``'s ``flash_fwd_tf32x3_wgmma_kernel``,
``csrc/flash_attention_bwd.cu``'s ``flash_bwd_{dkdv,dq}_tf32x3_wgmma_kernel``)
run only on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).  Here
the layouts they rest on are held as plain Python, as the PTX ISA gives them:

* the m64nNk8 TF32 accumulator and register A fragment of a warpgroup, and
  the key order ``sigma8`` of the transposed copies the split pass writes:
  every lane's score accumulator, passed as its A fragment with no shuffle,
  contracts with the copy exactly (the product equals S @ V);
* the 128- and 64-byte swizzles of ``hopper::f32_at`` (one slot per element,
  TMA's pattern), ``transpose32``'s blocks (each copy element once, its
  quarter warps' 16-byte reads and writes on eight distinct bank groups),
  and the forward's V quarters landing where V^T's small part goes;
* the shared-memory plan of the three bodies (``tf32_wgmma_tiles``) against
  the 232,448 bytes of a block, and the tile constants of the C structs;
* the forward's shared-rows mode (whisper's 64 decoder positions: two
  warpgroups on the same rows take the key tiles in turn and merge their
  running max, sum and output), emulated in the log2 domain with 3xTF32
  products, against the JAX package's reference at the f32 tolerance
  (2e-5, tests/test_kernels.py:43).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as fa

CSRC = Path(fa.__file__).resolve().parent / "csrc"
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453


# ------------------------------------------------------------ PTX layouts


def acc_entry(t: int, i: int) -> tuple:
    """(row, column) of accumulator register i of thread t of a warpgroup
    (m64nN, f32): warp w = t // 32, lane = 4 g + c; d[4 j + e] is row 16 w +
    g + 8 (e >> 1), column 8 j + 2 c + (e & 1)."""
    w, lane = divmod(t, 32)
    g, c = divmod(lane, 4)
    j, e = divmod(i, 4)
    return 16 * w + g + 8 * (e >> 1), 8 * j + 2 * c + (e & 1)


def a_frag_entry(t: int, kk: int, i: int) -> tuple:
    """(row, column) of register A fragment i of thread t at k-step kk
    (m64nNk8 TF32): a[0] row g, column c; a[1] row g + 8; a[2] row g,
    column c + 4; a[3] row g + 8, column c + 4 (of the k-step's 8)."""
    w, lane = divmod(t, 32)
    g, c = divmod(lane, 4)
    return 16 * w + g + 8 * (i & 1), 8 * kk + c + 4 * (i >> 1)


def sigma8(m: int) -> int:
    """flash_tf32x3.cuh's sigma8: the row a transposed copy's column m of
    each 8 holds."""
    return 2 * m if m < 4 else 2 * m - 7


#: acc_frag_tf32: the accumulator registers passed as a[0..3] of k-step kk.
ACC_AS_A = (0, 2, 1, 3)


def test_sigma8_is_the_inverse_of_the_mma_sync_key_order():
    assert sorted(sigma8(m) for m in range(8)) == list(range(8))
    perm8 = [(n >> 1) + ((n & 1) << 2) for n in range(8)]  # flash_tf32x3.cuh's perm8
    assert [perm8[sigma8(m)] for m in range(8)] == list(range(8))


@pytest.mark.parametrize("n_keys", [32, 64])
def test_each_lanes_accumulator_is_its_own_a_fragment(n_keys):
    """Register 4 kk + ACC_AS_A[i] of every thread holds the score of the
    same row as its a[i], at the key that the sigma8 copy's row of that
    A column holds: the product over the copy is exact, lane by lane."""
    for t in range(128):
        for kk in range(n_keys // 8):
            for i in range(4):
                row_s, key = acc_entry(t, 4 * kk + ACC_AS_A[i])
                row_a, col = a_frag_entry(t, kk, i)
                assert row_s == row_a
                assert key == 8 * kk + sigma8(col - 8 * kk)


@pytest.mark.parametrize("n_keys,hd", [(64, 64), (64, 32), (32, 64)])
def test_accumulator_as_a_times_the_copy_is_s_times_v(n_keys, hd):
    rng = np.random.default_rng(0)
    s = rng.standard_normal((64, n_keys))
    v = rng.standard_normal((n_keys, hd))
    copy = v[[8 * (k // 8) + sigma8(k % 8) for k in range(n_keys)]]  # B rows = the copy's columns
    a = np.zeros((64, n_keys))
    for t in range(128):
        for kk in range(n_keys // 8):
            for i in range(4):
                row, key = acc_entry(t, 4 * kk + ACC_AS_A[i])
                a[a_frag_entry(t, kk, i)] = s[row, key]
    np.testing.assert_allclose(a @ copy, s @ v, rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------- shared memory


def f32_at(swz: int, rows: int, r: int, c: int) -> int:
    """hopper::f32_at<swz>: byte offset of (r, c) in an f32 tile of `rows`."""
    cols = swz // 4
    off = (c // cols) * rows * swz + r * swz + (c % cols) * 4
    mask = 7 if swz == 128 else 3
    return off ^ (((off >> 7) & mask) << 4)


@pytest.mark.parametrize("swz,rows,cols", [(128, 64, 64), (128, 32, 64), (128, 16, 32),
                                           (128, 64, 32), (64, 64, 64), (64, 32, 64)])
def test_f32_swizzle_is_one_slot_per_element_and_tmas_pattern(swz, rows, cols):
    offs = {f32_at(swz, rows, r, c) for r in range(rows) for c in range(cols)}
    assert offs == set(range(0, 4 * rows * cols, 4))
    # TMA's pattern: the 16-byte chunk XOR the row within the swizzle's period.
    period = 8 if swz == 128 else 4
    for r in range(rows):
        for c in range(0, cols, 4):
            base = (c // (swz // 4)) * rows * swz + r * swz
            chunk = ((c % (swz // 4)) // 4) ^ ((r if swz == 128 else r >> 1) % period)
            assert f32_at(swz, rows, r, c) == base + 16 * chunk


def transpose32_blocks(hd: int):
    """flash_tf32x3.cuh's transpose32: block blk -> (b4, d0), dst columns
    4 b4 .. + 3 and rows d0 .. d0 + 3."""
    for blk in range(8 * (hd // 4)):
        u, b4 = blk >> 3, blk & 7
        d0 = 4 * ((((b4 >> 1) + 4 * (b4 & 1)) ^ (u & 7)) + 8 * (u >> 3))
        yield blk, b4, d0


@pytest.mark.parametrize("hd", fa.TF32_WGMMA_HEAD_DIMS)
def test_transpose32_moves_each_element_once_into_the_sigma8_copy(hd):
    seen = {}
    for _, b4, d0 in transpose32_blocks(hd):
        for i in range(4):
            src_row = 8 * (b4 >> 1) + 2 * i + (b4 & 1)
            for jj in range(4):
                dst = (d0 + jj, 4 * b4 + i)  # (dst row = column of src, dst column)
                assert dst not in seen
                seen[dst] = (src_row, d0 + jj)
    assert len(seen) == 32 * hd
    for (d, col), (src_row, src_col) in seen.items():
        assert src_col == d and src_row == 8 * (col // 8) + sigma8(col % 8)


@pytest.mark.parametrize("hd", fa.TF32_WGMMA_HEAD_DIMS)
def test_transpose32_quarter_warps_hit_distinct_bank_groups(hd):
    """A 16-byte shared access is served eight threads at a time: each
    quarter warp's reads (per row i) and writes (per row jj) land on eight
    distinct 16-byte groups of the 128-byte bank line."""
    blocks = list(transpose32_blocks(hd))
    for q in range(0, len(blocks), 8):
        quarter = blocks[q:q + 8]
        for i in range(4):
            groups = {(f32_at(128, 32, 8 * (b4 >> 1) + 2 * i + (b4 & 1), d0) % 128) // 16
                      for _, b4, d0 in quarter}
            assert len(groups) == 8, (q, i)
        for jj in range(4):
            groups = {(f32_at(128, hd, d0 + jj, 4 * b4) % 128) // 16 for _, b4, d0 in quarter}
            assert len(groups) == 8, (q, jj)


@pytest.mark.parametrize("hd", fa.TF32_WGMMA_HEAD_DIMS)
def test_forward_v_quarters_land_on_their_own_vt_atom(hd):
    """TMA lands V's quarter qq (16 keys, boxes of 16 rows x 32 columns under
    the 128-byte swizzle) at qq * hd * 64 of V^T's small part: the very bytes
    of V^T's atom qq (64-byte swizzle), which the quarter's split writes only
    after every thread has read it."""
    for qq in range(4):
        raw = {qq * hd * 64 + f32_at(128, 16, k, d) for k in range(16) for d in range(hd)}
        atom = {f32_at(64, hd, d, 16 * qq + m) for d in range(hd) for m in range(16)}
        assert raw == atom


# ------------------------------------------------------------------- plan


def struct_constant(source: str, struct: str, name: str) -> int:
    text = (CSRC / source).read_text()
    body = re.search(rf"struct {struct} {{(.*?)\n}};", text, re.S)
    assert body, f"{source} has no struct {struct}"
    m = re.search(rf"static constexpr int {name} = (\d+);", body.group(1))
    assert m, f"{struct} has no numeric {name}"
    return int(m.group(1))


@pytest.mark.parametrize("hd", fa.TF32_WGMMA_HEAD_DIMS)
def test_plan_fits_a_block_with_a_ring(hd):
    plan = fa.tf32_wgmma_tiles(hd)
    for kernel, p in plan.items():
        assert p["bytes"] <= fa.SMEM_BYTES, (kernel, p)
        assert p["stages"] >= 2 and p["stages"] >= p["consumers"], (kernel, p)
    assert plan["fwd"]["stages"] == (3 if hd == 64 else 4)
    assert plan["dkdv"]["stages"] == (2 if hd == 64 else 4)
    assert plan["dq"]["stages"] == (3 if hd == 64 else 4)


def test_plan_constants_are_the_c_structs():
    for hd in fa.TF32_WGMMA_HEAD_DIMS:
        plan = fa.tf32_wgmma_tiles(hd)
        assert plan["fwd"]["keys"] == struct_constant("flash_attention.cu", "Tf32FwdTile", "kKeys")
        assert plan["dq"]["keys"] == struct_constant("flash_attention_bwd.cu", "Tf32DqTile",
                                                     "kKeys")
        assert plan["dkdv"]["keys"] == struct_constant("flash_attention_bwd.cu", "Tf32DkdvTile",
                                                       "kRows")
        for kernel, src, struct in (("fwd", "flash_attention.cu", "Tf32FwdTile"),
                                    ("dq", "flash_attention_bwd.cu", "Tf32DqTile"),
                                    ("dkdv", "flash_attention_bwd.cu", "Tf32DkdvTile")):
            assert struct_constant(src, struct, "kConsumers") == plan[kernel]["consumers"]
            assert struct_constant(src, struct, "kMaxStages") == 4
    with pytest.raises(ValueError):
        fa.tf32_wgmma_tiles(128)


def test_f32_plan_grids_and_bodies():
    assert fa.tf32_plan(4, 1500, 1500, 12, 12, 64) == {
        "fwd_grid": (12, 48), "dq_grid": (12, 48), "dkdv_grid": (24, 48, 1)}
    assert fa.tf32_plan(4, 64, 1500, 12, 12, 64)["fwd_grid"] == (1, 48)
    assert fa.tf32_plan(2, 512, 512, 32, 4, 64)["dq_grid"] == (32, 8)
    assert fa.tf32_plan(2, 100, 137, 4, 2, 128)["fwd_grid"] == (4, 4)  # 64 rows on mma.sync
    import torch

    assert [fa.backward_body(torch.float32, hd) for hd in fa.HEAD_DIMS] == [
        "tf32x3_wgmma", "tf32x3_wgmma", "tf32x3_wide_mma", "tf32x3_wide_mma"]


# ------------------------------------------------- shared-rows forward


def tf32(x):
    """The split's big part: the f32 bits plus 0x1000, the low 13 cleared."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def mm3(a, b):
    """3xTF32: small x big + big x small + big x big, each part read as TF32."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    ab, bb = tf32(a), tf32(b)
    small = lambda x, big: tf32(x - big)  # the tensor core drops the low 13 bits
    return (small(a, ab).astype(np.float64) @ bb + ab.astype(np.float64) @ small(b, bb)
            + ab.astype(np.float64) @ bb).astype(np.float32)


def shared_rows_forward(q, k, v, causal):
    """One (batch, head) of 64 or fewer rows, as the kernel's share mode
    runs it: warpgroup w takes 64-key tiles j % 2 == w with its own online
    softmax (log2 domain, the scale folded, -1e30 masks), then the first
    merges the second's max, sum and output; out and lse."""
    S, hd = q.shape
    Sk = k.shape[0]
    scale_log2 = LOG2E / np.sqrt(hd)
    pos = np.arange(S)
    state = []
    for w in range(2):
        m = np.full(S, -1e30, np.float32)
        l = np.zeros(S, np.float32)
        o = np.zeros((S, hd), np.float32)
        for j in range(w, -(-Sk // 64), 2):
            keys = np.arange(64 * j, min(64 * j + 64, Sk))
            s = mm3(q, k[keys].T)
            if causal:
                s = np.where(keys[None, :] > pos[:, None], np.float32(-1e30 / scale_log2), s)
            m_new = np.maximum(m, s.max(1) * scale_log2)
            p = np.exp2(s * scale_log2 - m_new[:, None]).astype(np.float32)
            corr = np.exp2(m - m_new)
            l = l * corr + p.sum(1)
            o = o * corr[:, None] + mm3(p, v[keys])
            m = m_new
        state.append((m, l, o))
    (m0, l0, o0), (m1, l1, o1) = state
    mx = np.maximum(m0, m1)
    a0, a1 = np.exp2(m0 - mx), np.exp2(m1 - mx)
    l = l0 * a0 + l1 * a1
    o = o0 * a0[:, None] + o1 * a1[:, None]
    out = o / np.maximum(l, 1e-30)[:, None]
    return out, (mx + np.log2(np.maximum(l, 1e-30))) * LN2


@pytest.mark.parametrize("case", [(64, 300, 64, False), (16, 200, 64, True),
                                  (64, 150, 32, False), (40, 40, 32, True)])
def test_shared_rows_forward_matches_jax(case):
    S, Sk, hd, causal = case
    rng = np.random.default_rng(S + Sk + hd)
    q = rng.standard_normal((1, S, 1, hd)).astype(np.float32)
    k = rng.standard_normal((1, Sk, 1, hd)).astype(np.float32)
    v = rng.standard_normal((1, Sk, 1, hd)).astype(np.float32)
    out, lse = shared_rows_forward(q[0, :, 0], k[0, :, 0], v[0, :, 0], causal)
    want = np.asarray(jref.reference_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                               causal=causal))[0, :, 0]
    np.testing.assert_allclose(out, want, atol=2e-5, rtol=2e-5)
    s = (q[0, :, 0].astype(np.float64) @ k[0, :, 0].T.astype(np.float64)) / np.sqrt(hd)
    if causal:
        s = np.where(np.arange(Sk)[None, :] > np.arange(S)[:, None], -1e30, s)
    want_lse = np.log(np.exp(s - s.max(1, keepdims=True)).sum(1)) + s.max(1)
    np.testing.assert_allclose(lse, want_lse, atol=1e-5, rtol=1e-5)
