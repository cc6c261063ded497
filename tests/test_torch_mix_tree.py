"""The gossip mix as one launch per parameter tree, on the CPU.

The CUDA kernel runs only on a card (tests/test_torch_cuda.py holds it bit
for bit against the plain version there).  Here:

* ``ops.gossip_mix_tree`` on the CPU (the plain version leaf by leaf, u
  absent) against the JAX package's ``gossip_mix_tree`` on the same
  numpy-seeded inputs: bit for bit against its reference path; against its
  Pallas kernel in interpret mode within the tolerances of
  tests/test_kernels.py (1e-6 f32, 2e-2 bf16), because XLA's CPU
  interpreter contracts (1-w)*h + w*p into one fused multiply-add, which
  rounds once where the plain version and the CUDA kernel round twice;
* the plain u-less form against the form with a ``zeros_like`` u, bit for
  bit, -0.0 included;
* the wrapper's launch layout (``plan``, ``table_words``) and its checks,
  as plain Python with no launch.
"""

import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import gossip_mix as tk
from repro_torch.kernels import ops, ref

MLP_DIMS = [32, 128, 64, 10]
R = 32
CSRC = Path(tk.__file__).resolve().parent / "csrc" / "gossip_mix.cu"


def _mlp_tree(rng):
    """The simulator MLP's leaves stacked over R rows, as numpy f32."""
    shapes = []
    for a, b in zip(MLP_DIMS[:-1], MLP_DIMS[1:]):
        shapes += [(R, a, b), (R, b)]
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _layers(leaves):
    return [{"w": leaves[i], "b": leaves[i + 1]} for i in range(0, len(leaves), 2)]


def _bits(a):
    a = a.float() if isinstance(a, torch.Tensor) else a
    return np.asarray(a, np.float32).view(np.uint32)


def _pair(seed, dtypes=("float32",) * 6):
    """(h, p, w) for both packages: x = -0.0 with p < 0 in row 0 (w = 0),
    where only x + 0.0 gives +0.0."""
    rng = np.random.default_rng(seed)
    h = _mlp_tree(rng)
    p = _mlp_tree(rng)
    for a, b in zip(h, p):
        a.reshape(R, -1)[0, :2] = -0.0
        b.reshape(R, -1)[0, :2] = -1.0
    w = np.linspace(0.0, 1.0, R).astype(np.float32)
    jt = lambda t: _layers([jnp.asarray(a).astype(d) for a, d in zip(t, dtypes)])  # noqa: E731
    tt = lambda t: _layers([torch.from_numpy(a).to(getattr(torch, d))  # noqa: E731
                            for a, d in zip(t, dtypes)])
    return (jt(h), jt(p), jnp.asarray(w)), (tt(h), tt(p), torch.from_numpy(w))


TREE_DTYPES = {
    "f32": ("float32",) * 6,
    "bf16_leaf": ("float32", "bfloat16", "float32", "float32", "float32", "float32"),
}


@pytest.mark.parametrize("dtypes", list(TREE_DTYPES), ids=list(TREE_DTYPES))
def test_gossip_mix_tree_equals_jax_reference_bitwise(dtypes):
    (jh, jp, jw), (th, tp, tw) = _pair(0, TREE_DTYPES[dtypes])
    want = jops.gossip_mix_tree(jh, jp, jw, use_pallas=False)
    got = ops.gossip_mix_tree(th, tp, tw)
    for gl, wl in zip(got, want):
        assert sorted(gl) == sorted(wl)
        for k in gl:
            assert gl[k].dtype == getattr(torch, str(wl[k].dtype))
            np.testing.assert_array_equal(_bits(gl[k]), _bits(wl[k].astype(jnp.float32)))


@pytest.mark.parametrize("dtypes", list(TREE_DTYPES), ids=list(TREE_DTYPES))
def test_gossip_mix_tree_matches_jax_interpret(dtypes):
    (jh, jp, jw), (th, tp, tw) = _pair(1, TREE_DTYPES[dtypes])
    want = jops.gossip_mix_tree(jh, jp, jw, use_pallas="interpret")
    got = ops.gossip_mix_tree(th, tp, tw)
    for gl, wl in zip(got, want):
        for k in gl:
            tol = 2e-2 if gl[k].dtype == torch.bfloat16 else 1e-6
            np.testing.assert_allclose(gl[k].float().numpy(),
                                       np.asarray(wl[k].astype(jnp.float32)),
                                       atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_plain_u_less_equals_zeros_u_bitwise(dtype):
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((5, 37)).astype(np.float32)).to(dtype)
    p = torch.from_numpy(rng.standard_normal((5, 37)).astype(np.float32)).to(dtype)
    x[:, :3] = -0.0
    p[:, :3] = -1.0
    w = torch.tensor([0.0, 0.25, 0.5, 0.9, 1.0])
    got = ref.reference_gossip_mix_rows(x, None, p, w)
    want = ref.reference_gossip_mix_rows(x, torch.zeros_like(x), p, w)
    assert got.dtype == dtype
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert not torch.signbit(got[0, :3]).any()  # w = 0: x + 0.0 is +0.0


def _nested(seed, M=2):
    """ROADMAP C1's tree: nested dicts with a list, as (JAX, torch) pairs
    of (x_half, pulled) and the weights."""
    rng = np.random.default_rng(seed)

    def tree():
        return {"embed": rng.standard_normal((M, 5, 4)).astype(np.float32),
                "blocks": {"wq": rng.standard_normal((M, 3, 4, 4)).astype(np.float32),
                           "norms": [rng.standard_normal((M, 4)).astype(np.float32)]}}

    h, p = tree(), tree()
    w = np.array([0.3, 0.7][:M], np.float32)
    conv = lambda t, f: {"embed": f(t["embed"]),  # noqa: E731
                         "blocks": {"wq": f(t["blocks"]["wq"]),
                                    "norms": [f(t["blocks"]["norms"][0])]}}
    return ((conv(h, jnp.asarray), conv(p, jnp.asarray), jnp.asarray(w)),
            (conv(h, torch.from_numpy), conv(p, torch.from_numpy), torch.from_numpy(w)))


def test_gossip_mix_tree_nested_tree_equals_jax():
    """ROADMAP C1: a nested tree (dicts, a list) comes back in the same
    structure, bit-equal to the JAX package's reference path."""
    from repro_torch.tree import tree_leaves

    (jh, jp, jw), (th, tp, tw) = _nested(4)
    want = jops.gossip_mix_tree(jh, jp, jw, use_pallas=False)
    got = ops.gossip_mix_tree(th, tp, tw)
    assert sorted(got) == ["blocks", "embed"] and sorted(got["blocks"]) == ["norms", "wq"]
    assert isinstance(got["blocks"]["norms"], list)
    leaves = tree_leaves(got)
    assert len(leaves) == 3
    for a, b in zip(leaves, jax.tree_util.tree_leaves(want)):
        assert tuple(a.shape) == b.shape
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_gossip_mix_tree_of_nothing_is_nothing(monkeypatch):
    """ROADMAP C1: ``[]`` (and trees with no leaves) give the same empty
    structure back, as in the JAX package, with no launch."""
    monkeypatch.setattr(tk, "gossip_mix_rows_tree",
                        lambda *a, **k: pytest.fail("an empty tree launched"))
    w = torch.tensor([0.5, 0.5])
    assert ops.gossip_mix_tree([], [], w) == []
    assert jops.gossip_mix_tree([], [], jnp.asarray([0.5, 0.5])) == []
    assert ops.gossip_mix_tree({"a": [], "b": None}, {"a": [], "b": None}, w) == {
        "a": [], "b": None}


def test_tree_leaves_in_jax_order():
    """Leaves come out in jax.tree_util's order (dict keys sorted: b before
    w in each MLP layer) and unflatten back to the same tree."""
    from repro_torch.tree import tree_flatten, tree_map, tree_unflatten

    tree = [{"w": 1, "b": 2}, {"w": 3, "b": 4, "a": (5, None, [6])}]
    leaves, treedef = tree_flatten(tree)
    assert leaves == jax.tree_util.tree_leaves(tree) == [2, 1, 5, 6, 4, 3]
    assert tree_unflatten(treedef, leaves) == tree
    assert tree_map(lambda a, b: a + b, tree, tree) == jax.tree_util.tree_map(
        lambda a, b: a + b, tree, tree)
    with pytest.raises(ValueError, match="structures differ"):
        tree_map(lambda a, b: a, tree, tree[:1])


def test_cpu_tree_mix_makes_no_zeros(monkeypatch):
    (_, _, _), (th, tp, tw) = _pair(3)

    def refuse(*args, **kwargs):
        raise AssertionError("the tree mix made a zeros_like u")

    monkeypatch.setattr(torch, "zeros_like", refuse)
    ops.gossip_mix_tree(th, tp, tw)


# --- the launch layout, as plain Python ---------------------------------

F32, BF16, F16 = torch.float32, torch.bfloat16, torch.float16
MLP_SIZES = (R * 32 * 128, R * 128, R * 128 * 64, R * 64, R * 64 * 10, R * 10)


def test_plan_lays_out_the_cohort_tree_in_one_launch():
    assert (tk.THREADS, tk.BLOCKS_PER_SM, tk.UNROLLS) == (128, 4, (4, 2, 1))
    (g,) = tk.plan((F32,) * 6, MLP_SIZES, 132)
    assert g.leaves == tuple(range(6)) and g.dtype == F32
    # 4 vectors a thread give 205 blocks and 2 give 411, under 4 x 132.
    assert g.unroll == 1 and g.chunk == 512
    counts = [-(-s // 512) for s in MLP_SIZES]
    assert counts == [256, 8, 512, 4, 40, 1]
    assert g.first_block == (0, 256, 264, 776, 780, 820)
    assert g.blocks == 821 >= 4 * 132


@pytest.mark.parametrize("size,sm_count,unroll", [
    (8 * 2 ** 24, 132, 4),  # large: 65536 blocks of 2048
    (528 * 2048, 132, 4),  # exactly 4 blocks an SM at 4
    (527 * 2048, 132, 2),
    (528 * 512, 132, 1),
    (527 * 512, 132, 1),  # not even 1 reaches 528: the smallest
    (10, 132, 1),
    (4096, 1, 2),  # one SM: 4 blocks of 1024
])
def test_plan_takes_the_largest_unroll_with_four_blocks_an_sm(size, sm_count, unroll):
    (g,) = tk.plan((F32,), (size,), sm_count)
    assert g.unroll == unroll
    assert g.blocks == -(-size // g.chunk)


def test_plan_groups_by_dtype_in_order_of_first_appearance():
    dtypes = (F32, BF16, F32, F16, BF16)
    sizes = (100, 300, 5, 17, 9)
    groups = tk.plan(dtypes, sizes, 132)
    assert [(g.dtype, g.leaves) for g in groups] == [(F32, (0, 2)), (BF16, (1, 4)),
                                                     (F16, (3,))]
    assert [g.chunk for g in groups] == [128 * 4, 128 * 8, 128 * 8]  # 16-byte vectors
    assert [g.first_block for g in groups] == [(0, 1), (0, 1), (0,)]


@pytest.mark.parametrize("n_leaves,parts", [(48, [48]), (50, [48, 2]), (97, [48, 48, 1])])
def test_plan_splits_trees_larger_than_one_table(n_leaves, parts):
    groups = tk.plan((F32,) * n_leaves, tuple(range(1, n_leaves + 1)), 132)
    assert [len(g.leaves) for g in groups] == parts
    assert sum((g.leaves for g in groups), ()) == tuple(range(n_leaves))
    for g in groups:  # each table's prefix starts again at block 0
        assert g.first_block[0] == 0
        assert all(b > a for a, b in zip(g.first_block, g.first_block[1:]))


def test_plan_leaves_out_empty_leaves_and_refuses_other_dtypes():
    (g,) = tk.plan((F32, F32, F32), (0, 64, 0), 132)
    assert g.leaves == (1,)
    assert tk.plan((F32,), (0,), 132) == ()
    with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
        tk.plan((torch.float64,), (8,), 132)


def test_table_words_layout_and_alignment_flags():
    (g,) = tk.plan((F32, F32, F32), (40, 12, 3), 132)
    base = 1 << 20
    x = [base + 0x1000, base + 0x2004, base + 0x3000]  # leaf 1's x is off by 4
    u = [base + 0x4000, base + 0x5000, base + 0x6008]  # leaf 2's u is off by 8
    p = [base + 0x7000, base + 0x8000, base + 0x9000]
    out = [base + 0xa000, base + 0xb000, base + 0xc000]
    words = tk.table_words(g, x, u, p, out, [40, 12, 3], [10, 3, 1])
    assert len(words) == 8 * 3
    rows = [words[i:i + 8] for i in range(0, 24, 8)]
    m10, m3 = 429496730, 1431655766  # ceil(2^32 / 10), ceil(2^32 / 3); n = 1: 0
    assert rows[0] == [x[0], u[0], p[0], out[0], 40, 10, 0, 1 | m10 << 32]
    assert rows[1] == [x[1], u[1], p[1], out[1], 12, 3, 1, 0 | m3 << 32]
    assert rows[2] == [x[2], u[2], p[2], out[2], 3, 1, 2, 0]
    flags = lambda ws: [ws[i + 7] & 0xFFFFFFFF for i in range(0, 24, 8)]  # noqa: E731
    # u absent: the u word is 0 and no longer decides the flag.
    words = tk.table_words(g, x, None, p, out, [40, 12, 3], [10, 3, 1])
    assert [words[i + 1] for i in range(0, 24, 8)] == [0, 0, 0]
    assert flags(words) == [1, 0, 1]
    # An output off 16 bytes clears its leaf's flag too.
    words = tk.table_words(g, x, None, p, [out[0] + 2] + out[1:], [40, 12, 3], [10, 3, 1])
    assert flags(words) == [0, 0, 1]


@pytest.mark.parametrize("chunk", [512, 1024, 2048, 4096])
def test_row_magic_finds_the_row_of_every_offset_in_a_chunk(chunk):
    """(x * ceil(2^32 / n)) >> 32 == x // n for every offset the kernel
    forms (x = rem0 + l < n + chunk <= 2 * chunk) and every n it uses the
    magic for (2 <= n <= chunk); larger n gets none (a compare suffices)."""
    x = np.arange(2 * chunk, dtype=np.uint64)
    for n in [n for n in list(range(2, 70)) + [127, 128, 1000, 1023] if n <= chunk] + [
            chunk - 1, chunk]:
        m = tk.row_magic(n, chunk)
        assert 0 < m < 2 ** 32
        np.testing.assert_array_equal((x * np.uint64(m)) >> np.uint64(32), x // n)
    assert tk.row_magic(1, chunk) == 0 and tk.row_magic(chunk + 1, chunk) == 0


def test_kernel_constants_match_the_source():
    """The wrapper's table size and block width are the kernel's."""
    src = CSRC.read_text()
    assert re.search(rf"constexpr int kMaxLeaves = {tk.MAX_LEAVES};", src)
    assert re.search(rf"constexpr int kThreads = {tk.THREADS};", src)
    # 64 bytes a leaf, and the table within 4 KB of kernel parameters.
    assert 64 * tk.MAX_LEAVES + 16 <= 4096


def _leaves(shapes, dtype=torch.float32):
    return [torch.zeros(s, dtype=dtype) for s in shapes]


def test_tree_wrapper_refuses_bad_leaves_before_any_launch():
    xs = _leaves([(4, 8), (4, 3)])
    w = torch.zeros(4)
    before = dict(tk.LAUNCHES)
    cases = [
        (ValueError, "contiguous", ([xs[0].t().contiguous().t(), xs[1]], None, xs)),
        (ValueError, "shapes differ", (xs, None, _leaves([(4, 8), (4, 4)]))),
        (TypeError, "dtypes differ", (xs, None, [xs[0], xs[1].bfloat16()])),
        (TypeError, "float32, bfloat16 or float16", ([x.double() for x in xs], None,
                                                     [x.double() for x in xs])),
        (ValueError, "different numbers of leaves", (xs, None, xs[:1])),
        (ValueError, "different numbers of leaves", (xs, xs[:1], xs)),
        (ValueError, "different row counts", (_leaves([(4, 8), (3, 3)]), None,
                                              _leaves([(4, 8), (3, 3)]))),
        (ValueError, "leading row axis", (_leaves([(4,), ()]), None, _leaves([(4,), ()]))),
        (ValueError, "no leaves", ([], None, [])),
        (TypeError, "not a tensor", ([np.zeros((4, 8))], None, [np.zeros((4, 8))])),
        # A tree that is right but lies on the CPU: the kernel takes CUDA only.
        (ValueError, "CUDA tensor", (xs, None, xs)),
        (ValueError, "CUDA tensor", (xs, xs, xs)),
    ]
    for exc, match, (x, u, p) in cases:
        with pytest.raises(exc, match=match):
            tk.gossip_mix_rows_tree(x, u, p, w)
    assert tk.LAUNCHES == before  # nothing was launched, nothing counted


def test_engine_mixes_once_per_cohort(monkeypatch):
    """Every counted cohort runs the cohort body once, which mixes the whole
    tree with one ``ops.gossip_mix_tree`` call: on a card, one launch a
    cohort (the check of chip_smoke.py's phase 4)."""
    from repro_torch.core.nettime import LinkTimeModel, Topology
    from repro_torch.data.partition import uniform_partition
    from repro_torch.data.synthetic import train_eval_split
    from repro_torch.train import engine
    from repro_torch.train.simulator import SimConfig, simulate

    calls = [0]
    mix = engine.kops.gossip_mix_tree

    def counted(*args):
        calls[0] += 1
        return mix(*args)

    monkeypatch.setattr(engine.kops, "gossip_mix_tree", counted)
    x, y, ex, ey = train_eval_split(1600, 400, 32, 10, seed=0)
    parts = uniform_partition(len(y), 8, seed=0)
    link = LinkTimeModel(Topology(n_workers=8, workers_per_host=4, hosts_per_pod=1),
                         jitter=0.02, seed=5)
    cfg = SimConfig(algorithm="netmax", n_workers=8, engine="batched",
                    use_mix_kernel=True, total_events=300, monitor_period=0.5, seed=0)
    res = simulate(cfg, link, x, y, parts, ex, ey, record_every=100, device="cpu")
    assert res.engine == "batched" and res.cohorts > 0
    assert calls[0] == res.cohorts


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_tree_cases_cover_the_listed_trees():
    """chip_smoke.py's tree cases, built here on the CPU: they hold leaves
    off 16-byte boundaries, n = 10 and n = 1, rows of 70,000, R = 1, f16
    and bf16, mixed dtypes and more leaves than one table; on each leaf the
    plain u-less form equals the zeros_like-u form bit for bit."""
    cs = _chip_smoke()
    gen = torch.Generator().manual_seed(0)
    seen = set()
    for name, case in cs.tree_cases().items():
        xs, us, ps, w = cs.make_tree(torch, case, "cpu", gen)
        R = case[0]
        assert tuple(w.shape) == (R,) and w[0].item() == 0.0
        dtypes = {x.dtype for x in xs}
        for x, u, p in zip(xs, us, ps):
            assert x.shape == u.shape == p.shape and x.shape[0] == R
            assert x.is_contiguous() and x.dtype == u.dtype == p.dtype
            n = x.numel() // R
            seen |= {f"n={n}"} if n in (1, 10, 70000) else set()
            if x.data_ptr() % 16:
                seen.add("unaligned")
            assert cs.bits_equal(torch, ref.reference_gossip_mix_rows(x, None, p, w),
                                 ref.reference_gossip_mix_rows(x, torch.zeros_like(x), p, w))
        seen |= {str(d) for d in dtypes}
        if R == 1:
            seen.add("R=1")
        if len(dtypes) > 1:
            seen.add("mixed dtypes")
        if len(xs) > tk.MAX_LEAVES:
            seen.add("more leaves than a table")
    assert seen >= {"unaligned", "n=1", "n=10", "n=70000", "R=1", "torch.float16",
                    "torch.bfloat16", "torch.float32", "mixed dtypes",
                    "more leaves than a table"}
