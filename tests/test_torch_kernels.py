"""The port's gossip-mix kernels and dispatchers against the JAX package.

On the CPU, ``repro_torch.kernels.ops`` runs the plain torch versions; they
are held against the JAX package's Pallas kernels run in interpret mode on
the same numpy-seeded inputs, with the tolerances of tests/test_kernels.py
(1e-6 for f32, 2e-2 for bf16: bf16 keeps 8 bits of mantissa, and the two
frameworks may round an intermediate differently).  The CUDA kernel itself
runs only on a card: tests/test_torch_cuda.py holds it against the plain
version there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.gossip_mix import gossip_mix as jax_gossip_mix
from repro.kernels.gossip_mix import gossip_mix_rows as jax_gossip_mix_rows
from repro_torch.kernels import gossip_mix as tk
from repro_torch.kernels import ops, ref

# The cases of tests/test_kernels.py (MIX_CASES / MIX_ROWS_CASES).
MIX_CASES = [
    ((1024,), "float32", 0.25),
    ((127, 33), "float32", 0.8),  # non-divisible -> padding / masked tail
    ((8, 64, 32), "bfloat16", 0.5),
    ((70000,), "float32", 0.0),  # multi-block, w=0 edge
    ((256,), "float32", 1.0),  # w=1 edge
]

MIX_ROWS_CASES = [
    ((4, 1024), "float32"),
    ((3, 127, 33), "float32"),  # non-divisible trailing -> scalar path
    ((8, 64, 32), "bfloat16"),
    ((1, 70000), "float32"),  # multi-block row
]

# The simulator MLP's leaves, [32, 128, 64, 10], stacked over a cohort.
MLP_DIMS = [32, 128, 64, 10]


def _tol(dtype):
    return 2e-2 if dtype == "bfloat16" else 1e-6


def _inputs(seed, shape, dtype):
    """x, u, p as (jax, torch) pairs from one numpy draw (u scaled 0.01)."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]
    arrs[1] *= np.float32(0.01)
    jx = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrs]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return jx, tx


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().cpu().numpy()
    return np.asarray(a, np.float32)


@pytest.mark.parametrize("shape,dtype,w", MIX_CASES)
def test_mix_matches_jax_kernel(shape, dtype, w):
    (jx, ju, jp), (tx, tu, tp) = _inputs(0, shape, dtype)
    want = jax_gossip_mix(jx, ju, jp, jnp.float32(w), interpret=True, block=4096)
    got = ops.mix(tx, tu, tp, w)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    tol = _tol(dtype)
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("shape,dtype", MIX_ROWS_CASES)
def test_mix_rows_matches_jax_kernel(shape, dtype):
    (jx, ju, jp), (tx, tu, tp) = _inputs(1, shape, dtype)
    w = np.linspace(0.0, 1.0, shape[0]).astype(np.float32)
    want = jax_gossip_mix_rows(jx, ju, jp, jnp.asarray(w), interpret=True,
                               block=4096)
    got = ops.mix_rows(tx, tu, tp, torch.from_numpy(w))
    assert got.dtype == tx.dtype and got.shape == tx.shape
    tol = _tol(dtype)
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def _mlp_trees(seed, R):
    rng = np.random.default_rng(seed)
    shapes = []
    for a, b in zip(MLP_DIMS[:-1], MLP_DIMS[1:]):
        shapes.append({"w": (R, a, b), "b": (R, b)})

    def draw():
        return [{k: rng.standard_normal(s).astype(np.float32) for k, s in l.items()}
                for l in shapes]

    return draw(), draw()


@pytest.mark.parametrize("use_pallas", [False, "interpret"])
def test_gossip_mix_tree_matches_jax(use_pallas):
    """The engine's tree-level mix, u = 0, one weight per cohort row."""
    h, p = _mlp_trees(2, 5)
    w = np.asarray([0.0, 0.25, 0.5, 0.9, 1.0], np.float32)
    jtree = lambda t: [{k: jnp.asarray(v) for k, v in l.items()} for l in t]
    ttree = lambda t: [{k: torch.from_numpy(v) for k, v in l.items()} for l in t]
    want = jops.gossip_mix_tree(jtree(h), jtree(p), jnp.asarray(w),
                                use_pallas=use_pallas)
    got = ops.gossip_mix_tree(ttree(h), ttree(p), torch.from_numpy(w))
    assert len(got) == len(want)
    for gl, wl in zip(got, want):
        assert sorted(gl) == sorted(wl)
        for k in gl:
            assert tuple(gl[k].shape) == wl[k].shape
            np.testing.assert_allclose(_np(gl[k]), _np(wl[k]), atol=1e-6, rtol=1e-6)


def test_rows_equal_per_row_scalar_mix():
    """mix_rows is exactly R scalar mix calls (the port's B1 == R x B2)."""
    _, (x, u, p) = _inputs(3, (5, 777), "float32")
    w = torch.tensor([0.0, 0.25, 0.5, 0.9, 1.0])
    got = ops.mix_rows(x, u, p, w)
    for r in range(5):
        torch.testing.assert_close(got[r], ops.mix(x[r], u[r], p[r], float(w[r])),
                                   atol=0, rtol=0)


def test_kernel_wrappers_refuse_cpu_tensors():
    """The wrappers launch the kernel or raise; only ops picks the plain
    version, and only for a CPU tensor."""
    _, (x, u, p) = _inputs(4, (4, 64), "float32")
    before = dict(tk.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tk.gossip_mix(x, u, p, 0.5)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tk.gossip_mix_rows(x, u, p, torch.zeros(4))
    assert tk.LAUNCHES == before  # nothing was launched, nothing counted
    with pytest.raises(ValueError, match="no gossip-mix path"):
        ops.mix_rows(x.to("meta"), u.to("meta"), p.to("meta"), torch.zeros(4))


def test_reference_rounds_w_to_f32_first():
    """w is rounded to f32 before 1 - w, as the kernel's float argument and
    the JAX wrapper's jnp.float32(w) do."""
    x = torch.ones(4)
    w = 0.1  # not exact in f32
    out = ref.reference_gossip_mix(x, torch.zeros(4), torch.zeros(4), w)
    expect = np.float32(1.0) - np.float32(w)
    assert out[0].item() == float(expect)
