"""The port's CUDA kernels on the card (marker ``cuda``; skips without one).

The gossip-mix kernel repeats its plain version's f32 steps with every
rounding in the same place (no FMA contraction), so it is held to it
bit for bit.  This file imports no JAX, so it runs on a machine that has
only torch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import gossip_mix as tk
from repro_torch.kernels import ops, ref

# tests/test_kernels.py MIX_CASES / MIX_ROWS_CASES, plus main-path leaves.
MIX_CASES = [
    ((1024,), "float32", 0.25),
    ((127, 33), "float32", 0.8),
    ((8, 64, 32), "bfloat16", 0.5),
    ((70000,), "float32", 0.0),
    ((256,), "float32", 1.0),
]
MIX_ROWS_CASES = [
    ((4, 1024), "float32"),
    ((3, 127, 33), "float32"),
    ((8, 64, 32), "bfloat16"),
    ((1, 70000), "float32"),
    ((32, 10), "float32"),
    ((32, 64, 10), "float16"),
]


def _inputs(seed, shape, dtype, device):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]
    arrs[1] *= np.float32(0.01)
    return [torch.from_numpy(a).to(device=device, dtype=getattr(torch, dtype))
            for a in arrs]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the gossip-mix kernel runs only on the GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,w", MIX_CASES)
def test_cuda_gossip_mix_equals_plain(cuda_device, shape, dtype, w):
    x, u, p = _inputs(0, shape, dtype, cuda_device)
    n0 = tk.LAUNCHES["gossip_mix"]
    got = tk.gossip_mix(x, u, p, w)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["gossip_mix"] == n0 + 1
    torch.testing.assert_close(got, ref.reference_gossip_mix(x, u, p, w),
                               atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", MIX_ROWS_CASES)
def test_cuda_gossip_mix_rows_equals_plain(cuda_device, shape, dtype):
    x, u, p = _inputs(1, shape, dtype, cuda_device)
    w = torch.linspace(0.0, 1.0, shape[0], device=cuda_device)
    n0 = tk.LAUNCHES["gossip_mix_rows"]
    got = ops.mix_rows(x, u, p, w)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["gossip_mix_rows"] == n0 + 1
    torch.testing.assert_close(got, ref.reference_gossip_mix_rows(x, u, p, w),
                               atol=0, rtol=0)


@pytest.mark.cuda
def test_cuda_wrapper_checks_operands(cuda_device):
    x = torch.zeros(4, 8, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        tk.gossip_mix_rows(x.t(), x.t(), x.t(), torch.zeros(8, device=cuda_device))
    with pytest.raises(ValueError, match="float32"):
        tk.gossip_mix_rows(x, x, x, torch.zeros(4, device=cuda_device,
                                                dtype=torch.float64))
    with pytest.raises(TypeError, match="dtype"):
        tk.gossip_mix(x.double(), x.double(), x.double(), 0.5)
