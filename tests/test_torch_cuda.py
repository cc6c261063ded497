"""The port's CUDA kernels on the card (marker ``cuda``; skips without one).

The gossip-mix kernel repeats its plain version's f32 steps with every
rounding in the same place (no FMA contraction), so it is held to it
bit for bit.  The flash-attention kernel sums in another order than its
plain version, so it is held to the tolerances of ``tests/test_kernels.py``
(2e-5 in f32, 2e-2 in bf16).  This file imports no JAX, so it runs on a machine that has
only torch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
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
        pytest.skip("needs a CUDA card: the port's kernels run only on the GPU")
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


# tests/test_kernels.py ATTN_CASES, a ragged causal case, a ragged S != Sk
# case with head_dim 160, and one tinyllama-1.1b layer of the LM serving
# phase of chip_smoke.py (B=4, S=512, 32 heads over 4 KV heads, hd 64).
ATTN_CASES = [
    # (B, S, Sk, H, Hk, hd, causal, dtype)
    (1, 128, 128, 4, 4, 64, True, "float32"),
    (2, 256, 256, 8, 2, 64, True, "float32"),
    (1, 128, 128, 4, 1, 32, True, "float32"),
    (2, 128, 256, 4, 4, 64, False, "float32"),
    (1, 256, 256, 2, 2, 128, True, "bfloat16"),
    (1, 512, 512, 4, 2, 64, True, "float32"),
    (1, 200, 200, 8, 2, 64, True, "float32"),
    (2, 100, 37, 8, 2, 160, True, "float32"),
    (4, 512, 512, 32, 4, 64, True, "bfloat16"),
]
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _qkv(seed, B, S, Sk, H, Hk, hd, dtype, device):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(device=device, dtype=getattr(torch, dtype))
            for s in ((B, S, H, hd), (B, Sk, Hk, hd), (B, Sk, Hk, hd))]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ATTN_CASES, ids=lambda c: "-".join(map(str, c)))
def test_cuda_flash_attention_matches_plain(cuda_device, case):
    B, S, Sk, H, Hk, hd, causal, dtype = case
    q, k, v = _qkv(2, B, S, Sk, H, Hk, hd, dtype, cuda_device)
    n0 = fa.LAUNCHES["flash_attention"]
    got = ops.attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == n0 + 1
    assert got.shape == q.shape and got.dtype == q.dtype
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), ref.reference_attention(q, k, v, causal=causal)
                               .float(), atol=tol, rtol=tol)


@pytest.mark.cuda
def test_cuda_flash_wrapper_checks_operands(cuda_device):
    q, k, v = _qkv(3, 1, 64, 64, 4, 2, 64, "float32", cuda_device)
    n0 = fa.LAUNCHES["flash_attention"]
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fa.flash_attention(q.cpu(), k.cpu(), v.cpu())
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(*_qkv(3, 1, 64, 64, 4, 2, 48, "float32", cuda_device))
    with pytest.raises(ValueError, match="multiple"):
        fa.flash_attention(*_qkv(3, 1, 64, 64, 4, 3, 64, "float32", cuda_device)[:1],
                           *_qkv(3, 1, 64, 64, 3, 3, 64, "float32", cuda_device)[1:])
    with pytest.raises(TypeError, match="dtype"):
        fa.flash_attention(q.double(), k.double(), v.double())
    assert fa.LAUNCHES["flash_attention"] == n0
