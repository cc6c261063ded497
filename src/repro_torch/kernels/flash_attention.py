"""Forward GQA flash attention: the CUDA kernel's wrapper.

    out = softmax(q k^T / sqrt(hd), causal mask) v        (per query head)

The kernel (``csrc/flash_attention.cu``, CUDA C++ for ``sm_90a``) replaces
the JAX package's Pallas kernel ``repro/kernels/flash_attention.py``.  One
block serves all G = H / Hk query heads of one KV head for a tile of 64
folded (position, group member) rows, so every K/V tile is read once; a
causal block stops at the last key its positions can see.  It has two
bodies, picked by dtype (``BODIES``): bf16, the serving path, runs
FlashAttention-2 on the tensor cores (``mma.sync`` bf16 with f32
accumulation, ``ldmatrix`` fragments, K/V tiles double-buffered with
``cp.async``); f32 runs on the FMA units, because neither bf16 nor TF32
tensor cores hold the f32 tolerance.  Both keep f32 softmax statistics,
masked scores at -1e30 and the row-sum floor of the reference.  It is
forward only, as the Pallas kernel is: the wrapper raises when autograd
would need a gradient through it.

Takes CUDA tensors only and raises on anything else: ``kernels/ops.py``
sends CPU tensors to ``ref.reference_attention``.  The wrapper counts its
launches in ``LAUNCHES`` (raised only where the kernel is launched), and in
``BODY_LAUNCHES`` by body.  The library is built by nvcc on first use
(``kernels/build.py``), never at import.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

#: Launch count; ``reset_launches()`` zeroes it.
LAUNCHES = {"flash_attention": 0}

#: The kernel body each dtype runs (``flash_fwd_bf16_mma_kernel`` on the
#: tensor cores, ``flash_fwd_kernel`` on the FMA units).
BODIES = {torch.bfloat16: "tensor_core", torch.float32: "fma"}

#: The same launches by body.
BODY_LAUNCHES = {"tensor_core": 0, "fma": 0}

#: Head dims the kernel is instantiated for (the test cases' 32, 64 and 128;
#: tinyllama, qwen1.5 and starcoder2 use 64 or 128, stablelm-12b 160).
HEAD_DIMS = (32, 64, 128, 160)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_Y = 65535

_LIB = None


def reset_launches() -> None:
    for counts in (LAUNCHES, BODY_LAUNCHES):
        for k in counts:
            counts[k] = 0


def _lib():
    global _LIB
    if _LIB is None:
        lib = build.load("flash_attention")
        lib.flash_attention_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # q, k, v
            ctypes.c_void_p,  # out
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, S, Sk
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # H, Hk, hd
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # dtype, causal, device
            ctypes.c_void_p,  # stream
        ]
        lib.flash_attention_launch.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check_operands(q, k, v) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
            raise ValueError(
                f"flash_attention: {name} must be a CUDA tensor (got "
                f"{getattr(t, 'device', type(t))}); kernels/ops.py routes CPU "
                "tensors to the plain version"
            )
        if t.dtype not in _DTYPE_CODE:
            raise TypeError(f"flash_attention: {name} has dtype {t.dtype}; the "
                            "kernel takes float32 or bfloat16")
        if t.ndim != 4:
            raise ValueError(f"flash_attention: {name} must be 4-D, got shape "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
        if t.dtype == torch.bfloat16 and t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must start on a 16-byte boundary "
                             "(the bf16 body copies 16-byte rows)")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash_attention: dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: operands lie on different devices")
    B, S, H, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} (B, S, H, hd) does not "
                         f"match k {tuple(k.shape)} / v {tuple(v.shape)} (B, Sk, Hk, hd)")
    Sk, Hk = k.shape[1], k.shape[2]
    if min(B, S, H, Sk, Hk) <= 0:
        raise ValueError(f"flash_attention: empty operand, q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    if H % Hk:
        raise ValueError(f"flash_attention: {H} query heads are not a multiple of "
                         f"{Hk} KV heads")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} is not one of {HEAD_DIMS}")
    if B * Hk > _MAX_GRID_Y:
        raise ValueError(f"flash_attention: B * Hk = {B * Hk} exceeds {_MAX_GRID_Y}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError("flash_attention: the kernel is forward only (no backward "
                           "kernel yet); call it under torch.no_grad()")


def flash_attention(q, k, v, *, causal: bool = True):
    """GQA attention on CUDA. q: (B,S,H,hd); k/v: (B,Sk,Hk,hd) -> (B,S,H,hd).

    f32 or bf16, contiguous, H % Hk == 0, hd in ``HEAD_DIMS``; f32 softmax
    and accumulation (bf16 products on the tensor cores for bf16), the output
    in q's dtype.  Causal positions align from 0 for any S and Sk."""
    _check_operands(q, k, v)
    B, S, H, hd = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, S, Sk, H, Hk, hd, _DTYPE_CODE[q.dtype], int(bool(causal)),
        q.device.index, stream,
    )
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention: kernel launch failed: CUDA error {err} "
                           f"({msg})")
    LAUNCHES["flash_attention"] += 1
    BODY_LAUNCHES[BODIES[q.dtype]] += 1
    return out
