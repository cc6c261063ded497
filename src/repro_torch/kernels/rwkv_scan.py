"""Chunked RWKV-6 WKV recurrence (forward): the CUDA kernel's wrapper.

    y_t = r_t (S + diag(u) k_t v_t^T),   S <- diag(w_t) S + k_t v_t^T

per (batch, head), with the (N, N) f32 state S.  The kernel
(``csrc/rwkv_scan.cu``, CUDA C++ for ``sm_90a``) replaces the JAX package's
Pallas kernel ``repro/kernels/rwkv_scan.py``: the same chunk form over
sub-chunks of ``min(16, chunk)`` tokens, but exact for any decay in (0, 1],
as the JAX model's recurrence is (the Pallas wrapper clamps the per-step log
decay to ``>= -75 / min(16, chunk)``; ``ref.clamp_decay`` gives its decays).
A sub-chunk whose total log decay is >= -75 in every column forms its
scores from two factors on the tensor cores; one with a column below forms
them pairwise, one exp a term.  One block walks one (batch, head); its
products run on the tensor cores in 3xTF32, which keeps f32 accuracy.  Unlike the Pallas kernel
it takes an initial state and returns the final one, the ssm family's decode
cache.  Any S works; the last chunk and sub-chunk may be short.  It is
forward only, as the Pallas kernel is: the wrapper raises when autograd
would need a gradient through it.

Operand dtypes (``DTYPES``): r, k, v, w all f32; all bf16; or r, k, v bf16
with w f32 (the model's bf16 projections with its f32 decays).  y comes back
in r's dtype, the state in f32; bf16 inputs are widened to f32 exactly.

Takes CUDA tensors only and raises on anything else: ``kernels/ops.py``
sends CPU tensors to ``ref.reference_rwkv_state``.  The wrapper counts its
launches in ``LAUNCHES`` (raised only where the kernel is launched), and in
``DTYPE_LAUNCHES`` by operand dtypes.  The library is built by nvcc on first
use (``kernels/build.py``), never at import.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

#: Launch count; ``reset_launches()`` zeroes it.
LAUNCHES = {"rwkv_scan": 0}

#: The same launches by operand dtypes (keys of ``DTYPES``' values).
DTYPE_LAUNCHES = {"float32": 0, "bfloat16": 0, "mixed": 0}

#: Head sizes the kernel is instantiated for (the test cases' 16 and 32;
#: rwkv6-7b's 64).
HEAD_SIZES = (16, 32, 64)

#: Sub-chunk length of the Pallas kernel (``_SUB``): the kernel's tile of tokens.
SUB = 16

#: (dtype of r, k and v, dtype of w) -> (the kernel's dtype code, its name).
DTYPES = {
    (torch.float32, torch.float32): (0, "float32"),
    (torch.bfloat16, torch.bfloat16): (1, "bfloat16"),
    (torch.bfloat16, torch.float32): (2, "mixed"),
}
_MAX_BLOCKS = 2 ** 31 - 1

_LIB = None


def reset_launches() -> None:
    for counts in (LAUNCHES, DTYPE_LAUNCHES):
        for k in counts:
            counts[k] = 0


def dtype_code(r, k, v, w) -> tuple[int, str]:
    """The kernel's (dtype code, name) for these operands; raises TypeError
    for any combination outside ``DTYPES``."""
    dts = tuple(getattr(t, "dtype", None) for t in (r, k, v, w))
    found = DTYPES.get((dts[0], dts[3])) if dts[0] == dts[1] == dts[2] else None
    if found is None:
        raise TypeError(f"rwkv_scan: dtypes of r, k, v, w {dts} differ from what the "
                        "kernel takes: all float32, all bfloat16, or r, k, v bfloat16 "
                        "with w float32")
    return found


def _lib():
    global _LIB
    if _LIB is None:
        lib = build.load("rwkv_scan")
        lib.rwkv_scan_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # r k v w
            ctypes.c_void_p, ctypes.c_void_p,  # u, state_in (or None)
            ctypes.c_void_p, ctypes.c_void_p,  # y, state_out
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, S, H, N
            ctypes.c_int, ctypes.c_int,  # chunk, sub
            ctypes.c_int, ctypes.c_int,  # dtype, device
            ctypes.c_void_p,  # stream
        ]
        lib.rwkv_scan_launch.restype = ctypes.c_int
        lib.rwkv_scan_error_string.argtypes = [ctypes.c_int]
        lib.rwkv_scan_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check_operands(r, k, v, w, u, state, chunk) -> tuple[int, str]:
    """Raises on anything the kernel does not take; returns ``dtype_code``."""
    code = dtype_code(r, k, v, w)
    named = (("r", r), ("k", k), ("v", v), ("w", w), ("u", u))
    if state is not None:
        named += (("state", state),)
    for name, t in named:
        if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
            raise ValueError(
                f"rwkv_scan: {name} must be a CUDA tensor (got "
                f"{getattr(t, 'device', type(t))}); kernels/ops.py routes CPU "
                "tensors to the plain version"
            )
        if not t.is_contiguous():
            raise ValueError(f"rwkv_scan: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"rwkv_scan: {name} must start on a 16-byte boundary "
                             "(the kernel copies 16-byte rows)")
        if t.device != r.device:
            raise ValueError("rwkv_scan: operands lie on different devices")
    if r.ndim != 4 or not (r.shape == k.shape == v.shape == w.shape):
        raise ValueError(f"rwkv_scan: r, k, v, w must share one (B, S, H, N) shape, got "
                         f"{[tuple(t.shape) for t in (r, k, v, w)]}")
    B, S, H, N = r.shape
    if min(B, S, H) <= 0:
        raise ValueError(f"rwkv_scan: empty operand {tuple(r.shape)}")
    if N not in HEAD_SIZES:
        raise ValueError(f"rwkv_scan: head size {N} is not one of {HEAD_SIZES}")
    if u.dtype != torch.float32 or tuple(u.shape) != (H, N):
        raise ValueError(f"rwkv_scan: u must be float32 of shape {(H, N)}, got "
                         f"{u.dtype} {tuple(u.shape)}")
    if state is not None and (state.dtype != torch.float32
                              or tuple(state.shape) != (B, H, N, N)):
        raise ValueError(f"rwkv_scan: state must be float32 of shape {(B, H, N, N)}, "
                         f"got {state.dtype} {tuple(state.shape)}")
    if int(chunk) < 1:
        raise ValueError(f"rwkv_scan: chunk {chunk} < 1")
    if B * H > _MAX_BLOCKS:
        raise ValueError(f"rwkv_scan: B * H = {B * H} is too many heads for one launch")
    if torch.is_grad_enabled() and any(t.requires_grad for _, t in named):
        raise RuntimeError("rwkv_scan: the kernel is forward only (no backward kernel "
                           "yet); call it under torch.no_grad()")
    return code


def rwkv_scan(r, k, v, w, u, *, chunk: int = 64, state=None):
    """WKV recurrence on CUDA. r/k/v/w: (B,S,H,N); u: (H,N) f32; state:
    (B,H,N,N) f32 or None (zeros) -> (y (B,S,H,N) in r's dtype, final state
    (B,H,N,N) f32).

    r, k, v, w: a combination of ``DTYPES``, contiguous; N in
    ``HEAD_SIZES``.  As the Pallas wrapper, ``chunk`` is cut to S; unlike
    it, the decays are not clamped."""
    code, dtype_name = _check_operands(r, k, v, w, u, state, chunk)
    B, S, H, N = r.shape
    chunk = min(int(chunk), S)
    sub = min(SUB, chunk)
    y = torch.empty_like(r)
    state_out = torch.empty((B, H, N, N), dtype=torch.float32, device=r.device)
    lib = _lib()
    stream = torch.cuda.current_stream(r.device).cuda_stream
    err = lib.rwkv_scan_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        None if state is None else state.data_ptr(), y.data_ptr(), state_out.data_ptr(),
        B, S, H, N, chunk, sub, code, r.device.index, stream,
    )
    if err != 0:
        msg = lib.rwkv_scan_error_string(err).decode()
        raise RuntimeError(f"rwkv_scan: kernel launch failed: CUDA error {err} ({msg})")
    LAUNCHES["rwkv_scan"] += 1
    DTYPE_LAUNCHES[dtype_name] += 1
    return y, state_out
