"""Fused NetMax two-step update (gossip mix): the CUDA kernel's wrappers.

    out = (1 - w) * (x + u) + w * pulled        (Alg. 2 lines 11 + 13-15)

The kernel (``csrc/gossip_mix.cu``, CUDA C++ for ``sm_90a``) replaces the
JAX package's Pallas kernels in ``repro/kernels/gossip_mix.py``.  It is
bound by HBM bytes: three reads and one write of R * n * itemsize each.
Two entry points share it, as they shared the Pallas body:

* ``gossip_mix``       — one replica, scalar ``w`` (launched as one row);
* ``gossip_mix_rows``  — a stacked (R, ...) block with per-row weights
  ``w`` (R,) f32, one launch for a whole cohort (the batched engine).

Both take CUDA tensors only and raise on anything else: ``kernels/ops.py``
sends CPU tensors to the plain versions in ``kernels/ref.py``.  Each wrapper
counts its launches in ``LAUNCHES`` (a plain integer per entry point, raised
only where the kernel is launched).  The library is built by nvcc on first
use (``kernels/build.py``), never at import.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

#: Launch count per entry point; ``reset_launches()`` zeroes them.
LAUNCHES = {"gossip_mix": 0, "gossip_mix_rows": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_LIB = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib():
    global _LIB
    if _LIB is None:
        lib = build.load("gossip_mix")
        lib.gossip_mix_rows_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # x, u, p
            ctypes.c_void_p, ctypes.c_float,  # w_rows, w_scalar
            ctypes.c_void_p,  # out
            ctypes.c_longlong, ctypes.c_longlong,  # R, n
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # dtype, vec, device
            ctypes.c_void_p,  # stream
        ]
        lib.gossip_mix_rows_launch.restype = ctypes.c_int
        lib.gossip_mix_error_string.argtypes = [ctypes.c_int]
        lib.gossip_mix_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check_operands(fn: str, x, u, pulled) -> None:
    for name, t in (("x", x), ("u", u), ("pulled", pulled)):
        if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
            raise ValueError(
                f"{fn}: {name} must be a CUDA tensor (got "
                f"{getattr(t, 'device', type(t))}); kernels/ops.py routes CPU "
                "tensors to the plain version"
            )
        if t.dtype not in _DTYPE_CODE:
            raise TypeError(f"{fn}: {name} has dtype {t.dtype}; the kernel "
                            "takes float32, bfloat16 or float16")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")
    if not (x.shape == u.shape == pulled.shape):
        raise ValueError(f"{fn}: shapes differ: x {tuple(x.shape)}, u "
                         f"{tuple(u.shape)}, pulled {tuple(pulled.shape)}")
    if not (x.dtype == u.dtype == pulled.dtype):
        raise TypeError(f"{fn}: dtypes differ: {x.dtype}, {u.dtype}, {pulled.dtype}")
    if not (x.device == u.device == pulled.device):
        raise ValueError(f"{fn}: operands lie on different devices")


def _launch(fn: str, x, u, pulled, w_rows, w_scalar: float, R: int, n: int):
    out = torch.empty_like(x)
    vec_elems = 16 // x.element_size()
    vec = all(t.data_ptr() % 16 == 0 for t in (x, u, pulled, out)) and (
        R == 1 or n % vec_elems == 0
    )
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.gossip_mix_rows_launch(
        x.data_ptr(), u.data_ptr(), pulled.data_ptr(),
        None if w_rows is None else w_rows.data_ptr(), w_scalar,
        out.data_ptr(), R, n, _DTYPE_CODE[x.dtype], int(vec),
        x.device.index, stream,
    )
    if err != 0:
        msg = lib.gossip_mix_error_string(err).decode()
        raise RuntimeError(f"{fn}: kernel launch failed: CUDA error {err} ({msg})")
    LAUNCHES[fn] += 1
    return out


def gossip_mix(x, u, pulled, w):
    """out = (1-w)*(x+u) + w*pulled elementwise on CUDA; ``w`` is a Python
    number or a one-element tensor (f32 math, cast back to x's dtype)."""
    _check_operands("gossip_mix", x, u, pulled)
    if isinstance(w, torch.Tensor):
        if w.numel() != 1:
            raise ValueError(f"gossip_mix: w must be a scalar, got shape {tuple(w.shape)}")
        if w.device.type == "cuda":
            if w.device != x.device or w.dtype != torch.float32:
                raise ValueError("gossip_mix: a CUDA w must be float32 on x's device")
            return _launch("gossip_mix", x, u, pulled, w, 0.0, 1, x.numel())
        w = float(w)
    return _launch("gossip_mix", x, u, pulled, None, float(w), 1, x.numel())


def gossip_mix_rows(x, u, pulled, w):
    """Per-row fused mix on CUDA: out[r] = (1-w[r])*(x[r]+u[r]) + w[r]*pulled[r].

    x/u/pulled: (R, ...) contiguous, same shape and dtype; w: (R,) float32
    on the same device."""
    _check_operands("gossip_mix_rows", x, u, pulled)
    if x.ndim < 1:
        raise ValueError("gossip_mix_rows: x needs a leading row axis")
    R = x.shape[0]
    if (not isinstance(w, torch.Tensor) or w.device != x.device
            or w.dtype != torch.float32 or tuple(w.shape) != (R,)
            or not w.is_contiguous()):
        raise ValueError(
            f"gossip_mix_rows: w must be a contiguous float32 ({R},) tensor on "
            f"{x.device}, got {getattr(w, 'dtype', type(w))} "
            f"{tuple(getattr(w, 'shape', ()))} on {getattr(w, 'device', None)}"
        )
    n = x.numel() // R if R else 0
    return _launch("gossip_mix_rows", x, u, pulled, w, 0.0, R, n)
