"""Chunked RWKV-6 WKV recurrence and its gradient: the CUDA kernels' wrappers.

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
cache.  Any S works; the last chunk and sub-chunk may be short.

The Pallas kernel is forward only (the JAX package differentiates its
model's scan with XLA); here the gradient is a kernel too
(``csrc/rwkv_scan_bwd.cu``: ``ref.reference_rwkv_backward`` in chunk form
over sub-chunks of ``BWD_SUB`` tokens, with each sequence cut into ranges of
``bwd_range_len`` tokens, one block a range: a first kernel walks the state
to every sub-chunk boundary and its adjoint to the range ends, a second
forms dr, dk, dv of each
range's sub-chunks on the tensor cores and dw = rowsum(G_t * S_{t-1}) from
the sub-chunk's states and adjoints on the FMA units; ``BWD_LAUNCHED`` holds
what the last call launched).  Under autograd (grad enabled
and an operand that requires grad) ``rwkv_scan`` goes through
``RwkvScanFn``: its forward launches the forward kernel and saves the
operands, its backward launches the backward kernel, with the final-state
gradient when the final state was used and without it (no zeros) when not,
and returns an initial-state gradient only when the state requires one.

Operand dtypes (``DTYPES``): r, k, v, w all f32; all bf16; or r, k, v bf16
with w f32 (the model's bf16 projections with its f32 decays).  y comes back
in r's dtype, the state in f32; bf16 inputs are widened to f32 exactly.  The
gradients come back in the operands' dtypes (dr, dk, dv in r's, dw in w's),
du and the initial-state gradient in f32.

Takes CUDA tensors only and raises on anything else: ``kernels/ops.py``
sends CPU tensors to ``ref.reference_rwkv_state``.  The wrappers count their
launches in ``LAUNCHES`` (raised only where a kernel is launched), and the
forward's in ``DTYPE_LAUNCHES`` by operand dtypes.  The libraries are built
by nvcc on first use (``kernels/build.py``), never at import.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

#: Launch counts of the forward and the backward; ``reset_launches()`` zeroes them.
LAUNCHES = {"rwkv_scan": 0, "rwkv_scan_bwd": 0}

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

#: Tokens of the backward kernels' sub-chunk (their ``kT``): the unit of a range.
BWD_SUB = 16

#: Sub-chunks of a backward range at most (the kernels' ``kMaxSubs``).
BWD_MAX_SUBS = 4

#: The backward kernels, by the symbols a trace names them with; a call
#: launches the first only when its sequences hold more than one sub-chunk.
BWD_KERNELS = ("rwkv_scan_bwd_bounds_kernel", "rwkv_scan_bwd_range_kernel")

#: What the last backward call launched, as its C entry reported it: the
#: range kernel's blocks and the tokens of the range it gave each (its
#: sub-chunks a range times ``BWD_SUB``), the ranges a sequence that makes
#: (blocks over B * H), the boundary kernel's blocks (0 when not launched)
#: and the kernels launched (names from ``BWD_KERNELS``).
BWD_LAUNCHED = {"range_len": None, "ranges": None, "blocks": None, "bound_blocks": None,
                "kernels": None}

_LIB = None
_BWD_LIB = None


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


def _bwd_lib():
    global _BWD_LIB
    if _BWD_LIB is None:
        lib = build.load("rwkv_scan_bwd")
        lib.rwkv_scan_bwd_launch.argtypes = [
            *[ctypes.c_void_p] * 4,  # r k v w
            ctypes.c_void_p, ctypes.c_void_p,  # u, state_in (or None)
            ctypes.c_void_p, ctypes.c_void_p,  # dy, dstate (or None)
            *[ctypes.c_void_p] * 4,  # dr dk dv dw
            ctypes.c_void_p, ctypes.c_void_p,  # du partials, dstate0 (or None)
            ctypes.c_void_p, ctypes.c_void_p,  # range-start states, range-end adjoints
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, S, H, N
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # range_len, dtype, device
            ctypes.c_void_p,  # stream
            ctypes.POINTER(ctypes.c_int),  # range blocks, sub-chunks a range, boundary blocks
        ]
        lib.rwkv_scan_bwd_launch.restype = ctypes.c_int
        lib.rwkv_scan_bwd_error_string.argtypes = [ctypes.c_int]
        lib.rwkv_scan_bwd_error_string.restype = ctypes.c_char_p
        _BWD_LIB = lib
    return _BWD_LIB


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
    return code


def _run_forward(r, k, v, w, u, state, chunk, code):
    """Launch the forward kernel on checked operands -> (y, final state)."""
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
    return y, state_out


def _forward(r, k, v, w, u, state, chunk):
    code, dtype_name = dtype_code(r, k, v, w)
    y, state_out = _run_forward(r, k, v, w, u, state, chunk, code)
    LAUNCHES["rwkv_scan"] += 1
    DTYPE_LAUNCHES[dtype_name] += 1
    return y, state_out


def bwd_range_len(B: int, S: int, H: int, sms: int) -> int:
    """Tokens of a backward range: the longest of 64, 32 and 16 whose ranges
    give the range kernel ``B * H * ceil(S / L)`` blocks enough to fill the
    card's ``sms`` SMs (16 when none does).  A sequence no longer than the
    range is one range."""
    L = BWD_MAX_SUBS * BWD_SUB
    while L > BWD_SUB and B * H * -(-S // L) < sms:
        L //= 2
    return L


def _run_backward(r, k, v, w, u, state, dy, dstate, with_dstate0):
    """Launch the backward kernels on checked operands -> (dr, dk, dv, dw,
    du partials (B, H, N) f32, dstate0 or None)."""
    B, S, H, N = r.shape
    code, _ = dtype_code(r, k, v, w)
    L = bwd_range_len(B, S, H, torch.cuda.get_device_properties(r.device).multi_processor_count)
    n_ranges = -(-S // L)
    if B * H * n_ranges > _MAX_BLOCKS:
        raise ValueError(f"rwkv_scan_backward: {B * H * n_ranges} ranges are too many blocks "
                         "for one launch")
    dr, dk, dv = (torch.empty_like(r) for _ in range(3))
    dw = torch.empty_like(w)
    du_part = torch.empty((B, H, n_ranges, N), dtype=torch.float32, device=r.device)
    dstate0 = (torch.empty((B, H, N, N), dtype=torch.float32, device=r.device)
               if with_dstate0 else None)
    # The states before every sub-chunk and the adjoints at the range ends.
    n_sub = -(-S // BWD_SUB)
    s_sub = (torch.empty((B * H, n_sub, N, N), dtype=torch.float32, device=r.device)
             if n_sub > 1 else None)
    g_bound = (torch.empty((B * H, n_ranges, N, N), dtype=torch.float32, device=r.device)
               if n_ranges > 1 else None)
    launched = (ctypes.c_int * 3)()
    lib = _bwd_lib()
    stream = torch.cuda.current_stream(r.device).cuda_stream
    err = lib.rwkv_scan_bwd_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        None if state is None else state.data_ptr(), dy.data_ptr(),
        None if dstate is None else dstate.data_ptr(),
        dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dw.data_ptr(), du_part.data_ptr(),
        None if dstate0 is None else dstate0.data_ptr(),
        None if s_sub is None else s_sub.data_ptr(),
        None if g_bound is None else g_bound.data_ptr(),
        B, S, H, N, L, code, r.device.index, stream, launched,
    )
    if err != 0:
        msg = lib.rwkv_scan_bwd_error_string(err).decode()
        raise RuntimeError(f"rwkv_scan_backward: kernel launch failed: CUDA error {err} "
                           f"({msg})")
    blocks, subs, bound_blocks = launched
    BWD_LAUNCHED.update(range_len=subs * BWD_SUB, ranges=blocks // (B * H), blocks=blocks,
                        bound_blocks=bound_blocks,
                        kernels=BWD_KERNELS[0 if bound_blocks else 1:])
    # du over the ranges of each (batch, head), in a fixed order (no atomics).
    return dr, dk, dv, dw, du_part.sum(2), dstate0


def _backward(r, k, v, w, u, state, dy, dstate, with_dstate0):
    dr, dk, dv, dw, du_part, dstate0 = _run_backward(r, k, v, w, u, state, dy, dstate,
                                                     with_dstate0)
    LAUNCHES["rwkv_scan_bwd"] += 1
    # du over the batch: one partial a (batch, head), summed in a fixed order.
    return dr, dk, dv, dw, du_part.sum(0), dstate0


def _check_grads(r, dy, dstate) -> None:
    B, S, H, N = r.shape
    if (not isinstance(dy, torch.Tensor) or dy.device != r.device or dy.dtype != r.dtype
            or dy.shape != r.shape or not dy.is_contiguous()):
        raise ValueError(f"rwkv_scan_backward: dy must be a contiguous {r.dtype} tensor of "
                         f"r's shape {tuple(r.shape)} on {r.device}")
    if dstate is not None and (
            not isinstance(dstate, torch.Tensor) or dstate.device != r.device
            or dstate.dtype != torch.float32 or tuple(dstate.shape) != (B, H, N, N)
            or not dstate.is_contiguous()):
        raise ValueError(f"rwkv_scan_backward: dstate must be a contiguous float32 "
                         f"{(B, H, N, N)} tensor on {r.device}")


def rwkv_scan_backward(r, k, v, w, u, state, dy, dstate, *, with_dstate0: bool = True):
    """The backward kernel -> (dr, dk, dv, dw, du, dstate0) of
    ``rwkv_scan(r, k, v, w, u, state=state)`` for the output gradient ``dy``
    (in r's dtype and shape) and the final-state gradient ``dstate``
    ((B,H,N,N) f32, or None: zeros).

    dr, dk, dv in r's dtype, dw in w's; du (H,N) f32, summed over the
    batch; dstate0 (B,H,N,N) f32, or None without ``with_dstate0``.  The
    operands as ``rwkv_scan`` takes them."""
    _check_operands(r, k, v, w, u, state, 1)
    _check_grads(r, dy, dstate)
    return _backward(r, k, v, w, u, state, dy, dstate, with_dstate0)


class RwkvScanFn(torch.autograd.Function):
    """The WKV scan with its gradient: the forward kernel on the way
    forward, the backward kernel on the way back.  Outputs (y, final
    state); inputs (r, k, v, w, u, state or None, chunk)."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state, chunk):
        y, state_out = _forward(r, k, v, w, u, state, chunk)
        ctx.save_for_backward(r, k, v, w, u, state)
        ctx.set_materialize_grads(False)  # an unused final state's gradient stays None
        return y, state_out

    @staticmethod
    def backward(ctx, dy, dstate):
        r, k, v, w, u, state = ctx.saved_tensors
        dy = torch.zeros_like(r) if dy is None else dy.contiguous()
        dstate = None if dstate is None else dstate.contiguous()
        with_dstate0 = state is not None and ctx.needs_input_grad[5]
        dr, dk, dv, dw, du, dstate0 = _backward(r, k, v, w, u, state, dy, dstate,
                                                with_dstate0)
        return dr, dk, dv, dw, du, dstate0, None


def rwkv_scan(r, k, v, w, u, *, chunk: int = 64, state=None):
    """WKV recurrence on CUDA. r/k/v/w: (B,S,H,N); u: (H,N) f32; state:
    (B,H,N,N) f32 or None (zeros) -> (y (B,S,H,N) in r's dtype, final state
    (B,H,N,N) f32).

    r, k, v, w: a combination of ``DTYPES``, contiguous; N in
    ``HEAD_SIZES``.  As the Pallas wrapper, ``chunk`` is cut to S; unlike
    it, the decays are not clamped.  Under autograd it is differentiable
    through the backward kernel (``RwkvScanFn``)."""
    _check_operands(r, k, v, w, u, state, chunk)
    operands = (r, k, v, w, u) + (() if state is None else (state,))
    if torch.is_grad_enabled() and any(t.requires_grad for t in operands):
        return RwkvScanFn.apply(r, k, v, w, u, state, int(chunk))
    return _forward(r, k, v, w, u, state, chunk)
