"""GQA flash attention and its gradient: the CUDA kernels' wrappers.

    out = softmax(q k^T / sqrt(hd), causal mask) v        (per query head)

The kernel (``csrc/flash_attention.cu``, CUDA C++ for ``sm_90a``) replaces
the JAX package's Pallas kernel ``repro/kernels/flash_attention.py``.  One
block serves all G = H / Hk query heads of one KV head for tiles of 64
folded (position, group member) rows, so every K/V tile is read once; a
causal block stops at the last key its positions can see.  It has two
bodies, picked by dtype (``BODIES``; the C entry reports the one it ran).
bf16, the serving and training path, is Hopper's own route
(``csrc/hopper_wgmma.cuh``): ``wgmma`` products on tiles that TMA loads
into shared memory under mbarriers, a producer warp keeping a ring of
K/V tiles full for two consumer warpgroups of 64 folded rows each.  TMA
loads a folded tile as one box of a 5-D view (hd, G, Hk, S, B) of q: P =
64 // G whole positions of all G heads, so for G = 5 or 7 a tile holds 60
or 63 real rows and padding that no box fills or stores
(``wgmma_plan``).  f32 (whisper's encoder and cross-attention, whose f32
frames JAX promotes) is FlashAttention-2 on ``mma.sync`` TF32 in 3xTF32 --
each operand split into a TF32 big part and its remainder, big * big +
big * small + small * big in f32 -- which holds the f32 tolerance that one
TF32 product does not, its K/V tiles double-buffered by ``cp.async``.  Both
keep f32 softmax statistics, masked scores at -1e30 and the row-sum floor
of the reference.  Where the f32 body's row tiles leave the grid below one
wave (whisper's 64 decoder positions against 1500 frames), ``dq_splits``
cuts each block's key walk into ranges whose f32 partials (output, running
max and sum) a merge kernel combines in range order (``FWD_LAUNCHED``).

The Pallas kernel is forward only; here the gradient is a kernel too
(``csrc/flash_attention_bwd.cu``, the FlashAttention-2 split: a row-dot
pass, per-query-head dK/dV shares summed per KV head in f32, and a dQ
kernel; four launches a call, deterministic, no atomics).  Its bodies
(``BWD_LAUNCHED``) all run on the tensor cores: bf16 on ``wgmma`` fed by
TMA at every head dim (dK/dV: one consumer warpgroup of 64 keys, the query
rows of one head streamed in a TMA ring; dQ: one consumer warpgroup of 64
folded rows in the forward's padded boxes, K/V streamed), f32 on
``mma.sync`` TF32 in 3xTF32 (4 warps at hd 32 and 64, 8 at hd 128 and
160).  Where a short query sequence leaves the dQ kernel's grid below one
wave, ``dq_splits`` cuts its key walk into ranges whose f32 partials the
last kernel sums in order.  Under autograd (grad enabled and an operand
that requires grad) ``flash_attention`` goes through ``FlashAttentionFn``:
its forward launches the forward kernel with a log-sum-exp output and
saves q, k, v, the output and the LSE, its backward launches the backward
kernels.  Otherwise (``no_grad``, serving) it launches the forward kernel
alone, without the LSE.

Takes CUDA tensors only and raises on anything else: ``kernels/ops.py``
sends CPU tensors to ``ref.reference_attention``, the plain version the
CPU tests hold against the JAX package; the kernels run only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).  The wrappers count
their launches in ``LAUNCHES`` (raised only where a kernel is launched; a
call counts once, whatever kernels it launches), and the forward's in
``BODY_LAUNCHES`` by the body its C entry reports.  The libraries are
built by nvcc on first use (``kernels/build.py``), never at import.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

#: Launch counts of the forward and the backward; ``reset_launches()`` zeroes them.
LAUNCHES = {"flash_attention": 0, "flash_attention_bwd": 0}

#: The forward body each dtype runs, as the C entry names it
#: (``flash_attention_body_name``): ``flash_fwd_bf16_wgmma_kernel`` (wgmma
#: and TMA) and ``flash_fwd_tf32x3_mma_kernel`` (3xTF32 on mma.sync).
BODIES = {torch.bfloat16: "bf16_wgmma", torch.float32: "tf32x3_mma"}

#: The forward's launches by the body its C entry reports.
BODY_LAUNCHES = {"bf16_wgmma": 0, "tf32x3_mma": 0}

#: What the last forward call launched, as its C entry reported it: the body,
#: the key ranges of its grid (above 1, the merge kernel followed) and its
#: grid's row tiles and (batch, KV head) blocks.
FWD_LAUNCHED = {"body": None, "key_splits": None, "grid": None}

#: Head dims the kernel is instantiated for (the test cases' 32, 64 and 128;
#: tinyllama, qwen1.5 and starcoder2 use 64 or 128, stablelm-12b 160).
HEAD_DIMS = (32, 64, 128, 160)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_Y = 65535

#: Kernels one backward call launches (row dot, per-head dK/dV shares, dQ,
#: and the sum of each KV head's dK/dV shares and of dQ's partials).
BWD_KERNELS_PER_CALL = 4

#: What the last backward call launched, as its C entry reported it: the
#: body of its dK/dV and dQ kernels (``flash_attention_bwd_body_name``:
#: ``wgmma`` for bf16 at every head dim, ``tf32x3_mma`` / ``tf32x3_wide_mma``
#: for f32 at hd <= 64 / above), the key ranges of its dQ grid, and the
#: dK/dV and dQ grids.
BWD_LAUNCHED = {"body": None, "dq_splits": None, "dkdv_grid": None, "dq_grid": None}

#: Rows of a dQ (and f32 forward) block, and keys of every f32 body's key
#: tile: the units of ``dq_splits``.
DQ_ROW_TILE = 64
DQ_KEY_TILE = 64

#: The fewest 64-key tiles a key range of a split walk holds.
DQ_MIN_RANGE_TILES = 2

#: The bf16 (wgmma) bodies' tiles that fix their grids: folded rows a
#: consumer warpgroup (one TMA box of P = 64 // G positions x G heads), the
#: forward's consumer warpgroups a block and the keys of a dK/dV block (one
#: consumer warpgroup).  The C structs ``FwdTile`` and ``DkdvTile`` hold
#: them; the C entries report the grids they launched.
WGMMA_ROWS = 64
FWD_CONSUMERS = 2
DKDV_KEYS = 64


def wgmma_plan(B: int, S: int, Sk: int, H: int, Hk: int, hd: int) -> dict:
    """The bf16 bodies' boxes and grids, as their C entries compute them.

    ``positions`` P = 64 // G per folded tile, ``rows`` P * G real rows of
    its 64, ``padding`` the rest (no box fills or stores them); the
    forward's grid (row tiles of ``FWD_CONSUMERS`` * P positions, B * Hk),
    the dK/dV grid (key tiles of ``DKDV_KEYS``, B * Hk, G)
    and the dQ grid's row tiles and blocks (ceil(S / P), B * Hk), before its
    key ranges."""
    G = H // Hk
    P = WGMMA_ROWS // G
    return {"positions": P, "rows": P * G, "padding": WGMMA_ROWS - P * G,
            "fwd_grid": (-(-S // (FWD_CONSUMERS * P)), B * Hk),
            "dkdv_grid": (-(-Sk // DKDV_KEYS), B * Hk, G),
            "dq_grid": (-(-S // P), B * Hk)}


_LIB = None
_BWD_LIB = None


def dq_splits(B: int, S: int, Sk: int, H: int, Hk: int, sms: int,
              row_tiles: int | None = None) -> int:
    """Key ranges the dQ kernel's walk, and the f32 forward's, is cut into:
    1 where its ``row_tiles * B * Hk`` blocks (by default ``ceil(S * G /
    64)`` row tiles, the f32 bodies'; the bf16 dQ body's are ``wgmma_plan``'s
    ``ceil(S / P)``) already fill the card's ``sms`` SMs (each block then
    walks all its keys and writes its rows itself), else enough to reach
    about one wave, with no range shorter than ``DQ_MIN_RANGE_TILES`` key
    tiles of 64."""
    if row_tiles is None:
        row_tiles = -(-S * (H // Hk) // DQ_ROW_TILE)
    blocks = row_tiles * B * Hk
    if blocks >= sms:
        return 1
    most = -(-Sk // DQ_KEY_TILE) // DQ_MIN_RANGE_TILES
    return max(1, min(-(-sms // blocks), most))


def backward_dq_splits(dtype, B: int, S: int, Sk: int, H: int, Hk: int, hd: int,
                       sms: int) -> int:
    """``dq_splits`` on the row tiles of the body ``dtype`` runs."""
    tiles = (wgmma_plan(B, S, Sk, H, Hk, hd)["dq_grid"][0] if dtype == torch.bfloat16
             else None)
    return dq_splits(B, S, Sk, H, Hk, sms, row_tiles=tiles)


def forward_key_splits(dtype, B: int, S: int, Sk: int, H: int, Hk: int, sms: int) -> int:
    """Key ranges of the forward's walk: ``dq_splits`` for the f32 body, 1
    for bf16 (its body walks whole)."""
    return dq_splits(B, S, Sk, H, Hk, sms) if dtype == torch.float32 else 1


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
            ctypes.c_void_p, ctypes.c_void_p,  # out, lse (or NULL)
            ctypes.c_void_p, ctypes.c_void_p,  # the ranges' partials (scratch, or NULL)
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, S, Sk
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # H, Hk, hd
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # dtype, causal, key ranges
            ctypes.c_void_p,  # launched: int[4], written by the call
            ctypes.c_int, ctypes.c_void_p,  # device, stream
        ]
        lib.flash_attention_launch.restype = ctypes.c_int
        for fn in (lib.flash_attention_error_string, lib.flash_attention_body_name):
            fn.argtypes = [ctypes.c_int]
            fn.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _bwd_lib():
    global _BWD_LIB
    if _BWD_LIB is None:
        lib = build.load("flash_attention_bwd")
        lib.flash_attention_bwd_launch.argtypes = [
            *[ctypes.c_void_p] * 5,  # q, k, v, o, dout
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # lse, D, shares (scratch)
            ctypes.c_void_p,  # dq's partials (scratch, or NULL)
            *[ctypes.c_void_p] * 3,  # dq, dk, dv
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, S, Sk
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # H, Hk, hd
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # dtype, causal, dq_splits
            ctypes.c_void_p,  # launched: int[7], written by the call
            ctypes.c_int, ctypes.c_void_p,  # device, stream
        ]
        lib.flash_attention_bwd_launch.restype = ctypes.c_int
        for fn in (lib.flash_attention_bwd_error_string, lib.flash_attention_bwd_body_name):
            fn.argtypes = [ctypes.c_int]
            fn.restype = ctypes.c_char_p
        _BWD_LIB = lib
    return _BWD_LIB


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
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must start on a 16-byte boundary "
                             "(TMA's rule for a tensor's base, and the f32 bodies copy "
                             "16-byte chunks)")
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
    if q.dtype == torch.bfloat16 and H // Hk > WGMMA_ROWS:
        raise ValueError(f"flash_attention: {H // Hk} query heads a KV head; the bf16 body "
                         f"folds at most {WGMMA_ROWS} into a tile")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} is not one of {HEAD_DIMS}")
    if B * Hk > _MAX_GRID_Y:
        raise ValueError(f"flash_attention: B * Hk = {B * Hk} exceeds {_MAX_GRID_Y}")


def _forward(q, k, v, causal: bool, with_lse: bool, key_splits: int | None = None):
    """Launch the forward kernel -> (out, lse (B, H, S) f32 or None).  The
    f32 body's key walk is cut into ``key_splits`` ranges (by default
    ``forward_key_splits`` on this card's SM count), their partials
    allocated here."""
    B, S, H, hd = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
           if with_lse else None)
    splits = key_splits
    if splits is None:
        sms = torch.cuda.get_device_properties(q.device).multi_processor_count
        splits = forward_key_splits(q.dtype, B, S, Sk, H, Hk, sms)
    o_part = stat_part = None
    if splits > 1:
        o_part = torch.empty((splits, B * S * H * hd), dtype=torch.float32, device=q.device)
        stat_part = torch.empty((2, splits, B * H * S), dtype=torch.float32, device=q.device)
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    launched = (ctypes.c_int * 4)()
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        None if o_part is None else o_part.data_ptr(),
        None if stat_part is None else stat_part.data_ptr(),
        B, S, Sk, H, Hk, hd, _DTYPE_CODE[q.dtype], int(bool(causal)), splits,
        ctypes.addressof(launched), q.device.index, stream,
    )
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention: kernel launch failed: CUDA error {err} "
                           f"({msg})")
    body = lib.flash_attention_body_name(launched[0]).decode()
    LAUNCHES["flash_attention"] += 1
    BODY_LAUNCHES[body] += 1
    FWD_LAUNCHED.update(body=body, key_splits=launched[1], grid=(launched[2], launched[3]))
    return out, lse


def flash_attention_backward(q, k, v, out, dout, lse, *, causal: bool = True):
    """The backward kernels -> (dq, dk, dv) in q's dtype.

    q/out/dout: (B,S,H,hd); k/v: (B,Sk,Hk,hd); lse: the forward's (B,H,S)
    f32 log-sum-exp.  f32 math; dk and dv sum over their KV head's G query
    heads in f32 before the one cast, and dq over its key ranges
    (``backward_dq_splits`` on this card's SM count) in range order."""
    _check_operands(q, k, v)
    for name, t in (("out", out), ("dout", dout)):
        if (t.device != q.device or t.dtype != q.dtype or t.shape != q.shape
                or not t.is_contiguous()):
            raise ValueError(f"flash_attention_backward: {name} must be a contiguous "
                             f"{q.dtype} tensor of q's shape {tuple(q.shape)} on "
                             f"{q.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention_backward: {name} must start on a 16-byte "
                             "boundary (TMA's rule for a tensor's base)")
    B, S, H, hd = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    if (lse.device != q.device or lse.dtype != torch.float32
            or lse.shape != (B, H, S) or not lse.is_contiguous()):
        raise ValueError(f"flash_attention_backward: lse must be a contiguous float32 "
                         f"({B}, {H}, {S}) tensor on {q.device}")
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    D = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    shares = torch.empty((2, H, B * Sk * hd), dtype=torch.float32, device=q.device)
    splits = backward_dq_splits(q.dtype, B, S, Sk, H, Hk, hd,
                                torch.cuda.get_device_properties(q.device).multi_processor_count)
    dq_part = (torch.empty((splits, B * S * H * hd), dtype=torch.float32, device=q.device)
               if splits > 1 else None)
    lib = _bwd_lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    launched = (ctypes.c_int * 7)()
    err = lib.flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), D.data_ptr(), shares.data_ptr(),
        None if dq_part is None else dq_part.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(),
        B, S, Sk, H, Hk, hd, _DTYPE_CODE[q.dtype], int(bool(causal)), splits,
        ctypes.addressof(launched), q.device.index, stream,
    )
    if err != 0:
        msg = lib.flash_attention_bwd_error_string(err).decode()
        raise RuntimeError(f"flash_attention_backward: kernel launch failed: CUDA error "
                           f"{err} ({msg})")
    LAUNCHES["flash_attention_bwd"] += 1
    BWD_LAUNCHED.update(body=lib.flash_attention_bwd_body_name(launched[0]).decode(),
                        dq_splits=launched[1], dkdv_grid=tuple(launched[2:5]),
                        dq_grid=tuple(launched[5:7]))
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention with its gradient: the forward kernel (with LSE) on
    the way forward, the backward kernels on the way back."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = _forward(q, k, v, causal, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, out, dout.contiguous(), lse,
                                              causal=ctx.causal)
        return dq, dk, dv, None


def flash_attention(q, k, v, *, causal: bool = True):
    """GQA attention on CUDA. q: (B,S,H,hd); k/v: (B,Sk,Hk,hd) -> (B,S,H,hd).

    f32 or bf16, contiguous, 16-byte aligned, H % Hk == 0 (at most 64 query
    heads a KV head for bf16), hd in ``HEAD_DIMS``; f32 softmax and
    accumulation (bf16 products on ``wgmma`` for bf16, 3xTF32 ones on
    ``mma.sync`` for f32), the output in q's dtype.  Causal positions align
    from 0 for any S and Sk.  Under autograd it is differentiable through
    the backward kernels."""
    _check_operands(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, bool(causal))
    return _forward(q, k, v, causal, with_lse=False)[0]
