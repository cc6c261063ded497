"""Fused NetMax two-step update (gossip mix): the CUDA kernel's wrappers.

    out = (1 - w) * (x + u) + w * pulled        (Alg. 2 lines 11 + 13-15)

The kernel (``csrc/gossip_mix.cu``, CUDA C++ for ``sm_90a``) replaces the
JAX package's Pallas kernels in ``repro/kernels/gossip_mix.py``.  One launch
mixes a whole parameter tree: the wrapper writes a table of the leaves
(pointers, sizes, each leaf's first block), which the kernel takes by value
as a kernel parameter.  Three entry points share it:

* ``gossip_mix_rows_tree`` — a list of stacked (R, ...) leaves sharing the
  per-row weights ``w`` (R,) f32, u given or absent (the batched engine's
  cohort mix: one launch per dtype group of up to ``MAX_LEAVES`` leaves);
* ``gossip_mix_rows``      — one such leaf;
* ``gossip_mix``           — one replica, scalar ``w`` (a one-row leaf).

All take CUDA tensors only and raise on anything else: ``kernels/ops.py``
sends CPU tensors to the plain versions in ``kernels/ref.py``.  Each launch
counts in ``LAUNCHES``: ``gossip_mix`` for the scalar entry point (B2),
``gossip_mix_rows`` for the other two (B1), once per kernel launch.  The
library is built by nvcc on first use (``kernels/build.py``), never at
import.  ``plan`` and ``table_words`` lay out the launches from plain
integers, so the CPU tests reach them without a card.
"""

from __future__ import annotations

import array
import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import build

#: Launch count per entry point; ``reset_launches()`` zeroes them.
LAUNCHES = {"gossip_mix": 0, "gossip_mix_rows": 0}

#: dtype -> (the kernel's code, bytes an element).
_DTYPES = {torch.float32: (0, 4), torch.bfloat16: (1, 2), torch.float16: (2, 2)}

#: Leaves one launch's table holds (the kernel's kMaxLeaves: 64 bytes a leaf
#: within the 4 KB of kernel parameters); a larger tree takes more launches.
MAX_LEAVES = 48
#: Threads a block (the kernel's kThreads).
THREADS = 128
#: 16-byte vectors a thread moves, largest first: a launch takes the largest
#: that still gives every SM ``BLOCKS_PER_SM`` blocks.
UNROLLS = (4, 2, 1)
BLOCKS_PER_SM = 4
_MAX_BLOCKS = 2 ** 31 - 1

_LIB = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib():
    global _LIB
    if _LIB is None:
        lib = build.load("gossip_mix")
        lib.gossip_mix_tree_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_int,  # leaves (8 int64 each), count
            ctypes.c_void_p, ctypes.c_float,  # w, w_scalar
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # dtype, has_u, unroll
            ctypes.c_longlong, ctypes.c_int,  # blocks, device
            ctypes.c_void_p,  # stream
        ]
        lib.gossip_mix_tree_launch.restype = ctypes.c_int
        lib.gossip_mix_tree_limits.argtypes = [ctypes.POINTER(ctypes.c_int)] * 3
        lib.gossip_mix_tree_limits.restype = None
        lib.gossip_mix_error_string.argtypes = [ctypes.c_int]
        lib.gossip_mix_error_string.restype = ctypes.c_char_p
        limits = [ctypes.c_int() for _ in range(3)]
        lib.gossip_mix_tree_limits(*limits)
        got = tuple(v.value for v in limits)
        if got != (MAX_LEAVES, THREADS, 64):
            raise RuntimeError(f"gossip_mix.cu has (leaves, threads, leaf bytes) {got}; "
                               f"the wrapper assumes {(MAX_LEAVES, THREADS, 64)}")
        _LIB = lib
    return _LIB


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@dataclasses.dataclass(frozen=True)
class Group:
    """One launch: which leaves of the tree it mixes and its table's layout."""

    leaves: tuple  # indices into the tree's leaf list, in order
    dtype: torch.dtype
    unroll: int  # 16-byte vectors a thread
    first_block: tuple  # per leaf: its first block (a prefix over the leaves)
    blocks: int  # the grid

    @property
    def chunk(self) -> int:
        """Elements one block covers."""
        return THREADS * self.unroll * (16 // _DTYPES[self.dtype][1])


@functools.lru_cache(maxsize=256)
def plan(dtypes: tuple, sizes: tuple, sm_count: int) -> tuple:
    """Lay out the launches for a tree of leaves with these dtypes and
    element counts: one group per dtype (in order of first appearance),
    split every ``MAX_LEAVES`` leaves; empty leaves are left out.  Each group
    takes the largest unroll that gives at least ``BLOCKS_PER_SM *
    sm_count`` blocks (the smallest when none does)."""
    by_dtype: dict = {}
    for i, (dt, size) in enumerate(zip(dtypes, sizes)):
        if dt not in _DTYPES:
            raise TypeError(f"leaf {i} has dtype {dt}; the kernel takes float32, "
                            "bfloat16 or float16")
        if size > 0:
            by_dtype.setdefault(dt, []).append(i)
    groups = []
    for dt, idx in by_dtype.items():
        vec = 16 // _DTYPES[dt][1]
        for k in range(0, len(idx), MAX_LEAVES):
            part = idx[k:k + MAX_LEAVES]
            for unroll in UNROLLS:
                chunk = THREADS * unroll * vec
                counts = [-(-sizes[i] // chunk) for i in part]
                if sum(counts) >= BLOCKS_PER_SM * sm_count:
                    break
            first = [0]
            for c in counts[:-1]:
                first.append(first[-1] + c)
            blocks = first[-1] + counts[-1]
            if blocks > _MAX_BLOCKS:
                raise ValueError(f"gossip mix: {blocks} blocks exceed the grid")
            groups.append(Group(tuple(part), dt, unroll, tuple(first), blocks))
    return tuple(groups)


def row_magic(n: int, chunk: int) -> int:
    """ceil(2^32 / n) when 2 <= n <= chunk, else 0: the kernel finds the row
    of an offset x < 2 * chunk inside a block's chunk as (x * magic) >> 32."""
    return (2 ** 32 - 1) // n + 1 if 2 <= n <= chunk else 0


def table_words(group: Group, x_ptrs, u_ptrs, p_ptrs, out_ptrs, sizes, ns) -> list:
    """The group's leaf table as the kernel reads it: per leaf eight unsigned
    64-bit words (x, u, p, out, R * n, n, first block, vector flag | row
    magic << 32).  ``u_ptrs`` None writes u = 0 (the kernel reads no u); the
    flag is 1 when all four bases lie on 16-byte boundaries."""
    words = []
    chunk = group.chunk
    for i, first in zip(group.leaves, group.first_block):
        x, p, out = x_ptrs[i], p_ptrs[i], out_ptrs[i]
        u = 0 if u_ptrs is None else u_ptrs[i]
        vec = int((x | u | p | out) % 16 == 0)
        words += [x, u, p, out, sizes[i], ns[i], first, vec | row_magic(ns[i], chunk) << 32]
    return words


def _check_leaves(fn: str, xs, us, pulleds, rows: bool):
    """Check every leaf's operands; returns their CUDA device.  The layout
    (type, dtype, contiguity, shapes and, with ``rows``, one leading row
    count shared by every leaf) is checked before the device.  One boolean
    a leaf on the way through (this runs once a cohort); the messages are
    worked out only when it fails."""
    if len(xs) == 0:
        raise ValueError(f"{fn}: the tree has no leaves")
    if len(pulleds) != len(xs) or (us is not None and len(us) != len(xs)):
        raise ValueError(f"{fn}: x, u and pulled hold different numbers of leaves")
    T = torch.Tensor
    for i, (x, p) in enumerate(zip(xs, pulleds)):
        u = None if us is None else us[i]
        if not (isinstance(x, T) and x.dtype in _DTYPES and x.is_contiguous()
                and isinstance(p, T) and p.dtype == x.dtype and p.shape == x.shape
                and p.is_contiguous()
                and (u is None or (isinstance(u, T) and u.dtype == x.dtype
                                   and u.shape == x.shape and u.is_contiguous()))):
            _layout_error(fn, i, (("x", x), ("pulled", p)) + (() if u is None else
                                                               (("u", u),)))
    if rows:
        if any(x.ndim < 1 for x in xs):
            raise ValueError(f"{fn}: every leaf needs a leading row axis")
        if any(x.shape[0] != xs[0].shape[0] for x in xs):
            raise ValueError(f"{fn}: leaves have different row counts: "
                             f"{[x.shape[0] for x in xs]}")
    dev = xs[0].device
    for name, ts in (("x", xs), ("pulled", pulleds)) + (() if us is None else (("u", us),)):
        for i, t in enumerate(ts):
            if not (t.is_cuda and t.device == dev):
                if not t.is_cuda:
                    raise ValueError(
                        f"{fn}: leaf {i} {name} must be a CUDA tensor (got {t.device}); "
                        "kernels/ops.py routes CPU tensors to the plain version")
                raise ValueError(f"{fn}: operands lie on different devices "
                                 f"({dev}, {t.device})")
    return dev


def _layout_error(fn: str, i: int, named) -> None:
    """Raise the first layout fault of leaf ``i``'s (name, operand) pairs."""
    x = named[0][1]
    for name, t in named:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{fn}: leaf {i} {name} is a {type(t).__name__}, not a tensor")
        if t.dtype not in _DTYPES:
            raise TypeError(f"{fn}: leaf {i} {name} has dtype {t.dtype}; the kernel "
                            "takes float32, bfloat16 or float16")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: leaf {i} {name} must be contiguous")
        if t.shape != x.shape:
            raise ValueError(f"{fn}: leaf {i} shapes differ: x {tuple(x.shape)}, "
                             f"{name} {tuple(t.shape)}")
        if t.dtype != x.dtype:
            raise TypeError(f"{fn}: leaf {i} dtypes differ: x {x.dtype}, {name} {t.dtype}")


def _check_row_weights(fn: str, w, R: int, dev) -> None:
    if (not isinstance(w, torch.Tensor) or w.device != dev
            or w.dtype != torch.float32 or tuple(w.shape) != (R,)
            or not w.is_contiguous()):
        raise ValueError(
            f"{fn}: w must be a contiguous float32 ({R},) tensor on {dev}, got "
            f"{getattr(w, 'dtype', type(w))} {tuple(getattr(w, 'shape', ()))} on "
            f"{getattr(w, 'device', None)}")


def _launch(key: str, xs, us, pulleds, w, w_scalar: float, ns, dev):
    """Mix the leaves in as few launches as ``plan`` allows."""
    sizes = [x.numel() for x in xs]
    groups = plan(tuple(x.dtype for x in xs), tuple(sizes), _sm_count(dev.index))
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    outs = [torch.empty_like(x) for x in xs]
    x_ptrs = [x.data_ptr() for x in xs]
    u_ptrs = None if us is None else [u.data_ptr() for u in us]
    p_ptrs = [p.data_ptr() for p in pulleds]
    o_ptrs = [o.data_ptr() for o in outs]
    w_ptr = None if w is None else w.data_ptr()
    for g in groups:
        table = array.array("Q", table_words(g, x_ptrs, u_ptrs, p_ptrs, o_ptrs, sizes, ns))
        err = lib.gossip_mix_tree_launch(
            table.buffer_info()[0], len(g.leaves), w_ptr, w_scalar, _DTYPES[g.dtype][0],
            int(us is not None), g.unroll, g.blocks, dev.index, stream)
        if err != 0:
            msg = lib.gossip_mix_error_string(err).decode()
            raise RuntimeError(f"{key}: kernel launch failed: CUDA error {err} ({msg})")
        LAUNCHES[key] += 1
    return outs


def gossip_mix_rows_tree(xs, us, pulleds, w):
    """Per-row fused mix of every leaf of a tree on CUDA:
    out_i[r] = (1-w[r])*(x_i[r]+u_i[r]) + w[r]*pulled_i[r].

    xs/us/pulleds: lists of (R, ...) contiguous leaves, leaf by leaf the
    same shape and dtype (the leaves may differ); ``us`` None means u = 0
    and the kernel reads no u.  w: (R,) float32 on the leaves' device.
    One launch per dtype group of up to ``MAX_LEAVES`` leaves; returns the
    outputs in the leaves' order."""
    fn = "gossip_mix_rows_tree"
    dev = _check_leaves(fn, xs, us, pulleds, rows=True)
    R = xs[0].shape[0]
    _check_row_weights(fn, w, R, dev)
    ns = [x.numel() // R if R else 0 for x in xs]
    return _launch("gossip_mix_rows", xs, us, pulleds, w, 0.0, ns, dev)


def gossip_mix_rows(x, u, pulled, w):
    """Per-row fused mix on CUDA: out[r] = (1-w[r])*(x[r]+u[r]) + w[r]*pulled[r].

    x/u/pulled: (R, ...) contiguous, same shape and dtype (u None: u = 0);
    w: (R,) float32 on the same device.  The one-leaf tree."""
    return gossip_mix_rows_tree([x], None if u is None else [u], [pulled], w)[0]


def gossip_mix(x, u, pulled, w):
    """out = (1-w)*(x+u) + w*pulled elementwise on CUDA; ``w`` is a Python
    number or a one-element tensor (f32 math, cast back to x's dtype).  The
    one-row, one-leaf tree."""
    fn = "gossip_mix"
    dev = _check_leaves(fn, [x], [u], [pulled], rows=False)
    w_t = None
    if isinstance(w, torch.Tensor):
        if w.numel() != 1:
            raise ValueError(f"{fn}: w must be a scalar, got shape {tuple(w.shape)}")
        if w.device.type == "cuda":
            if w.device != dev or w.dtype != torch.float32:
                raise ValueError(f"{fn}: a CUDA w must be float32 on x's device")
            w_t = w
        else:
            w = float(w)
    w_scalar = 0.0 if w_t is not None else float(w)
    return _launch(fn, [x], [u], [pulled], w_t, w_scalar, [x.numel()], dev)[0]
