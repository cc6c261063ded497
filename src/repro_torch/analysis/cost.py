"""Cost model: FLOPs, HBM bytes and collective bytes of what one rank runs.

The port's counterpart of ``repro/analysis/hlo.py``.  The JAX module parses
the optimized per-device HLO that XLA compiles; the port emits no HLO, so
``CostCounter`` counts the aten ops one rank dispatches, as they run, with
a ``TorchDispatchMode``.  Eager torch materialises every op that is not a
view, so each op is a materialisation boundary, as a fusion is in the HLO
model:

  * flops: dots by ``torch.utils.flop_counter``'s formulas (``2*out*contract``,
    as ``hlo.py``'s ``_dot_flops``), 1 a reduction's input element and 1 an
    output element of any other op (``hlo.py``'s rule), 0 for views,
    allocations, fills and same-dtype copies (``hlo.py``'s zero-cost and
    view ops);
  * bytes: each op's operands plus its outputs (an expanded operand at the
    size it is stored at, a slice at its own size); a copy reads its source
    and writes its destination, a scatter or gather moves twice its updates
    or its output plus the indices, as ``hlo.py`` counts them;
  * collective bytes by the HLO opcode's name (all-gather, all-reduce,
    reduce-scatter, all-to-all, collective-permute), operand bytes per
    rank: the c10d ops ``torch.distributed`` calls, the functional ones
    DTensor inserts, DTensor's ``shard_dim_alltoall``, and point to point
    (``batch_isend_irecv``), a send counted as a collective-permute of its
    tensor and a receive as its other end (no bytes).

The counter defers to tensor subclasses (``NotImplemented`` for a DTensor),
so a DTensor program is counted as one rank runs it: local ops at local
shapes plus the collectives.  It skips an op with a ``FakeTensor`` input
or output: DTensor's sharding propagation at global shapes, neither work
nor a rank's memory (its allocations take no tensor input).

Kernels (B1-B4 and the two backwards) are counted once a call, by formula
(``KERNEL_WORK``, the bound column of PERF.md §6: each input byte read
once, each output byte written once, and the kernel's operations), through
``kernels.ops.COST_HOOK``; the ops inside a call are not counted, except
collectives.  So a count is the same work whatever implements a kernel: on
the card the extension call is invisible to a dispatch mode, on ``meta``
nothing runs, on the CPU the plain version runs.

Memory: the live bytes of the tensors allocated while the counter runs
(each op's fresh outputs, freed when their tensor is), and their peak, so a
dry-run record can report the JAX record's argument, output and temp sizes;
with the op log on, also which tensors were live at the peak
(``peak_buffers``), the memory's breakdown.

``hlo.py``'s ``unknown_trip_loops`` has no counterpart: eager code runs its
loops, so there is no loop whose trip count could be unknown.  One loop is
not run on ``meta``: ``scan_utils.chunked_scan`` (the mamba scan) runs one
step there, counted as many times as the loop has steps (``repeat``), as
``hlo.py`` scales a while body by its trip count.
"""

from __future__ import annotations

import sys
import weakref
from contextlib import contextmanager
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# -- kernel formulas (PERF.md §6's bound column) ---------------------------------


def causal_pairs(S: int, Sk: int) -> int:
    """Visible (query, key) pairs of a causal call: query s sees keys
    0..min(s, Sk - 1)."""
    if S <= Sk:
        return S * (S + 1) // 2
    return Sk * (Sk + 1) // 2 + (S - Sk) * Sk


def attention_work(B, S, Sk, H, Hk, hd, causal, itemsize):
    """(flops, bytes) of one attention call: 4 * hd flops per visible
    (query head, key) pair -- QK^T and PV, 2 each -- and q, k, v read once,
    the output written once."""
    pairs = causal_pairs(S, Sk) if causal else S * Sk
    flops = 4 * B * H * hd * pairs
    nbytes = (2 * B * S * H + 2 * B * Sk * Hk) * hd * itemsize
    return flops, nbytes


def attention_bwd_work(B, S, Sk, H, Hk, hd, causal, itemsize):
    """(flops, bytes) of one attention backward: five products of 2 * hd
    flops per visible (query head, key) pair (q k^T again, dO v^T, dv, dk,
    dq); q, k, v, o, dO and the f32 lse read once, dq, dk, dv written once."""
    flops, _ = attention_work(B, S, Sk, H, Hk, hd, causal, itemsize)
    flops = flops // 4 * 10
    nbytes = (4 * B * S * H + 4 * B * Sk * Hk) * hd * itemsize + 4 * B * H * S
    return flops, nbytes


def rwkv_work(B, S, H, N, itemsize, w_itemsize, state_in, chunk=64):
    """(flops, bytes) of one WKV call in the kernel's chunk form.  Per
    sub-chunk of c tokens and head: 8 c N elementwise ops (log decay, its
    cumulative sum, two exp, four products) and N exp; c (c - 1) / 2 scores
    and c diagonal terms of 2 N each; y = r_dec S and P v, 2 c N^2 and
    c (c + 1) N; the state update, (2 c + 1) N^2.  Bytes: r, k, v (at
    ``itemsize``) and w (at ``w_itemsize``) read once, y (at ``itemsize``)
    written once, u, the initial state (when given) read and the final state
    written."""
    chunk = min(chunk, S)
    sub = min(16, chunk)
    per_head = 0
    for c0 in range(0, S, chunk):
        c_end = min(c0 + chunk, S)
        for t0 in range(c0, c_end, sub):
            c = min(sub, c_end - t0)
            per_head += (8 * c * N + N + c * (c - 1) * N + 2 * c * N
                         + 2 * c * N * N + c * (c + 1) * N + (2 * c + 1) * N * N)
    flops = B * H * per_head
    nbytes = (B * S * H * N * (4 * itemsize + w_itemsize) + 4 * H * N
              + (2 if state_in else 1) * 4 * B * H * N * N)
    return flops, nbytes


def rwkv_bwd_work(B, S, H, N, itemsize, w_itemsize, state_in, dstate_in=False,
                  dstate0=False):
    """(flops, bytes) of one WKV backward as a reverse recurrence (the
    flops are f32-exact products, which the card does at its 3xTF32 rate,
    as the forward's).  Per token and head 14 N^2 f32 flops -- the state
    recomputed (w S + k v^T, 3), dr's, dk's and dv's products with the state
    or its adjoint (2 each), dw's (2) and the adjoint's update (w G + r
    dy^T, 3) -- and 14 N for v . dy, r . (u k) and the u terms.  Bytes: r,
    k, v, dy (at ``itemsize``) and w (at ``w_itemsize``) read once, dr, dk,
    dv and dw written once at the same widths; u read and du written (f32);
    the initial state and the final-state gradient read when given, the
    initial-state gradient written when asked for."""
    tokens = B * S * H
    flops = tokens * (14 * N * N + 14 * N)
    nbytes = (tokens * N * (7 * itemsize + 2 * w_itemsize) + 2 * 4 * H * N
              + (int(state_in) + int(dstate_in) + int(dstate0)) * 4 * B * H * N * N)
    return flops, nbytes


def mix_work(nbytes, elements, rows, with_u):
    """(flops, bytes) of one gossip-mix call over leaves of ``nbytes`` in
    all (``elements`` elements) with ``rows`` f32 weights: x, pulled (and u)
    read, the output written, the weights read; per element x + u, the two
    products and their sum."""
    k = 4 if with_u else 3
    return k * elements, k * nbytes + 4 * rows


#: Kernel name (as the launch counters name them) -> its formula.
KERNEL_WORK = {
    "flash_attention": attention_work,
    "flash_attention_bwd": attention_bwd_work,
    "rwkv_scan": rwkv_work,
    "rwkv_scan_bwd": rwkv_bwd_work,
    "gossip_mix": mix_work,
    "gossip_mix_rows": mix_work,
}


# -- the report -----------------------------------------------------------------


@dataclass
class OpRecord:
    """One counted op (or kernel call) of the log ``Breakdown`` reads."""

    op: str
    scope: str
    shape: str
    flops: float = 0.0
    bytes: float = 0.0
    collective: str = ""
    collective_bytes: float = 0.0


@dataclass
class CostReport:
    flops: float = 0.0
    bytes_accessed: float = 0.0
    collective_bytes: dict = field(default_factory=dict)  # kind -> bytes
    collective_count: dict = field(default_factory=dict)
    kernel_calls: dict = field(default_factory=dict)  # kernel -> calls
    ops: list = field(default_factory=list)  # OpRecord per counted op

    def scaled(self, k: float) -> "CostReport":
        return CostReport(
            self.flops * k,
            self.bytes_accessed * k,
            {o: b * k for o, b in self.collective_bytes.items()},
            {o: c * k for o, c in self.collective_count.items()},
            {o: c * k for o, c in self.kernel_calls.items()},
            list(self.ops),
        )

    def add(self, other: "CostReport") -> None:
        self.flops += other.flops
        self.bytes_accessed += other.bytes_accessed
        for mine, theirs in ((self.collective_bytes, other.collective_bytes),
                             (self.collective_count, other.collective_count),
                             (self.kernel_calls, other.kernel_calls)):
            for o, b in theirs.items():
                mine[o] = mine.get(o, 0.0) + b
        self.ops.extend(other.ops)


# -- op classes -------------------------------------------------------------------

#: Collective ops (namespace.name) -> HLO kind.
_COLLECTIVE_OPS = {
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.all_gather_into_tensor_out": "all-gather",
    "_c10d_functional.all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.all_reduce_": "all-reduce",
    "_c10d_functional.all_reduce_coalesced": "all-reduce",
    "_c10d_functional.all_reduce_coalesced_": "all-reduce",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional.reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional.all_to_all_single": "all-to-all",
    "_dtensor.shard_dim_alltoall": "all-to-all",
    "c10d.allreduce_": "all-reduce",
    "c10d.allreduce_coalesced_": "all-reduce",
    "c10d.allgather_": "all-gather",
    "c10d._allgather_base_": "all-gather",
    "c10d.allgather_into_tensor_coalesced_": "all-gather",
    "c10d.reduce_scatter_": "reduce-scatter",
    "c10d._reduce_scatter_base_": "reduce-scatter",
    "c10d.reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "c10d.alltoall_": "all-to-all",
    "c10d.alltoall_base_": "all-to-all",
    "c10d.send": "collective-permute",
    "c10d.recv_": "collective-permute",
    "c10d.recv_any_source_": "collective-permute",
}
#: Collective ops whose tensors are what others send here (no bytes of
#: their own); the c10d ops whose first argument is their output (the
#: operand is the second).
_RECEIVES = {"c10d.recv_", "c10d.recv_any_source_"}
_OUTPUT_FIRST = {"c10d.allgather_", "c10d._allgather_base_", "c10d.reduce_scatter_",
                 "c10d._reduce_scatter_base_", "c10d.allgather_into_tensor_coalesced_",
                 "c10d.reduce_scatter_tensor_coalesced_", "c10d.alltoall_",
                 "c10d.alltoall_base_"}

_FREE = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
         "detach", "alias", "lift_fresh", "_local_scalar_dense", "set_", "resize_",
         "record_stream", "wait_tensor", "_wrap_tensor_autograd", "sym_size",
         "sym_stride", "sym_numel", "is_same_size", "_has_compatible_shallow_copy_type",
         "_unsafe_view"}
_FILLS = {"zeros", "zeros_like", "ones", "ones_like", "full", "full_like", "fill_",
          "zero_", "new_zeros", "new_ones", "new_full", "arange", "scalar_tensor",
          "randn", "rand", "randint", "normal_", "uniform_", "eye", "linspace"}
_COPIES = {"copy_", "_to_copy", "clone", "_copy_from", "_copy_from_and_resize"}
_REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "logsumexp", "norm",
               "linalg_vector_norm", "var", "std", "var_mean", "std_mean", "prod",
               "argmax", "argmin", "any", "all", "_softmax", "_log_softmax",
               "cumsum", "cumprod"}
_SCATTERS = {"index_put", "index_put_", "_index_put_impl_", "scatter", "scatter_",
             "scatter_add", "scatter_add_", "scatter_reduce", "scatter_reduce_",
             "index_add", "index_add_", "index_copy", "index_copy_", "masked_scatter_",
             "select_scatter", "slice_scatter"}
_GATHERS = {"index_select", "gather", "embedding", "index", "take"}

_DTYPE_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16",
                torch.float64: "f64", torch.int32: "s32", torch.int64: "s64",
                torch.bool: "pred", torch.int8: "s8", torch.uint8: "u8"}


def stored_elements(t: torch.Tensor) -> int:
    """Elements ``t`` reads from memory: an expanded (stride-0) dim counts
    once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n


def stored_bytes(t: torch.Tensor) -> int:
    return stored_elements(t) * t.element_size()


def _tensors(tree) -> list:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _shape_str(t) -> str:
    if not isinstance(t, torch.Tensor):
        return ""
    dims = ",".join(str(d) for d in t.shape)
    return f"{_DTYPE_NAMES.get(t.dtype, str(t.dtype).replace('torch.', ''))}[{dims}]"


_SCOPE_CACHE: dict = {}


def _frame_name(code) -> str | None:
    name = _SCOPE_CACHE.get(code, False)
    if name is False:
        path = code.co_filename.replace("\\", "/")
        name = None
        if "/repro_torch/" in path and "/repro_torch/analysis/" not in path:
            module = path.rsplit("/", 1)[-1].removesuffix(".py")
            if module not in ("ops", "tree") and not code.co_name.startswith("<"):
                name = f"{module}.{code.co_name}"
        _SCOPE_CACHE[code] = name
    return name


def python_scope(depth: int = 2) -> str:
    """The chain of ``repro_torch`` functions on the Python stack, outermost
    first (``lm.prefill_logits/transformer.forward/...``): the part the JAX
    ``op_name`` metadata plays in ``hlo.py``'s breakdown."""
    names = []
    f = sys._getframe(depth)
    while f is not None:
        name = _frame_name(f.f_code)
        if name is not None and (not names or names[-1] != name):
            names.append(name)
        f = f.f_back
    return "/".join(reversed(names))


# -- the counter ----------------------------------------------------------------


class CostCounter(TorchDispatchMode):
    """Counts what runs inside it, per rank (see the module docstring).

    ``with CostCounter() as cc: ...`` then ``cc.report``; ``cc.peak_bytes``
    is the peak of live bytes allocated inside, ``cc.live_bytes`` what is
    still alive, ``cc.peak_buffers()`` the tensors live at the peak.
    ``log_ops=False`` keeps no per-op log and no allocation log (no
    breakdown)."""

    def __init__(self, log_ops: bool = True):
        super().__init__()
        self.report = CostReport()
        self.log_ops = log_ops
        self.live_bytes = 0
        self.peak_bytes = 0
        # Allocations and frees in order; with the op log, [allocated at,
        # freed at, op, scope, shape, bytes] of each tensor allocated.
        self._seq = 0
        self._peak_seq = 0
        self._allocs: list = []
        self._quiet = 0
        self._times = 1
        self._prev_hook = None
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        self._dtensor = DTensor
        self._fake = FakeTensor

    # -- kernels (kernels.ops.COST_HOOK) --
    def note(self, name: str, **shapes) -> None:
        """One call of kernel ``name`` at these shapes, by its formula."""
        flops, nbytes = KERNEL_WORK[name](**shapes)
        flops, nbytes = flops * self._times, nbytes * self._times
        rep = self.report
        rep.flops += flops
        rep.bytes_accessed += nbytes
        rep.kernel_calls[name] = rep.kernel_calls.get(name, 0) + self._times
        if self.log_ops:
            rep.ops.append(OpRecord(f"kernel.{name}", python_scope(), _kernel_shape(shapes),
                                    flops, nbytes))

    @contextmanager
    def kernel(self, name: str, **shapes):
        """Note one call of ``name``; the ops run inside are not counted
        (collectives are)."""
        self.note(name, **shapes)
        with self.quiet():
            yield

    @contextmanager
    def quiet(self):
        """The ops run inside are not counted (collectives are): a
        recompute that only rebuilds what the backward needs."""
        self._quiet += 1
        try:
            yield
        finally:
            self._quiet -= 1

    @contextmanager
    def repeat(self, n: int):
        """What runs inside counts ``n`` times: one step standing for a
        loop of ``n`` (``scan_utils.chunked_scan`` on ``meta``; ``hlo.py``
        scales a while body by its trip count)."""
        self._times *= n
        try:
            yield
        finally:
            self._times //= n

    def __enter__(self):
        from repro_torch.kernels import ops

        self._prev_hook, ops.COST_HOOK = ops.COST_HOOK, self
        return super().__enter__()

    def __exit__(self, *exc):
        from repro_torch.kernels import ops

        ops.COST_HOOK = self._prev_hook
        return super().__exit__(*exc)

    # -- memory --
    def _alloc(self, t: torch.Tensor, name: str) -> None:
        nbytes = t.untyped_storage().nbytes()
        if not nbytes:
            return
        self.live_bytes += nbytes
        self._seq += 1
        if self.live_bytes > self.peak_bytes:
            self.peak_bytes, self._peak_seq = self.live_bytes, self._seq
        entry = None
        if self.log_ops:
            entry = [self._seq, None, name, python_scope(), _shape_str(t), nbytes]
            self._allocs.append(entry)
        weakref.finalize(t, self._free, nbytes, entry)

    def _free(self, nbytes: int, entry) -> None:
        self.live_bytes -= nbytes
        self._seq += 1
        if entry is not None:
            entry[1] = self._seq

    def peak_buffers(self) -> list:
        """The tensors allocated inside that were live at the peak, one
        ``OpRecord`` each (``bytes`` its storage's), in allocation order;
        empty without the op log."""
        p = self._peak_seq
        return [OpRecord(name, scope, shape, bytes=float(nbytes))
                for at, freed, name, scope, shape, nbytes in self._allocs
                if at <= p and (freed is None or freed > p)]

    # -- ops --
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, self._dtensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        # DTensor's sharding propagation, not work: FakeTensor inputs, or
        # FakeTensor outputs of an op with none (its ``empty_strided`` of a
        # global shape), which are no rank's live bytes either.
        if any(isinstance(t, self._fake) for t in ins + outs):
            return out
        self._count(func, args, kwargs, ins, out, outs)
        return out

    def _count(self, func, args, kwargs, ins, out, outs) -> None:
        name = f"{func.namespace}.{func._opname}"
        aliases = any(r.alias_info is not None for r in func._schema.returns)
        if not aliases and not func.is_view:
            for t in outs:
                self._alloc(t, name)
        kind = _COLLECTIVE_OPS.get(name)
        rep = self.report
        if kind is not None:
            if name in _RECEIVES:
                nbytes, count = 0, 0
            else:
                src = _tensors(args[1:2]) if name in _OUTPUT_FIRST else ins
                nbytes, count = sum(stored_bytes(t) for t in src) * self._times, self._times
            rep.collective_bytes[kind] = rep.collective_bytes.get(kind, 0.0) + nbytes
            rep.collective_count[kind] = rep.collective_count.get(kind, 0.0) + count
            if self.log_ops:
                rep.ops.append(OpRecord(name, python_scope(), _shape_str(outs[0] if outs
                                                                         else None),
                                        collective=kind, collective_bytes=nbytes))
            return
        if self._quiet or func.is_view or func._opname in _FREE:
            return
        flops, nbytes = self._work(func, args, kwargs, ins, outs, out)
        flops, nbytes = flops * self._times, nbytes * self._times
        rep.flops += flops
        rep.bytes_accessed += nbytes
        if self.log_ops and (flops or nbytes):
            rep.ops.append(OpRecord(name, python_scope(), _shape_str(outs[0] if outs else None),
                                    flops, nbytes))

    def _work(self, func, args, kwargs, ins, outs, out):
        op = func._opname
        out_elems = sum(t.numel() for t in outs)
        out_bytes = sum(t.numel() * t.element_size() for t in outs)
        if op in _FILLS:
            return 0.0, out_bytes
        if op in _COPIES:
            src = ins[1] if op in ("copy_", "_copy_from", "_copy_from_and_resize") else ins[0]
            dst = ins[0] if op == "copy_" else outs[0]
            flops = dst.numel() if src.dtype != dst.dtype else 0
            return float(flops), stored_bytes(src) + dst.numel() * dst.element_size()
        from torch.utils.flop_counter import flop_registry

        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            flops = formula(*args, **kwargs, out_val=out)
            return float(flops), sum(stored_bytes(t) for t in ins) + out_bytes
        if op in _SCATTERS:
            moved = sum(stored_bytes(t) for t in ins[1:])
            return float(sum(t.numel() for t in ins[1:2])), 2.0 * moved
        if op in _GATHERS:
            idx = sum(stored_bytes(t) for t in ins if not t.is_floating_point())
            return float(out_elems), 2.0 * out_bytes + idx
        in_bytes = sum(stored_bytes(t) for t in ins)
        if op in _REDUCTIONS:
            return float(ins[0].numel() if ins else out_elems), in_bytes + out_bytes
        return float(out_elems), in_bytes + out_bytes


def _kernel_shape(shapes: dict) -> str:
    keys = [k for k in ("B", "S", "Sk", "H", "Hk", "hd", "N", "rows", "elements")
            if k in shapes]
    return "(" + ",".join(f"{k}={shapes[k]}" for k in keys) + ")"
