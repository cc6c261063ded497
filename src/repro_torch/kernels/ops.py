"""Device dispatchers for the hand-written kernels.

Dispatch is by the tensor's device and nothing else: a CUDA tensor goes to
the hand-written kernel (``kernels/gossip_mix.py``,
``kernels/flash_attention.py``, ``kernels/rwkv_scan.py``), a CPU tensor to
its plain version (``kernels/ref.py``, or the caller's ``plain``), a
``meta`` tensor to the dry-run's route (outputs of the kernel's shapes and
dtypes, nothing computed; differentiable, the gradients as empty), and any
other device raises.  A DTensor (``torch.distributed.tensor``) goes to the
same kernel on its local shards: attention split over heads, the WKV scan
over heads, each where the head count allows it, else replicated
(``_attention_local``, ``_rwkv_local``).  There is no mode switch (the JAX
package's ``use_pallas``) and no fallback: a kernel that fails to build or
launch raises.

``COST_HOOK``: while an ``analysis.cost.CostCounter`` runs, every kernel
call, forward or backward, is noted there once, by the kernel's formula
(``analysis/cost.py``), on every device; the ops inside the call are not
counted as compute.  On the CPU that needs the plain version run inside
the note, backward too (``_PlainKernelFn``, a recompute); without a counter
the CPU runs the plain version as it is.
"""

from __future__ import annotations

from contextlib import nullcontext

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.gossip_mix import gossip_mix, gossip_mix_rows, gossip_mix_rows_tree
from repro_torch.kernels.rwkv_scan import rwkv_scan
from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten

#: The running ``analysis.cost.CostCounter``, or None.
COST_HOOK = None


def _route(x, what) -> str:
    kind = x.device.type
    if kind not in ("cuda", "cpu", "meta"):
        raise ValueError(f"no {what} path for device {x.device}")
    return kind


def _on_cuda(x, what="gossip-mix") -> bool:
    kind = _route(x, what)
    if kind == "meta":
        raise ValueError(f"no {what} path for device meta")
    return kind == "cuda"


def is_dtensor(x) -> bool:
    return hasattr(x, "device_mesh") and hasattr(x, "placements")


def _noted(name, fn, **shapes):
    """``fn()``, noted as one call of kernel ``name`` when a counter runs."""
    hook = COST_HOOK
    if hook is None:
        return fn()
    with hook.kernel(name, **shapes):
        return fn()


def _note_backward(out, name, **shapes):
    """Note kernel ``name``'s backward when ``out``'s gradient arrives (the
    backward kernel runs right after)."""
    hook = COST_HOOK
    if hook is not None and out.requires_grad:
        out.register_hook(lambda g: hook.note(name, **shapes))


class _PlainKernelFn(torch.autograd.Function):
    """A plain version run as one noted kernel call, forward and backward
    (the backward recomputes it under autograd inside the note).  Used on
    the CPU while a counter runs; the values are the plain version's."""

    @staticmethod
    def forward(ctx, fn, names, shapes, *inputs):
        ctx.fn, ctx.names, ctx.shapes = fn, names, shapes
        ctx.save_for_backward(*inputs)
        with COST_HOOK.kernel(names[0], **shapes):
            out = fn(*inputs)
        return out

    @staticmethod
    def backward(ctx, *douts):
        needs = ctx.needs_input_grad[3:]
        inputs = [None if t is None else t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, needs)]
        hook = COST_HOOK
        with torch.enable_grad(), (hook.kernel(ctx.names[1], **ctx.shapes) if hook
                                   else nullcontext()):
            out = ctx.fn(*inputs)
            outs = out if isinstance(out, tuple) else (out,)
            pairs = [(o, d) for o, d in zip(outs, douts) if d is not None and o.requires_grad]
            wrt = [t for t in inputs if t is not None and t.requires_grad]
            grads = iter(torch.autograd.grad([o for o, _ in pairs], wrt,
                                             [d for _, d in pairs], allow_unused=True))
        return (None, None, None) + tuple(
            next(grads) if t is not None and t.requires_grad else None for t in inputs)


def _plain_noted(fn, names, inputs, **shapes):
    """The plain version ``fn(*inputs)``: as it is without a counter, as one
    noted kernel call (forward and backward) with one."""
    if COST_HOOK is None:
        return fn(*inputs)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in inputs):
        return _PlainKernelFn.apply(fn, names, shapes, *inputs)
    with COST_HOOK.kernel(names[0], **shapes):
        return fn(*inputs)


# -- meta: the dry-run's route -------------------------------------------------


class _MetaAttentionFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal):
        B, S, H, _ = q.shape
        ctx.causal = causal
        out = torch.empty_like(q)
        lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, _, _ = ctx.saved_tensors
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v), None


class _MetaRwkvFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, r, k, v, w, u, state):
        B, S, H, N = r.shape
        ctx.save_for_backward(r, k, v, w, u, state)
        return (torch.empty_like(r),
                torch.empty((B, H, N, N), dtype=torch.float32, device=r.device))

    @staticmethod
    def backward(ctx, dy, dstate):
        r, k, v, w, u, state = ctx.saved_tensors
        return (torch.empty_like(r), torch.empty_like(k), torch.empty_like(v),
                torch.empty_like(w), torch.empty_like(u),
                None if state is None else torch.empty_like(state))


# -- attention -------------------------------------------------------------------


def _attention_shapes(q, k, causal):
    B, S, H, hd = q.shape
    return dict(B=B, S=S, Sk=k.shape[1], H=H, Hk=k.shape[2], hd=hd, causal=bool(causal),
                itemsize=q.element_size())


def attention(q, k, v, *, causal=True, plain=None):
    """GQA attention. q: (B,S,H,hd); k/v: (B,Sk,Hk,hd) -> (B,S,H,hd).

    ``plain(q, k, v, causal)``: the CPU's version (default
    ``ref.reference_attention``)."""
    if is_dtensor(q):
        return _attention_local(q, k, v, causal, plain)
    kind = _route(q, "attention")
    shapes = _attention_shapes(q, k, causal)
    if kind == "cuda":
        out = _noted("flash_attention", lambda: flash_attention(q, k, v, causal=causal),
                     **shapes)
        _note_backward(out, "flash_attention_bwd", **shapes)
        return out
    if kind == "meta":
        grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
        fn = ((lambda: _MetaAttentionFn.apply(q, k, v, causal)) if grad
              else (lambda: torch.empty_like(q)))
        out = _noted("flash_attention", fn, **shapes)
        _note_backward(out, "flash_attention_bwd", **shapes)
        return out
    fn = plain or (lambda q, k, v, causal: ref.reference_attention(q, k, v, causal=causal))
    return _plain_noted(lambda q, k, v: fn(q, k, v, causal),
                        ("flash_attention", "flash_attention_bwd"), (q, k, v), **shapes)


def _replicated(t, mesh):
    """A plain tensor beside DTensors: the same on every rank (zeros, an
    initial state), so a replicated DTensor of itself."""
    from torch.distributed.tensor import DTensor, Replicate

    if t is None or is_dtensor(t):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def _attention_local(q, k, v, causal, plain):
    """Attention of DTensors on their local shards.  On each mesh dim: the
    batch stays split where q's is; else the heads split where H and Hk
    divide the dim's size, or where H does and each rank's query heads fall
    in one KV head (k, v replicated, the rank's KV head sliced out, their
    gradient partial); else q, k and v are replicated there."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = q.device_mesh
    k, v = _replicated(k, mesh), _replicated(v, mesh)
    H, Hk = q.shape[2], k.shape[2]
    G = H // Hk
    pq, pkv, kv_slice, kv_grad = [], [], None, []
    for i, n in enumerate(mesh.shape):
        if q.placements[i] == Shard(0) and n > 1:
            pq.append(Shard(0)), pkv.append(Shard(0)), kv_grad.append(Shard(0))
        elif n > 1 and not any(p == Shard(2) for p in pq) and H % n == 0 and Hk % n == 0:
            pq.append(Shard(2)), pkv.append(Shard(2)), kv_grad.append(Shard(2))
        elif (n > 1 and kv_slice is None and not any(p == Shard(2) for p in pq)
              and H % n == 0 and G % (H // n) == 0):
            c = mesh.get_local_rank(i)
            kv_slice = (c * (H // n)) // G
            pq.append(Shard(2)), pkv.append(Replicate()), kv_grad.append(Partial())
        else:
            pq.append(Replicate()), pkv.append(Replicate()), kv_grad.append(Replicate())
    ql = q.redistribute(mesh, pq).to_local()
    kl = k.redistribute(mesh, pkv).to_local(grad_placements=kv_grad)
    vl = v.redistribute(mesh, pkv).to_local(grad_placements=kv_grad)
    if kv_slice is not None:
        kl = kl[:, :, kv_slice:kv_slice + 1].contiguous()
        vl = vl[:, :, kv_slice:kv_slice + 1].contiguous()
    # Contiguous, as the global layout DTensor assumes (the plain versions
    # may return a permuted view).
    out = attention(ql, kl, vl, causal=causal, plain=plain).contiguous()
    B, S, H, hd = q.shape
    return DTensor.from_local(out, mesh, pq, run_check=False, shape=q.shape,
                              stride=(S * H * hd, H * hd, hd, 1))


# -- WKV ------------------------------------------------------------------------


def _rwkv_shapes(r, w, state):
    B, S, H, N = r.shape
    return dict(B=B, S=S, H=H, N=N, itemsize=r.element_size(), w_itemsize=w.element_size(),
                state_in=state is not None)


def rwkv(r, k, v, w, u, *, chunk=64, state=None, plain=None):
    """WKV recurrence. r/k/v/w: (B,S,H,N); u: (H,N) -> y (B,S,H,N), or
    (y, final state (B,H,N,N) f32) when an initial ``state`` is given.

    On CUDA the chunked kernel, on the CPU the sequential recurrence
    (``plain(r, k, v, w, u, state) -> (y, final state)``, default
    ``ref.reference_rwkv_state``); both exact for any decay, as the JAX
    model's scan is (its Pallas kernel clamps the per-step log decay to
    ``>= -75 / min(16, chunk)``).  Both are differentiable: on CUDA through
    the WKV backward kernel (``rwkv_scan.RwkvScanFn``), on the CPU through
    torch's autograd of the recurrence."""
    if is_dtensor(r):
        y, final = _rwkv_local(r, k, v, w, u, chunk, state, plain)
        return y if state is None else (y, final)
    kind = _route(r, "rwkv")
    shapes = _rwkv_shapes(r, w, state)
    if kind == "cuda":
        y, final = _noted("rwkv_scan",
                          lambda: rwkv_scan(r, k, v, w, u, chunk=chunk, state=state), **shapes)
        _note_backward(y, "rwkv_scan_bwd", **shapes)
    elif kind == "meta":
        operands = (r, k, v, w, u) + (() if state is None else (state,))
        if torch.is_grad_enabled() and any(t.requires_grad for t in operands):
            fn = lambda: _MetaRwkvFn.apply(r, k, v, w, u, state)  # noqa: E731
        else:
            B, S, H, N = r.shape
            fn = lambda: (torch.empty_like(r), torch.empty(  # noqa: E731
                (B, H, N, N), dtype=torch.float32, device=r.device))
        y, final = _noted("rwkv_scan", fn, **shapes)
        _note_backward(y, "rwkv_scan_bwd", **shapes)
    else:
        fn = plain or ref.reference_rwkv_state
        y, final = _plain_noted(fn, ("rwkv_scan", "rwkv_scan_bwd"),
                                (r, k, v, w, u, state), **shapes)
    return y if state is None else (y, final)


def _rwkv_local(r, k, v, w, u, chunk, state, plain):
    """The WKV scan of DTensors on their local shards: on each mesh dim the
    batch stays split where r's is (u whole, its gradient partial), else the
    heads split where H divides the dim's size (u and the state split with
    them), else all replicated."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = r.device_mesh
    k, v, w, u, state = (_replicated(t, mesh) for t in (k, v, w, u, state))
    H = r.shape[2]
    p_in, p_u, p_st, du = [], [], [], []
    for i, n in enumerate(mesh.shape):
        if r.placements[i] == Shard(0) and n > 1:
            p_in.append(Shard(0)), p_u.append(Replicate()), p_st.append(Shard(0))
            du.append(Partial())
        elif n > 1 and not any(p == Shard(2) for p in p_in) and H % n == 0:
            p_in.append(Shard(2)), p_u.append(Shard(0)), p_st.append(Shard(1))
            du.append(Shard(0))
        else:
            p_in.append(Replicate()), p_u.append(Replicate()), p_st.append(Replicate())
            du.append(Replicate())
    loc = [t.redistribute(mesh, p_in).to_local() for t in (r, k, v, w)]
    ul = u.redistribute(mesh, p_u).to_local(grad_placements=du)
    if state is None:
        y, final = rwkv(*loc, ul, chunk=chunk, plain=plain), None
    else:
        y, final = rwkv(*loc, ul, chunk=chunk, plain=plain,
                        state=state.redistribute(mesh, p_st).to_local())
    B, S, H, N = r.shape
    # Contiguous, as the global layout DTensor assumes (the plain scan
    # returns a permuted view).
    y = DTensor.from_local(y.contiguous(), mesh, p_in, run_check=False, shape=r.shape,
                           stride=(S * H * N, H * N, N, 1))
    if final is not None:
        final = DTensor.from_local(final, mesh, p_st, run_check=False, shape=(B, H, N, N),
                                   stride=(H * N * N, N * N, N, 1))
    return y, final


# -- gossip mix -------------------------------------------------------------------


def _mix_shapes(xs, rows, with_u):
    return dict(nbytes=sum(x.numel() * x.element_size() for x in xs),
                elements=sum(x.numel() for x in xs), rows=rows, with_u=with_u)


def mix(x, u, pulled, w):
    """out = (1-w)*(x+u) + w*pulled; w scalar (per worker)."""
    shapes = _mix_shapes([x], 1, True)
    if _on_cuda(x):
        return _noted("gossip_mix", lambda: gossip_mix(x, u, pulled, w), **shapes)
    return _noted("gossip_mix", lambda: ref.reference_gossip_mix(x, u, pulled, w), **shapes)


def mix_rows(x, u, pulled, w):
    """Stacked mix with per-row weights (leading worker/cohort axis)."""
    shapes = _mix_shapes([x], x.shape[0], u is not None)
    if _on_cuda(x):
        return _noted("gossip_mix_rows", lambda: gossip_mix_rows(x, u, pulled, w), **shapes)
    return _noted("gossip_mix_rows",
                  lambda: ref.reference_gossip_mix_rows(x, u, pulled, w), **shapes)


def segment_mean_rows(x, seg, num_segments):
    """Replace each row of ``x`` by the mean of the rows sharing its segment.

    ``x`` is (M, ...) stacked replicas, ``seg`` an (M,) int64 segment id per
    row.  Rows alone in their segment pass through exactly (the sum of one
    row, 0 + x, divided by 1.0), as in the JAX package, whose jnp
    ``segment_sum`` this is; it is not a Pallas kernel there, so here it is
    plain torch on any device (``index_add_`` into zeros, then a gather)."""
    shape = (num_segments,) + tuple(x.shape[1:])
    sums = torch.zeros(shape, dtype=x.dtype, device=x.device).index_add_(0, seg, x)
    counts = torch.zeros(num_segments, dtype=x.dtype, device=x.device).index_add_(
        0, seg, torch.ones(x.shape[0], dtype=x.dtype, device=x.device))
    cnt = counts[seg].reshape((-1,) + (1,) * (x.ndim - 1))
    return sums[seg] / cnt


def gossip_mix_tree(x_half, pulled, weights):
    """Tree-level fused mix used by the batched simulator engine (x_half
    already includes the optimizer update, so u = 0):
    out = (1-w_i) x_half + w_i pulled, leaf by leaf, over any tree
    (``tree.py``), returned in the same structure; ``[]`` gives ``[]``.

    The JAX package's ``gossip_mix_tree``, which mixes each leaf with a
    materialised ``u = zeros_like(h)``.  Here u is absent: on CUDA the whole
    tree is one kernel launch (per dtype group of up to
    ``gossip_mix.MAX_LEAVES`` leaves) that reads no u; on the CPU the plain
    version per leaf, with x + 0.0 for x + u.  Noted as one call of B1 over
    the whole tree (the bytes of every leaf)."""
    xs, treedef = tree_flatten(x_half)
    ps = tree_leaves(pulled)
    if len(ps) != len(xs):
        raise ValueError(f"gossip_mix_tree: {len(xs)} leaves of x_half against "
                         f"{len(ps)} of pulled")
    if not xs:
        return tree_unflatten(treedef, [])
    shapes = _mix_shapes(xs, int(weights.shape[0]), False)
    if _on_cuda(xs[0]):
        outs = _noted("gossip_mix_rows",
                      lambda: gossip_mix_rows_tree(xs, None, ps, weights), **shapes)
    else:
        outs = _noted("gossip_mix_rows", lambda: [
            ref.reference_gossip_mix_rows(h, None, p, weights) for h, p in zip(xs, ps)],
            **shapes)
    return tree_unflatten(treedef, outs)
