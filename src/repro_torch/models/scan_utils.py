"""Sequence scans for the recurrent layers, and gradient accumulation.

A transcription of ``repro/models/scan_utils.py``.  ``chunked_scan``: the
JAX version splits time into chunks so that ``jax.checkpoint`` bounds the
carries its backward pass keeps; here the scan is one loop over time (the
trainer rematerialises whole blocks instead, ``transformer.forward``).  The
reference's input check stays (there an ``assert``, here a ``ValueError``),
so both packages accept the same sequence lengths.  ``microbatch_scan`` is
the trainer's gradient accumulation over micro-batches.
"""

from __future__ import annotations

from contextlib import nullcontext

import torch

from repro_torch.tree import tree_leaves, tree_map


def check_chunk(S: int, chunk: int) -> None:
    """A scan longer than one chunk must cut into whole chunks."""
    if S > chunk and S % chunk:
        raise ValueError(f"seq {S} not divisible by chunk {chunk}")


def _counted(how: str, *args):
    """The running cost counter's ``repeat(n)`` or ``quiet()``, if one runs."""
    from repro_torch.kernels import ops

    return nullcontext() if ops.COST_HOOK is None else getattr(ops.COST_HOOK, how)(*args)


class _MetaScanFn(torch.autograd.Function):
    """A scan of S steps on ``meta``: one step, forward and backward, counted
    S times by a running cost counter (the backward's recompute of the step
    not at all); ys is that step's y copied S times.
    (Tensors the step closes over get no gradient here; on meta there are
    no values to lose.)"""

    @staticmethod
    def forward(ctx, step_fn, S, init, *x0):
        ctx.step_fn, ctx.S = step_fn, S
        ctx.save_for_backward(init, *x0)
        with _counted("repeat", S):
            carry, y = step_fn(init, x0)
        return carry, y.unsqueeze(0).expand((S,) + tuple(y.shape)).contiguous()

    @staticmethod
    def backward(ctx, dcarry, dys):
        needs = ctx.needs_input_grad[2:]
        inputs = [t.detach().requires_grad_(need) for t, need in zip(ctx.saved_tensors, needs)]
        with torch.enable_grad():
            with _counted("quiet"):  # the recompute only rebuilds the graph
                carry, y = ctx.step_fn(inputs[0], tuple(inputs[1:]))
            pairs = [(o, d) for o, d in ((carry, dcarry), (y, None if dys is None else dys[0]))
                     if d is not None and o.requires_grad]
            wrt = [t for t in inputs if t.requires_grad]
            with _counted("repeat", ctx.S):
                grads = iter(torch.autograd.grad([o for o, _ in pairs], wrt,
                                                 [d for _, d in pairs], allow_unused=True)
                             if pairs and wrt else [None] * len(wrt))
        return (None, None) + tuple(next(grads) if t.requires_grad else None for t in inputs)


def chunked_scan(step_fn, init, xs, chunk: int = 64):
    """Like ``lax.scan(step_fn, init, xs)``: xs is a tuple of (S, ...)
    tensors; returns (final carry, ys stacked (S, ...)).  On ``meta``
    (the dry-run) one step stands for all S (``_MetaScanFn``)."""
    S = xs[0].shape[0]
    check_chunk(S, chunk)
    if xs[0].device.type == "meta" and S > 1:
        return _MetaScanFn.apply(step_fn, S, init, *(x[0] for x in xs))
    carry, ys = init, []
    for t in range(S):
        carry, y = step_fn(carry, tuple(x[t] for x in xs))
        ys.append(y)
    return carry, torch.stack(ys)


def microbatch_scan(grad_fn, params, batch, n_micro: int):
    """Gradient accumulation: split the batch leaves (M, b, ...) into
    ``n_micro`` slices along b and sum (losses, grads) over them.

    grad_fn(params, micro_batch) -> (losses (M,), grads).  Returns the mean
    losses (M,) and mean grads: with ``min(n_micro, b) <= 1`` grad_fn's own
    output (grads in the param dtype); otherwise the grads summed in f32
    and scaled by 1 / n_micro, as the JAX package's scan does."""
    M, b = tree_leaves(batch)[0].shape[:2]
    n_micro = min(n_micro, b)  # dpworkers: per-worker batch may be tiny
    if n_micro <= 1:
        return grad_fn(params, batch)
    if b % n_micro:
        raise ValueError(f"per-worker batch {b} not divisible by {n_micro}")
    bm = b // n_micro
    losses = torch.zeros((M,), dtype=torch.float32, device=tree_leaves(batch)[0].device)
    acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                   params)
    for i in range(n_micro):
        mb = tree_map(lambda a: a[:, i * bm:(i + 1) * bm], batch)
        loss, grads = grad_fn(params, mb)
        losses = losses + loss
        tree_map(lambda a, g: a.add_(g.float()), acc, grads)  # in place: acc is ours
        del grads
    inv = 1.0 / n_micro
    return losses * inv, tree_map(lambda g: g.mul_(inv), acc)
