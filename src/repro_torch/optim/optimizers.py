"""Optimizers: SGD with momentum and weight decay, AdamW.

A transcription of ``repro/optim/optimizers.py``: functional
``(init, update)`` pairs over parameter trees (``tree.py``), where
``update`` returns *updates* (deltas) and ``Optimizer.apply`` adds them, so
the trainer controls the order (NetMax mixes after the local step).  States
are f32 trees shaped like the parameters (stacked replicas keep their own
momenta on the leading axis); AdamW's step count ``t`` is an int32 scalar.
Nothing updates in place: each call returns new tensors, as the JAX
functions do.  Callers run these outside autograd (the trainer does, under
``torch.no_grad()``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten


@dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable  # (grads, state, params, lr) -> (updates, state)

    def apply(self, params, updates):
        """params + updates, added in f32 and cast back to the param dtype."""
        return tree_map(lambda p, u: (p.float() + u.float()).to(p.dtype), params, updates)


def _zeros_f32(p):
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def sgd(momentum: float = 0.9, weight_decay: float = 0.0, nesterov: bool = False) -> Optimizer:
    """Paper §V config: SGD, momentum 0.9, weight decay 1e-4."""

    def init(params):
        if momentum == 0.0:
            return {}
        return {"m": tree_map(_zeros_f32, params)}

    def one(g, p, m, lr):
        g = g.float()
        if weight_decay:
            g = g + weight_decay * p.float()
        if m is None:
            return -lr * g, None
        m_new = momentum * m + g
        step = g + momentum * m_new if nesterov else m_new
        return -lr * step, m_new

    def update(grads, state, params, lr):
        if momentum == 0.0:
            return tree_map(lambda g, p: one(g, p, None, lr)[0], grads, params), state
        gs, treedef = tree_flatten(grads)
        out = [one(g, p, m, lr) for g, p, m in
               zip(gs, tree_leaves(params), tree_leaves(state["m"]))]
        return (tree_unflatten(treedef, [o[0] for o in out]),
                {"m": tree_unflatten(treedef, [o[1] for o in out])})

    return Optimizer(init, update)


def adamw(
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
) -> Optimizer:
    def init(params):
        leaves = tree_leaves(params)
        dev = leaves[0].device if leaves else None
        return {
            "m": tree_map(_zeros_f32, params),
            "v": tree_map(_zeros_f32, params),
            "t": torch.zeros((), dtype=torch.int32, device=dev),
        }

    def update(grads, state, params, lr):
        t = state["t"] + 1
        tf = t.float()
        c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=t.device), tf)
        c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=t.device), tf)

        def one(g, p, m, v):
            g = g.float()
            m_new = b1 * m + (1 - b1) * g
            v_new = b2 * v + (1 - b2) * g * g
            step = (m_new / c1) / (torch.sqrt(v_new / c2) + eps)
            if weight_decay:
                step = step + weight_decay * p.float()
            return -lr * step, m_new, v_new

        gs, treedef = tree_flatten(grads)
        out = [one(g, p, m, v) for g, p, m, v in
               zip(gs, tree_leaves(params), tree_leaves(state["m"]), tree_leaves(state["v"]))]
        pick = lambda i: tree_unflatten(treedef, [o[i] for o in out])  # noqa: E731
        return pick(0), {"m": pick(1), "v": pick(2), "t": t}

    return Optimizer(init, update)


def global_norm(tree, reduce=None, split=None) -> torch.Tensor:
    """sqrt of the sum over leaves (in tree order) of each leaf's f32 sum of
    squares.  ``reduce`` sums that f32 total across ranks (in place) when a
    tree holds one rank's rows of stacked leaves
    (``dist.sharding.WorkerShard.sum``).  ``split``: (one flag a leaf, fn)
    when flagged leaves hold one rank's slice of a tensor-parallel leaf:
    their squares are summed across that group by ``fn`` first (the others
    are whole on every rank of it)."""
    leaves = tree_leaves(tree)
    if split is None:
        sq = sum(torch.sum(leaf.float() ** 2) for leaf in leaves)
    else:
        flags, split_sum = split
        parts = [torch.sum(leaf.float() ** 2) for leaf in leaves]
        sliced = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        for part, flag in zip(parts, flags):
            if flag:
                sliced = sliced + part
        sq = split_sum(sliced)
        for part, flag in zip(parts, flags):
            if not flag:
                sq = sq + part
    if reduce is not None:
        sq = reduce(sq)
    return torch.sqrt(sq)


def clip_by_global_norm(grads, max_norm: float, reduce=None, split=None):
    """(grads scaled by min(1, max_norm / norm), the norm); ``reduce`` and
    ``split`` as in ``global_norm``."""
    n = global_norm(grads, reduce, split)
    scale = torch.clamp(max_norm / torch.clamp(n, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), n
