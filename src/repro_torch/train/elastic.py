"""Elastic scaling: worker join/leave without restarting training.

Membership changes only touch (a) the policy matrix — regenerated by the
Monitor for the new worker set — and (b) replica state — a joiner seeds its
replica by pulling from a live neighbor (gossip IS the state-transfer
mechanism).  The trainer's stacked state changes membership through
``remove_workers`` / ``add_workers``; the simulator engines use the two
reseed forms.  Every row a helper returns is a copy: no leaf aliases
another or its input (the JAX package may alias, its arrays being
immutable; ROADMAP C5).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.policy import generate_policy_matrix
from repro_torch.tree import tree_leaves, tree_map


def remove_workers(params, opt_state, keep: np.ndarray):
    """Drop rows of every stacked leaf. keep: sorted indices of survivors.
    Scalar leaves (AdamW's step count) and leaves with fewer rows than
    ``keep`` are copied as they are."""
    def take(leaf):
        idx = torch.as_tensor(np.asarray(keep), device=leaf.device).long()
        if leaf.ndim > 0 and leaf.shape[0] >= idx.shape[0]:
            return torch.index_select(leaf, 0, idx)
        return leaf.clone()

    return tree_map(take, params), tree_map(take, opt_state)


def add_workers(params, opt_state, n_new: int, seed_from: int = 0):
    """Append n_new replicas copied from worker ``seed_from`` (momentum
    zeroed: a fresh worker has no history)."""
    def grow_p(leaf):
        src = leaf[seed_from:seed_from + 1]
        return torch.cat([leaf] + [src] * n_new, dim=0)

    def grow_o(leaf):
        if leaf.ndim == 0:
            return leaf.clone()
        z = torch.zeros((n_new,) + tuple(leaf.shape[1:]), dtype=leaf.dtype,
                        device=leaf.device)
        return torch.cat([leaf, z], dim=0)

    return tree_map(grow_p, params), tree_map(grow_o, opt_state)


def reseed_row(params, opt_state, worker: int, seed_from: int):
    """Rejoin on the *stacked* representation, in place: worker's row
    becomes a copy of ``seed_from``'s (gossip IS the state transfer),
    momentum zeroed (a fresh worker has no history).  Used by the batched
    simulator engine; returns the (mutated) trees."""
    with torch.no_grad():
        for leaf in tree_leaves(params):
            leaf[worker].copy_(leaf[seed_from])
        for leaf in tree_leaves(opt_state):
            if leaf.ndim > 0:
                leaf[worker].zero_()
    return params, opt_state


def reseed_replica(replicas: list, momenta: list, worker: int,
                   seed_from: int) -> None:
    """Rejoin on the *per-replica* representation (the reference engine):
    same semantics as ``reseed_row``, mutating the lists in place.  The
    seed is cloned, not aliased, so no later in-place update of one
    replica can reach the other."""
    replicas[worker] = tree_map(torch.clone, replicas[seed_from])
    momenta[worker] = tree_map(torch.zeros_like, momenta[worker])


def rescale_policy(alpha: float, T: np.ndarray, K: int = 8, R: int = 8,
                   warm=None):
    """New policy for the new membership (T: M'xM' iteration times).

    ``warm`` threads the previous policy's LP basis (``PolicyResult.basis``)
    into the sweep; when the membership shape changed the solver rejects it
    for free, and when only times changed the re-solve warm-starts from the
    old optimum.
    """
    return generate_policy_matrix(alpha, K, R, T, warm=warm)
