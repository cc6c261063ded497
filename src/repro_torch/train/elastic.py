"""Elastic scaling: worker join/leave without restarting training.

Membership changes only touch (a) the policy matrix — regenerated by the
Monitor for the new worker set — and (b) replica state — a joiner seeds its
replica by pulling from a live neighbor (gossip IS the state-transfer
mechanism).  The simulator engines use the two reseed forms below; the
trainer-side ``remove_workers`` / ``add_workers`` come with the SPMD trainer
(ROADMAP A5).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.policy import generate_policy_matrix
from repro_torch.tree import tree_leaves, tree_map


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
