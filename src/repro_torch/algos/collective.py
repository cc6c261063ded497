"""Synchronous collective strategies: Allreduce-SGD and Prague.

  allreduce  all workers step together; ring allreduce bottlenecked by the
             slowest link in the ring (paper §V baselines)
  prague     random groups of g workers partial-allreduce per iteration;
             concurrent groups contend for shared links (paper §V-B)

Host-side selection and timing are the JAX package's, verbatim, so groups
and round times are bit-identical to it; the grad reductions are torch.
"""

from __future__ import annotations

import torch

from repro_torch.algos.base import (
    Algorithm,
    AlgoState,
    Timing,
    global_mean_grads,
    register,
)
from repro_torch.tree import tree_map


class SynchronousAlgorithm(Algorithm):
    # Round-barrier semantics.  Both engines share the same host-side round
    # machinery (select_groups -> round_timing -> per-worker grad step ->
    # group averaging); the batched engine runs each round through
    # reduce_groups_stacked (supports_batched holds while reduce_groups
    # stays the default).
    family = "collective"
    synchronous = True
    reports_ema = False


@register("allreduce")
class Allreduce(SynchronousAlgorithm):
    """Synchronous Allreduce-SGD: one global reduction group per round."""

    def select_groups(self, state: AlgoState, rng):
        return [list(range(state.M))]

    def round_timing(self, state, cfg, link, groups, t):
        M = state.M
        ring = [(i, (i + 1) % M) for i in range(M)]
        step_t = max(link.iteration_time(i, j, now=t) for i, j in ring)
        comm = step_t * 2 * (M - 1) / M  # 2(M-1)/M ring phases
        comp = link.compute_time
        return Timing(duration=comp + comm, comm=comm, compute=comp)

    def transform_grads(self, grads, M, shard=None):
        return global_mean_grads(grads, shard)


@register("prague")
class Prague(SynchronousAlgorithm):
    """Prague-style random-group partial-allreduce.

    ``trainer_groups`` configures the SPMD trainer path (number of contiguous
    worker groups per round); the simulator path reads the group *size* from
    ``cfg.prague_group`` and the contention factor from
    ``cfg.prague_contention``.
    """

    def __init__(self, trainer_groups: int = 2):
        super().__init__()
        self.trainer_groups = trainer_groups

    def select_groups(self, state: AlgoState, rng):
        order = rng.permutation(state.M)
        g = state.extras.get("group_size", 4)
        return [
            [int(w) for w in order[s : s + g]]
            for s in range(0, state.M, g)
        ]

    def init_state(self, cfg, M):
        state = super().init_state(cfg, M)
        state.extras["group_size"] = getattr(cfg, "prague_group", 4)
        return state

    def round_timing(self, state, cfg, link, groups, t):
        # Concurrent partial-allreduces compete for shared bandwidth
        # (paper §V-B); each extra *actual* reducing group (>= 2 members)
        # inflates ring time by this factor.
        n_groups = max(1, sum(1 for grp in groups if len(grp) >= 2))
        congestion = 1.0 + getattr(cfg, "prague_contention", 0.5) * (n_groups - 1)
        comm = 0.0
        for grp in groups:
            if len(grp) < 2:
                continue
            ring = [(grp[a], grp[(a + 1) % len(grp)]) for a in range(len(grp))]
            ct = max(link.iteration_time(i, j, now=t) for i, j in ring)
            comm = max(comm, ct * 2 * (len(grp) - 1) / len(grp) * congestion)
        comp = link.compute_time
        return Timing(duration=comp + comm, comm=comm, compute=comp)

    def transform_grads(self, grads, M, shard=None):
        G = self.trainer_groups
        if G <= 1:
            return grads
        if M % G:
            raise ValueError(
                f"prague: M={M} workers not divisible into {G} groups"
            )

        def group_mean(g):
            gg = g.reshape((G, M // G) + tuple(g.shape[1:]))
            gg = gg.mean(dim=1, keepdim=True).expand_as(gg)
            return gg.reshape(g.shape)

        def sharded_group_mean(g):
            # This rank's rows; a contiguous group may span ranks, so each
            # group's f32 sum is summed across the worker ranks.
            gid = torch.arange(shard.rows.start, shard.rows.stop,
                               device=g.device) // (M // G)
            sums = torch.zeros((G,) + tuple(g.shape[1:]), dtype=torch.float32,
                               device=g.device).index_add_(0, gid, g.float())
            return (shard.sum(sums) / (M // G))[gid].to(g.dtype)

        return tree_map(group_mean if shard is None else sharded_group_mean, grads)
