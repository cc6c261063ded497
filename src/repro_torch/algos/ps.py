"""Parameter-server baselines (paper §V / Fig. 14).

All PS traffic funnels through one node ("the training is constrained by
the network capacity at the parameter server"): each additional concurrent
worker inflates the PS link time by ``cfg.ps_congestion``.

  ps-sync   barrier at the PS every round (synchronous)
  ps-async  per-worker asynchronous push/pull

Host-side selection and timing are the JAX package's, verbatim.
"""

from __future__ import annotations

from repro_torch.algos.base import (
    Algorithm,
    AlgoState,
    Timing,
    global_mean_grads,
    register,
)


def _ps_congestion(cfg, M: int) -> float:
    return 1.0 + getattr(cfg, "ps_congestion", 0.4) * (M - 2)


@register("ps-sync")
class PSSync(Algorithm):
    """Synchronous parameter server: every worker exchanges with the PS,
    barrier, global average (mathematically an allreduce through a star)."""

    family = "ps"
    synchronous = True
    reports_ema = False

    def select_groups(self, state: AlgoState, rng):
        return [list(range(state.M))]

    def round_timing(self, state, cfg, link, groups, t):
        M = state.M
        ps = getattr(cfg, "ps_node", 0)
        comm = max(
            link.iteration_time(i, ps, now=t) for i in range(M) if i != ps
        ) * _ps_congestion(cfg, M)
        comp = link.compute_time
        return Timing(duration=comp + comm, comm=comm, compute=comp)

    def transform_grads(self, grads, M, shard=None):
        return global_mean_grads(grads, shard)


@register("ps-async")
class PSAsync(Algorithm):
    """Asynchronous parameter server: each event, worker i pushes its fresh
    replica to the PS; the PS absorbs and returns the running average.

    ``apply_comm`` mutates the *peer* (PS) replica, so pushes sharing the PS
    are never causally independent and the default gossip cohort step cannot
    replay them.  The batched engine instead uses the ``"ps-serial"``
    variant: a cohort's grad steps run stacked, and the PS running average
    is folded as a serialized chain over the cohort's ``x_half`` rows in
    exact pop order inside the same dispatch (``s <- s + w (x_k - s)``),
    the reference's event-at-a-time ``mix`` recurrence."""

    family = "ps"
    synchronous = False
    reports_ema = False  # the PS star has no per-link policy to learn

    @property
    def supports_trainer(self) -> bool:
        return False  # per-worker async push/pull has no lockstep SPMD form

    @property
    def batched_variant(self) -> str:
        return "ps-serial"

    def serial_row(self, state: AlgoState) -> int:
        return state.extras.get("ps_node", 0)

    def would_communicate(self, state: AlgoState, i, m) -> bool:
        return m is not None  # every non-PS worker talks to the PS

    def select_peer(self, state: AlgoState, i: int, rng):
        ps = state.extras.get("ps_node", 0)
        return ps if i != ps else None

    def init_state(self, cfg, M):
        state = super().init_state(cfg, M)
        state.extras["ps_node"] = getattr(cfg, "ps_node", 0)
        return state

    def apply_comm(self, state, cfg, replicas, i, m, x_half):
        if m is None:  # the PS node itself: local step only
            replicas[i] = x_half
            return False
        # Push/pull with the PS: PS absorbs then returns the average.
        mean_p = self.mix(replicas[m], x_half, 0.5)
        replicas[m] = mean_p
        replicas[i] = mean_p
        return True

    def event_timing(self, state, cfg, link, i, m, communicated, t):
        comp = link.compute_time
        if not communicated:
            return Timing(duration=comp, comm=0.0, compute=comp)
        # The PS link carries all M-1 workers' traffic (congestion).  The
        # raw (pre-congestion) link time rides along in ``net`` so traced
        # runs can serve it back and re-apply this multiplier.
        raw = link.iteration_time(i, m, now=t)
        dur = raw * _ps_congestion(cfg, state.M)
        return Timing(duration=dur, comm=max(0.0, dur - comp), compute=comp,
                      net=raw)
