"""Engine-side scenario machinery shared by ALL four execution loops.

The reference and batched engines must make byte-identical host-side
decisions on the same timeline — that is the engine-parity contract — so
every decision that a scenario adds to a loop lives here, written once:

* ``attempt_fails``      — does this event's pull cross a currently-dead
  link?  (Consumes no RNG; advances the link model to the event time, which
  is exactly what ``event_timing`` would do a moment later.)
* ``notify_monitor``     — forward a timeout to the Monitor; returns the
  new (possibly earlier) wake time for the out-of-schedule refresh.
* ``monitor_reach``      — which workers can currently exchange control
  traffic with a home-cluster-pinned Monitor (None = omniscient legacy
  Monitor, i.e. ``home_cluster`` unset or no scenario attached).
* ``publish_policy``     — deliver (P, rho) only to reachable workers;
  the far side of a partition keeps training on its stale policy.
* ``monitor_boundary``   — one whole Monitor wake: failover
  heartbeat/lease tick and deterministic re-election (DESIGN.md §18),
  chaos-injected report drops / lost publishes, collect, step, publish.
  Both engines call this one function at identical virtual times, so
  every failover and chaos decision is made exactly once per wake and
  parity is preserved by construction.
* ``apply_action``       — apply one churn action to loop state: heap
  membership, active set, EMA reset, and replica reseeding (via a
  caller-supplied callback, because the two engines store replicas
  differently — per-replica lists vs stacked trees).
* ``prepare_monitor``    — give the Monitor the topology (for failure-
  domain escalation) and a reroute delay derived from the link timeout.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.monitor import IterationTimeEMA
from repro_torch.scenarios.timeline import WorkerLeave, WorkerRejoin


def prepare_monitor(monitor, link_model) -> None:
    """Default the Monitor's scenario knobs off the link model.

    The reroute delay models detection honestly: a worker only *knows* a
    pull failed once the timeout elapses, so the out-of-schedule refresh
    fires one ``dead_link_timeout`` after the first failure — by which
    point every worker that touched the dead domain has evidence pending,
    and one refresh masks the whole failure domain.
    """
    if monitor is None:
        return
    if monitor.failover is not None and monitor.home_cluster is None:
        raise ValueError(
            "Monitor failover requires a home-pinned control plane: set "
            "monitor_home_cluster (an omniscient Monitor has no home to "
            "fail over from)"
        )
    if link_model.compiled_scenario is None:
        return
    if monitor.topology is None:
        monitor.topology = link_model.topology
    if monitor.reroute_delay is None:
        monitor.reroute_delay = link_model.dead_link_timeout


def attempt_fails(link_model, algo, state, i, m, t: float) -> bool:
    """True when the event's pull would cross a scenario-dead link.

    Called only when a scenario is attached; advancing the link model here
    (instead of inside ``event_timing``) is idempotent for the same ``t``,
    so RNG consumption is unchanged and identical across engines.
    """
    if m is None or not algo.would_communicate(state, i, m):
        return False
    link_model.advance_to(t)
    return link_model.link_dead(i, m)


def monitor_reach(monitor, link_model, t: float):
    """Per-worker control-plane reachability for a home-pinned Monitor.

    Returns ``(reach_in, reach_out)`` boolean (M,) arrays — worker ``j``'s
    reports arrive at the Monitor iff ``reach_in[j]``, and the Monitor's
    policy publish lands on ``j`` iff ``reach_out[j]`` — or None for the
    legacy omniscient Monitor (``home_cluster`` unset, or no scenario, so
    the control plane shares fate with nothing).  Both directions follow
    the sparse segment's *directed* semantics: a one-direction WAN outage
    can lose reports while publishes still land, and vice versa.
    """
    if monitor is None or monitor.home_cluster is None or link_model is None:
        return None
    link_model.advance_to(t)
    seg = link_model.current_segment
    if seg is None:
        return None
    home = int(monitor.home_cluster)
    cl = seg.cluster
    cross = cl != home
    reach_in = ~(seg.dead_out | (cross & (seg.wan_out[cl] | seg.wan_in[home])))
    reach_out = ~(seg.dead_in | (cross & (seg.wan_out[home] | seg.wan_in[cl])))
    return reach_in, reach_out


def publish_policy(algo, state, pol, reach_out=None) -> None:
    """Deliver a fresh (P, rho) — but only to workers the Monitor reaches.

    ``reach_out=None`` (omniscient Monitor) is the legacy full publish.
    Otherwise unreachable workers keep their stale P rows and their stale
    per-worker consensus step (``AlgoState.rho_vec``): the far side of a
    partition keeps training on the last policy it heard.
    """
    if reach_out is None:
        algo.on_policy(state, pol)
        return
    reach_out = np.asarray(reach_out, dtype=bool)
    if reach_out.all():
        algo.on_policy(state, pol)
        state.rho_vec = None  # everyone heard the same rho again
        return
    old_P = state.P.copy()
    old_rho = np.array([state.rho_of(i) for i in range(state.M)])
    algo.on_policy(state, pol)
    stale = ~reach_out
    P = np.array(state.P, copy=True)  # never mutate pol.P via aliasing
    P[stale, :] = old_P[stale, :]
    state.P = P
    rho_vec = np.full(state.M, state.rho, dtype=float)
    rho_vec[stale] = old_rho[stale]
    state.rho_vec = None if np.all(rho_vec == state.rho) else rho_vec


def failover_tick(monitor, seg, t: float) -> bool:
    """One heartbeat/lease/election step for a failover-enabled Monitor.

    Pure function of ``(segment, virtual time, failover state)`` — no RNG —
    called once per Monitor wake by ``monitor_boundary``.  Returns True
    when a live leader holds the control plane after the tick (the refresh
    proceeds, from the *new* vantage point if an election just happened)
    and False when the leader's cluster is dead and no standby quorum
    could elect (the refresh is skipped; workers keep training on their
    last published per-worker policy rows).

    Semantics (DESIGN.md §18):

    * A cluster hosts a standby iff at least one of its workers is present
      (``~seg.dead_out`` — churn can empty a cluster and take the standby
      with it).  WAN outages partition a standby but do not kill it.
    * Heartbeats ride the directed WAN: a live leader that can transmit
      (``not wan_out[home]``) renews the lease of every live standby that
      can receive (``not wan_in[c]``) at this wake.  Leases are lazily
      initialised to 0.0, so a leader partitioned from boot is already
      lease-expired at the first wake past the lease.
    * A standby whose lease has been silent for ``lease_periods`` schedule
      periods becomes an elector.  The lowest-id live, fully-WAN-connected
      elector wins if its votes (itself plus every other elector whose
      vote can reach it) meet the quorum (default: majority of clusters —
      a minority partition can then never elect a second leader).
    * ``adopt_leader`` re-homes the Monitor and renews every lease, so the
      old leader's cluster coming back does not immediately re-elect.
    """
    fo = monitor.failover
    home = int(monitor.home_cluster)
    cl = seg.cluster
    nc = len(seg.wan_out)
    alive = np.zeros(nc, dtype=bool)
    alive[np.unique(cl[~seg.dead_out])] = True
    for c in range(nc):
        fo.last_heartbeat.setdefault(c, 0.0)
    if alive[home]:
        fo.last_heartbeat[home] = t
        if not seg.wan_out[home]:
            for c in range(nc):
                if c != home and alive[c] and not seg.wan_in[c]:
                    fo.last_heartbeat[c] = t
    lease = fo.lease_periods * monitor.schedule_period
    electors = [
        c
        for c in range(nc)
        if c != home and alive[c] and t - fo.last_heartbeat[c] >= lease
    ]
    if electors:
        quorum = fo.quorum if fo.quorum is not None else nc // 2 + 1
        for cand in electors:  # ascending cluster id: deterministic winner
            if seg.wan_out[cand] or seg.wan_in[cand]:
                continue  # a WAN-cut candidate could not lead anyone
            votes = 1 + sum(1 for s in electors if s != cand and not seg.wan_out[s])
            if votes >= quorum:
                monitor.adopt_leader(cand, t)
                return True
    if alive[home]:
        return True  # leader present (possibly partitioned): refresh runs
    fo.n_skipped_refreshes += 1
    return False


def monitor_boundary(
    monitor, algo, state, link_model, emas, active, t: float, chaos=None
):
    """One whole Monitor wake, shared verbatim by every engine loop.

    Failover tick (maybe re-homing the Monitor), chaos-filtered report
    collection, Algorithm-1 step, chaos-aware publish.  Returns the fresh
    ``PolicyResult`` — or None when a dead leader and no quorum skipped
    the refresh — and the caller logs it and advances ``next_monitor``.
    Both engines call this at identical virtual times with identical
    arguments, so every failover and chaos decision is made exactly once
    per wake and reference-vs-batched parity holds by construction.
    """
    if monitor.failover is not None and link_model is not None:
        link_model.advance_to(t)
        seg = link_model.current_segment
        if seg is not None and not failover_tick(monitor, seg, t):
            return None
    reach = monitor_reach(monitor, link_model, t)
    reports = {
        j: emas[j].snapshot()
        for j in range(monitor.n_workers)
        if j in active and (reach is None or reach[0][j])
    }
    if chaos is not None:
        reports = {j: r for j, r in reports.items() if not chaos.drop_report(j, t)}
    monitor.collect(reports)
    pol = monitor.step()
    if chaos is not None and chaos.publish_lost(t, monitor.schedule_period):
        # Publish delayed past the next refresh: it never lands anywhere.
        publish_policy(algo, state, pol, np.zeros(monitor.n_workers, dtype=bool))
    else:
        publish_policy(algo, state, pol, None if reach is None else reach[1])
    return pol


def notify_monitor(
    monitor, i: int, m: int, t: float, next_monitor: float, link_model=None
) -> float:
    """Report a timed-out pull; possibly pull the next Monitor wake earlier
    (the out-of-schedule Eq.-14 refresh).  A home-pinned Monitor never sees
    reports from workers it cannot currently reach — the notification is
    simply lost in the partition."""
    if monitor is None:
        return next_monitor
    if link_model is not None:
        reach = monitor_reach(monitor, link_model, t)
        if reach is not None and not reach[0][i]:
            return next_monitor
    wake = monitor.notify_failure(i, m, t)
    if wake is not None and wake < next_monitor:
        return wake
    return next_monitor


def apply_action(
    act,
    *,
    active: set,
    reseed,
    rng=None,
    heap=None,
    emas: list | None = None,
    ema_beta: float = 0.5,
) -> None:
    """Apply one churn action to loop state (see module docstring).

    ``reseed(worker, src)`` copies ``src``'s replica into ``worker``'s row
    and zeroes its momentum — ``train/elastic.py`` provides both storage
    forms.  Async loops pass ``heap``/``emas``/``rng``; the synchronous
    round loops have none of the three (churn there is link-state plus the
    rejoin reseed; the barrier still spans all M workers — non-adaptive
    round strategies pay the timeout, which is the point).

    ``heap`` is a ``train.events.EventHeap``: a leave marks the worker's
    entry dead in O(1) (lazy invalidation — the stale entry is skipped when
    it surfaces) instead of the old O(M) prune-and-reheapify, which made
    the ``federated_cohorts`` t=0 leave storm O(M^2) at boot.
    """
    w = act.worker
    if isinstance(act, WorkerLeave):
        active.discard(w)
        if heap is not None:
            heap.invalidate(w)
    elif isinstance(act, WorkerRejoin):
        active.add(w)
        src = act.seed_from
        if src is None:
            others = [a for a in active if a != w]
            if not others:  # compile() validates this away; be loud anyway
                raise RuntimeError(
                    f"rejoin of worker {w} at t={act.time}: no live worker "
                    "to reseed from"
                )
            src = min(others)
        reseed(w, src)
        if emas is not None:
            emas[w] = IterationTimeEMA(len(emas), beta=ema_beta)
        if heap is not None:
            heap.push(act.time + rng.exponential(0.005), w)
    else:  # pragma: no cover - compile() only emits churn actions
        raise TypeError(f"unexpected scenario action {act!r}")
