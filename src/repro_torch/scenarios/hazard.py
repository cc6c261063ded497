"""Cascading failure storms: a seedable self-exciting hazard process.

Real outages cluster: a WAN cut stresses re-routed links, a rack power
event takes hosts with it, and recovery overlaps the next incident.  The
classic model is a **Hawkes process** — each event adds an exponentially
decaying kick to the failure intensity of *correlated* domains, so one
outage raises the short-term hazard of the next and storms emerge from a
single trigger.

``hazard_timeline`` runs Ogata thinning over three domain families:

* **cluster outages** — one intensity per cluster; a firing emits a
  ``ClusterOutage`` and kicks (a) every *other* cluster (the cascade
  term, ``excite_spread``), (b) the WAN link-degrade intensity of every
  directed cluster pair touching the outaged cluster (``excite_links``),
  and (c) the worker-churn intensity of the cluster itself
  (``excite_workers``) — the "same cluster → its WAN links → its
  workers" correlation chain.
* **WAN link degrades** — one intensity per *directed cluster pair*
  (O(n_clusters^2) state, never O(M^2)); a firing degrades one concrete
  cross-cluster link drawn uniformly from the pair.
* **worker churn blips** — one intensity per cluster; a firing emits a
  leave/rejoin pair for one present worker of the cluster, capped so the
  timeline can never depopulate the run.

Intensities recover exponentially (rate ``decay``), so a storm burns
itself out.  Everything is drawn from one ``np.random.default_rng(seed)``
in a fixed order, and the output is a plain declarative ``Timeline`` —
compilation into the piecewise segment machinery is unchanged and
consumes no RNG, which is exactly what keeps reference-vs-batched engine
parity *exact* under a storm and ``scenario=None`` bit-identical
(DESIGN.md §18).

Same-domain overlap is avoided at generation time (a cluster in outage,
a degraded directed link, or a departed worker cannot re-fire until it
recovers), so the generated timeline always passes the compile-time
overlap validation that ``Timeline.compile`` enforces.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np

from repro_torch.scenarios.timeline import (
    ClusterOutage,
    LinkDegrade,
    Timeline,
    WorkerLeave,
    WorkerRejoin,
)


@dataclass(frozen=True)
class HazardConfig:
    """Knobs of the self-exciting hazard process (rates are per virtual
    second; excitations are kick magnitudes added to the target domain's
    intensity and decaying at ``decay``)."""

    # Spontaneous (background) rates per domain instance.
    base_cluster_rate: float = 0.002
    base_degrade_rate: float = 0.0005  # per directed cross-cluster pair
    base_worker_rate: float = 0.0005  # per cluster (churn blips)
    # Excitation kicks fired by a cluster outage.
    excite_spread: float = 0.02  # -> each other cluster's outage hazard
    excite_links: float = 0.05  # -> each WAN pair touching the cluster
    excite_workers: float = 0.04  # -> the cluster's own churn hazard
    decay: float = 0.05  # intensity recovery rate (1/s)
    # Event-duration / magnitude draws.
    outage_len: tuple = (20.0, 80.0)
    degrade_len: tuple = (30.0, 120.0)
    degrade_factor: tuple = (4.0, 50.0)
    blip_len: tuple = (20.0, 90.0)
    # Safety rails.
    max_events: int = 200  # declarative events (outage/degrade/blip)
    max_departed_frac: float = 0.5  # churn can never strand the run
    worker_blips: bool = True  # off when composing with churn presets


def _check_range(name, rng_pair, positive=True):
    lo, hi = rng_pair
    if not (
        np.isfinite(lo) and np.isfinite(hi) and lo <= hi and (lo > 0 or not positive)
    ):
        raise ValueError(f"{name} must be a finite ordered range, got {rng_pair}")


def hazard_timeline(
    topology,
    seed: int,
    horizon: float,
    config: HazardConfig | None = None,
    *,
    trigger_cluster: int | None = None,
    trigger_time: float = 0.0,
    **overrides,
) -> Timeline:
    """Generate a storm Timeline over ``[0, horizon)`` (module docstring).

    ``trigger_cluster`` plants one exogenous ``ClusterOutage`` at
    ``trigger_time`` — the storm's deterministic first strike (the
    failover acceptance scenario pins it on the Monitor's home cluster);
    the cascade then evolves from the seeded Hawkes dynamics.  Keyword
    ``overrides`` patch individual ``HazardConfig`` fields.
    """
    cfg = config or HazardConfig()
    if overrides:
        cfg = replace(cfg, **overrides)
    if not (np.isfinite(horizon) and horizon > 0):
        raise ValueError(f"need finite horizon > 0, got {horizon}")
    for name in (
        "base_cluster_rate",
        "base_degrade_rate",
        "base_worker_rate",
        "excite_spread",
        "excite_links",
        "excite_workers",
    ):
        if getattr(cfg, name) < 0:
            raise ValueError(f"{name} must be >= 0, got {getattr(cfg, name)}")
    if not (cfg.decay > 0 and np.isfinite(cfg.decay)):
        raise ValueError(f"decay must be finite > 0, got {cfg.decay}")
    _check_range("outage_len", cfg.outage_len)
    _check_range("degrade_len", cfg.degrade_len)
    _check_range("blip_len", cfg.blip_len)
    _check_range("degrade_factor", cfg.degrade_factor)
    M = topology.n_workers
    nc = topology.n_clusters
    if trigger_cluster is not None and not (0 <= trigger_cluster < nc):
        raise ValueError(
            f"trigger_cluster {trigger_cluster} out of range "
            f"(topology has {nc} clusters)"
        )
    cluster_of = np.array([topology.cluster_of(w) for w in range(M)])
    members = [np.where(cluster_of == c)[0] for c in range(nc)]

    rng = np.random.default_rng(seed)
    # Hawkes excess (sum of decaying kicks) per domain family; base rates
    # are added on evaluation.  Cross-cluster degrade pairs only exist for
    # nc > 1; a single-cluster topology degenerates to worker churn.
    exc_cluster = np.zeros(nc)
    exc_pair = np.zeros((nc, nc))
    exc_worker = np.zeros(nc)
    pair_mask = ~np.eye(nc, dtype=bool)

    # Recovery bookkeeping: suppressed domains re-enter the hazard pool at
    # these times (sorted ascending; merged into the thinning walk because
    # re-activation *raises* total intensity and would break the bound).
    outage_until = np.zeros(nc)  # cluster in outage until t
    busy_links: dict[tuple[int, int], float] = {}
    departed: dict[int, float] = {}  # worker -> rejoin time
    wakeups: list[float] = []

    events: list = []
    t = 0.0
    forced = float(trigger_time) if trigger_cluster is not None else np.inf

    def intensities(now):
        lam_c = np.where(outage_until > now, 0.0, cfg.base_cluster_rate + exc_cluster)
        lam_p = np.where(pair_mask, cfg.base_degrade_rate + exc_pair, 0.0)
        max_departed = int(cfg.max_departed_frac * M)
        churn_open = cfg.worker_blips and len(departed) < max(1, max_departed)
        lam_w = (cfg.base_worker_rate + exc_worker) if churn_open else np.zeros(nc)
        return lam_c, lam_p, lam_w

    def advance(dt):
        f = np.exp(-cfg.decay * dt)
        exc_cluster[:] *= f
        exc_pair[:] *= f
        exc_worker[:] *= f

    def purge(now):
        for w in [w for w, tr in departed.items() if tr <= now]:
            del departed[w]
        for k in [k for k, te in busy_links.items() if te <= now]:
            del busy_links[k]

    def fire_cluster(c, now):
        dur = float(rng.uniform(*cfg.outage_len))
        events.append(ClusterOutage(int(c), now, now + dur))
        outage_until[c] = now + dur
        wakeups.append(now + dur)
        exc_cluster[:] += cfg.excite_spread
        exc_cluster[c] = 0.0  # in outage; kick is moot until recovery
        exc_pair[c, :] += cfg.excite_links
        exc_pair[:, c] += cfg.excite_links
        exc_worker[c] += cfg.excite_workers

    def fire_pair(ca, cb, now):
        # One concrete directed cross link of the pair; busy links are
        # skipped (the candidate is thinned, no event).
        i = int(rng.choice(members[ca]))
        m = int(rng.choice(members[cb]))
        if (i, m) in busy_links:
            return
        dur = float(rng.uniform(*cfg.degrade_len))
        factor = float(rng.uniform(*cfg.degrade_factor))
        events.append(LinkDegrade(i, m, now, now + dur, factor, symmetric=False))
        busy_links[(i, m)] = now + dur

    def fire_worker(c, now):
        present = [int(w) for w in members[c] if w not in departed]
        if not present:
            return
        w = int(rng.choice(present))
        dur = float(rng.uniform(*cfg.blip_len))
        events.append(WorkerLeave(w, now))
        events.append(WorkerRejoin(w, now + dur))
        departed[w] = now + dur
        wakeups.append(now + dur)

    while t < horizon and len(events) < cfg.max_events:
        purge(t)
        lam_c, lam_p, lam_w = intensities(t)
        total = float(lam_c.sum() + lam_p.sum() + lam_w.sum())
        pending = sorted(w for w in wakeups if w > t)
        next_wake = min(pending[0] if pending else np.inf, forced)
        if total <= 1e-12:
            if next_wake >= horizon:
                break
            advance(next_wake - t)
            t = next_wake
            if t == forced:
                if outage_until[trigger_cluster] <= t:
                    fire_cluster(trigger_cluster, t)
                forced = np.inf
            continue
        dt = float(rng.exponential(1.0 / total))
        if t + dt >= next_wake:
            # A suppressed domain re-enters (or the forced trigger fires)
            # before the candidate: jump there and rebuild the bound.
            advance(next_wake - t)
            t = next_wake
            if t == forced:
                if outage_until[trigger_cluster] <= t:
                    fire_cluster(trigger_cluster, t)
                forced = np.inf
            continue
        advance(dt)
        t += dt
        if t >= horizon:
            break
        # Thinning: accept with prob lambda(t)/bound, then pick the domain
        # proportional to its share of the *current* intensity.
        purge(t)
        lam_c, lam_p, lam_w = intensities(t)
        now_total = float(lam_c.sum() + lam_p.sum() + lam_w.sum())
        if rng.uniform() * total > now_total:
            continue
        u = rng.uniform() * now_total
        if u < lam_c.sum():
            fire_cluster(int(np.searchsorted(np.cumsum(lam_c), u)), t)
            continue
        u -= lam_c.sum()
        if u < lam_p.sum():
            flat = int(np.searchsorted(np.cumsum(lam_p.ravel()), u))
            fire_pair(flat // nc, flat % nc, t)
            continue
        u -= lam_p.sum()
        fire_worker(int(np.searchsorted(np.cumsum(lam_w), u)), t)

    if np.isfinite(forced) and forced < horizon and len(events) < cfg.max_events:
        # Candidate stream ended before reaching the trigger (tiny rates):
        # the exogenous first strike still fires.
        if outage_until[trigger_cluster] <= forced:
            fire_cluster(trigger_cluster, forced)
    return Timeline(events)


def storm(
    topology,
    seed: int,
    horizon: float,
    *,
    intensity: float = 1.0,
    trigger_cluster: int | None = None,
    trigger_time: float = 0.0,
    worker_blips: bool = True,
    max_events: int = 200,
) -> Timeline:
    """The headline cascading-storm preset (tuned for fleet populations).

    ``intensity`` scales every rate and excitation together: 1.0 is a
    rough storm over a 4-cluster fleet; the ``federated_cohorts``
    populations compose via ``worker_blips=False`` (the cohort preset
    already owns worker churn — double-booking a worker would fail the
    leave-twice validation, by design).
    """
    s = float(intensity)
    if not (s > 0 and np.isfinite(s)):
        raise ValueError(f"intensity must be finite > 0, got {intensity}")
    cfg = HazardConfig(
        base_cluster_rate=0.002 * s,
        base_degrade_rate=0.0005 * s,
        base_worker_rate=0.0005 * s,
        excite_spread=0.02 * s,
        excite_links=0.05 * s,
        excite_workers=0.04 * s,
        worker_blips=worker_blips,
        max_events=max_events,
    )
    return hazard_timeline(
        topology,
        seed,
        horizon,
        cfg,
        trigger_cluster=trigger_cluster,
        trigger_time=trigger_time,
    )
