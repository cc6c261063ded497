"""Timeline builders: the paper-§V scenario sweeps and a seedable generator.

These return plain declarative ``Timeline``s — composition is list
concatenation, and every randomized builder takes an explicit seed so a
scenario is reproducible from ``(topology, seed, knobs)`` alone.
"""

from __future__ import annotations

import numpy as np

from repro_torch.scenarios.timeline import (
    ClusterOutage,
    LinkDegrade,
    Timeline,
    WorkerLeave,
    WorkerRejoin,
)


def cluster_outage(cluster: int, start: float, end: float) -> Timeline:
    """The Fig.-7-style headline scenario: one cluster falls off the WAN."""
    return Timeline([ClusterOutage(cluster, start, end)])


def partition(topology, start: float, end: float = float("inf")) -> Timeline:
    """Full network partition: every inter-cluster link dead during
    [start, end) — clusters train on, isolated from each other."""
    return Timeline([ClusterOutage(c, start, end) for c in range(topology.n_clusters)])


def degrade_links(links, start: float, end: float, factor: float) -> Timeline:
    """Degrade each (i, m) in ``links`` by ``factor`` over [start, end)."""
    return Timeline([LinkDegrade(i, m, start, end, factor) for i, m in links])


def worker_blip(
    worker: int, leave: float, rejoin: float, seed_from: int | None = None
) -> Timeline:
    """One worker departs and later rejoins (elastic churn)."""
    return Timeline(
        [WorkerLeave(worker, leave), WorkerRejoin(worker, rejoin, seed_from)]
    )


def federated_cohorts(
    topology,
    seed: int,
    horizon: float,
    rounds: int,
    cohort_size: int,
    carryover: int = 1,
) -> Timeline:
    """Federated-style participation over a large churning population.

    ``[0, horizon)`` splits into ``rounds`` equal windows; in each, only a
    ``cohort_size``-strong active cohort trains while the rest of the
    population is away (elastic churn, so a fleet-sized M never pays for
    idle workers).  Between consecutive windows ``carryover`` members stay
    on: equal-time leaves fire before rejoins, so without carryover a
    disjoint swap would transiently strand the rejoiners with no live
    replica to reseed from — the carryover members are both the reseed
    source and the thread of consensus state across rounds.

    Deterministic from ``(topology, seed, knobs)``, like every preset.
    """
    M = topology.n_workers
    if not 0 < cohort_size <= M:
        raise ValueError(f"cohort_size must be in [1, {M}], got {cohort_size}")
    if not 0 < carryover <= cohort_size:
        raise ValueError(
            f"carryover must be in [1, cohort_size={cohort_size}], "
            f"got {carryover}"
        )
    if cohort_size - carryover > M - cohort_size:
        raise ValueError(
            f"not enough away workers to refresh the cohort: need "
            f"{cohort_size - carryover} fresh members from a pool of "
            f"{M - cohort_size}"
        )
    if rounds < 1 or not (horizon > 0 and np.isfinite(horizon)):
        raise ValueError(f"need rounds >= 1 and finite horizon > 0, got "
                         f"{rounds}, {horizon}")
    rng = np.random.default_rng(seed)
    period = float(horizon) / rounds
    tl = Timeline()
    cohort = {int(w) for w in rng.choice(M, size=cohort_size, replace=False)}
    for w in sorted(set(range(M)) - cohort):  # everyone starts live
        tl.add(WorkerLeave(w, 0.0))
    for r in range(1, rounds):
        t = r * period
        stay = {int(w) for w in
                rng.choice(sorted(cohort), size=carryover, replace=False)}
        pool = sorted(set(range(M)) - cohort)
        fresh = {
            int(w)
            for w in rng.choice(pool, size=cohort_size - carryover, replace=False)
        }
        for w in sorted(cohort - stay):
            tl.add(WorkerLeave(w, t))
        for w in sorted(fresh):
            tl.add(WorkerRejoin(w, t))
        cohort = stay | fresh
    return tl


def random_timeline(
    topology,
    seed: int,
    horizon: float,
    n_outages: int = 1,
    outage_len: tuple[float, float] = (10.0, 60.0),
    n_degrades: int = 2,
    degrade_factor: tuple[float, float] = (2.0, 100.0),
    degrade_len: tuple[float, float] = (20.0, 120.0),
    n_churn: int = 1,
    churn_len: tuple[float, float] = (10.0, 60.0),
) -> Timeline:
    """Seedable composite scenario over ``[0, horizon)``.

    Draws outage targets/windows, degraded links (factor range mirrors the
    paper's 2x-100x slow-link sweep), and worker leave/rejoin blips from
    ``np.random.default_rng(seed)``; the result is declarative, so the same
    (topology, seed) always produces the same timeline.

    Generation is overlap-free by construction: candidate windows that
    would collide with an earlier event on the same failure domain (same
    cluster+direction, same directed link) are redrawn a bounded number of
    times, then dropped — the compiled timeline always passes the
    same-domain overlap validation ``Timeline.compile`` enforces.
    """
    if not (np.isfinite(horizon) and horizon > 0):
        raise ValueError(f"need finite horizon > 0, got {horizon}")
    for name, n in (
        ("n_outages", n_outages),
        ("n_degrades", n_degrades),
        ("n_churn", n_churn),
    ):
        if n < 0:
            raise ValueError(f"{name} must be >= 0, got {n}")
    for name, pair in (
        ("outage_len", outage_len),
        ("degrade_len", degrade_len),
        ("churn_len", churn_len),
        ("degrade_factor", degrade_factor),
    ):
        lo, hi = pair
        if not (np.isfinite(lo) and np.isfinite(hi) and 0 < lo <= hi):
            raise ValueError(f"{name} must be a finite ordered range > 0, got {pair}")
    rng = np.random.default_rng(seed)
    M = topology.n_workers
    nc = topology.n_clusters
    tl = Timeline()

    def place(spans, domain, t0, t1):
        """Claim [t0, t1) on ``domain`` unless it overlaps a prior claim."""
        for a, b in spans.setdefault(domain, []):
            if t0 < b and a < t1:
                return False
        spans[domain].append((t0, t1))
        return True

    outage_spans: dict = {}
    for _ in range(n_outages if nc > 1 else 0):
        for _attempt in range(8):
            c = int(rng.integers(nc))
            t0 = float(rng.uniform(0.0, horizon))
            t1 = t0 + float(rng.uniform(*outage_len))
            if place(outage_spans, c, t0, t1):
                tl.add(ClusterOutage(c, t0, t1))
                break
    degrade_spans: dict = {}
    for _ in range(n_degrades):
        for _attempt in range(8):
            i = int(rng.integers(M))
            m = int(rng.integers(M - 1))
            m = m if m < i else m + 1
            t0 = float(rng.uniform(0.0, horizon))
            t1 = t0 + float(rng.uniform(*degrade_len))
            factor = float(rng.uniform(*degrade_factor))
            # Degrades default symmetric: the domain is the unordered pair.
            if place(degrade_spans, (min(i, m), max(i, m)), t0, t1):
                tl.add(LinkDegrade(i, m, t0, t1, factor))
                break
    # Churn blips use distinct workers so leave/rejoin pairs never overlap.
    churned = rng.choice(M, size=min(n_churn, M - 1), replace=False)
    for w in churned:
        t0 = float(rng.uniform(0.0, horizon))
        t1 = t0 + float(rng.uniform(*churn_len))
        tl.add(WorkerLeave(int(w), t0), WorkerRejoin(int(w), t1))
    return tl
