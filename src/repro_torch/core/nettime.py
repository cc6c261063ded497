"""Heterogeneous link-time model (paper §II-B, Fig. 2/3 and §V network setup).

Models the per-iteration time t_{i,m} = max(C_i, N_{i,m}) of worker i pulling
from worker m: local compute overlapped with the network transfer (the paper
parallelizes them, §II-B).  Topology tiers map the paper's "intra-machine vs
inter-machine vs WAN" onto pod hardware: intra-host ICI, intra-pod ICI,
inter-pod DCN, and — for the paper-§V wide-area scenarios at M=64+ — an
inter-cluster WAN tier (``Topology.pods_per_cluster``).  Dynamic
perturbations reproduce the paper's evaluation setup ("randomly slow down
one link by 2x-100x, change the slow link every 5 min"); the WAN tier can
additionally carry temporally-correlated congestion jitter and asymmetric
per-direction bandwidth (``wan_jitter`` / ``wan_asymmetry``, default-off,
drawn from a dedicated seedable stream so existing traces stay pinned).

Tier invariants (pinned by tests/test_properties.py): per-tier base times
are ordered intra_host <= intra_pod <= inter_pod <= inter_cluster, every
iteration time is >= the compute time, and the dynamic slow-link factor
stays within ``slowdown_range``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


#: Topology tiers from nearest to farthest; LinkTimeModel.base_times must be
#: non-decreasing along this order.
TIERS = ("intra_host", "intra_pod", "inter_pod", "inter_cluster")


@dataclass
class Topology:
    """Placement of M workers onto a cluster/pod/host hierarchy.

    ``pods_per_cluster=None`` (default) keeps the legacy single-cluster
    three-tier model; setting it partitions pods into WAN-separated clusters
    whose cross-links resolve to the ``inter_cluster`` tier (paper §V
    wide-area setting).
    """

    n_workers: int
    workers_per_host: int = 4
    hosts_per_pod: int = 2
    pods_per_cluster: int | None = None  # None = one cluster, no WAN tier

    def host_of(self, i: int) -> int:
        return i // self.workers_per_host

    def pod_of(self, i: int) -> int:
        return self.host_of(i) // self.hosts_per_pod

    def cluster_of(self, i: int) -> int:
        if not self.pods_per_cluster:
            return 0
        return self.pod_of(i) // self.pods_per_cluster

    def tier(self, i: int, m: int) -> str:
        if self.host_of(i) == self.host_of(m):
            return "intra_host"
        if self.pod_of(i) == self.pod_of(m):
            return "intra_pod"
        if self.cluster_of(i) == self.cluster_of(m):
            return "inter_pod"
        return "inter_cluster"

    @property
    def n_clusters(self) -> int:
        return self.cluster_of(self.n_workers - 1) + 1

    def host_ids(self) -> np.ndarray:
        """(M,) host index per worker (vectorized ``host_of``)."""
        return np.arange(self.n_workers) // self.workers_per_host

    def pod_ids(self) -> np.ndarray:
        return self.host_ids() // self.hosts_per_pod

    def cluster_ids(self) -> np.ndarray:
        if not self.pods_per_cluster:
            return np.zeros(self.n_workers, dtype=int)
        return self.pod_ids() // self.pods_per_cluster

    @classmethod
    def multi_cluster(
        cls,
        n_workers: int,
        workers_per_host: int = 4,
        hosts_per_pod: int = 2,
        pods_per_cluster: int = 2,
    ) -> "Topology":
        """Paper-§V-style wide-area placement: clusters of
        ``workers_per_host * hosts_per_pod * pods_per_cluster`` workers
        joined by WAN links."""
        return cls(n_workers, workers_per_host=workers_per_host,
                   hosts_per_pod=hosts_per_pod,
                   pods_per_cluster=pods_per_cluster)


@dataclass
class LinkTimeModel:
    """Produces t_{i,m} matrices; supports paper-style dynamic slowdowns.

    Base times are per-tier transfer seconds for one model pull; the paper's
    Fig. 3 measured a ~4x gap between intra- and inter-machine iteration time
    — the defaults keep that ratio and add a slower inter-pod tier.
    """

    topology: Topology
    compute_time: float = 0.012  # C_i: one local grad step, overlapped
    base_times: dict = field(
        default_factory=lambda: {
            "intra_host": 0.010,
            "intra_pod": 0.040,
            "inter_pod": 0.120,
            # WAN links between clusters (paper §V wide-area): another ~4x
            # over the DCN tier, keeping the Fig.-3-style tier ratios.
            "inter_cluster": 0.480,
        }
    )
    jitter: float = 0.05  # lognormal-ish multiplicative noise
    slowdown_range: tuple = (2.0, 100.0)  # paper §V: 2x-100x on one link
    slow_interval: float = 300.0  # change the slow link every 5 minutes
    seed: int = 0
    # -- WAN scenario depth (paper §V wide-area; all default-OFF so the
    # engine-parity pins and every historical trace stay bit-identical:
    # when zero, no extra rng is consumed and no factor is applied) -------
    # Temporally-correlated (AR(1)) multiplicative jitter on inter_cluster
    # links: one latent state per unordered cluster pair, refreshed every
    # ``wan_jitter_interval`` virtual seconds with coefficient
    # ``wan_jitter_corr``, applied as exp(wan_jitter * state) to both
    # directions.  Models slow WAN congestion waves rather than iid noise.
    wan_jitter: float = 0.0
    wan_jitter_corr: float = 0.9
    wan_jitter_interval: float = 60.0
    # Static per-direction bandwidth skew on inter_cluster links: an
    # antisymmetric per-cluster-pair draw s, applied as exp(+wan_asymmetry*s)
    # one way and exp(-wan_asymmetry*s) the other (uplink != downlink).
    wan_asymmetry: float = 0.0
    # WAN draws come from their own stream so toggling them never perturbs
    # the base jitter/slow-link sequence.  None -> derived from ``seed``.
    wan_seed: int | None = None
    # -- scripted network dynamics (repro.scenarios; DESIGN.md §14) --------
    # A declarative ``Timeline`` (or pre-compiled ``CompiledTimeline``) of
    # cluster outages, link degradations, and worker churn.  Compiled here
    # into a piecewise link-state machine advanced by ``advance_to``:
    # purely time-dependent, consumes NO rng, so attaching a scenario never
    # perturbs the jitter/slow-link draw sequence and ``scenario=None``
    # stays bit-identical to every historical trace.
    scenario: object | None = None
    # A pull over a scenario-dead link blocks for this long (virtual
    # seconds), then fails: the transfer times out, no data moves, and the
    # event's duration is exactly the timeout (no jitter is drawn for it).
    dead_link_timeout: float = 30.0
    # -- trace-driven replay / calibration seam (repro.trace; DESIGN.md §15)
    # A pluggable time source consulted FIRST for live links: when its
    # ``network_time(i, m, now)`` returns a duration, that value is used
    # verbatim — no tier base, degrade, slow-link, or jitter factor applies
    # and NO rng is consumed (measured durations already embed all of them).
    # Returning None falls through to the model (the "past the trace
    # horizon" fallback).  Scenario dead-link semantics take precedence:
    # a dead link times out without ever consulting the source.
    # ``repro.trace.replay.ReplayLinkSource`` is the canonical provider.
    time_source: object | None = None
    # Per-directed-link multiplier on the *modeled* transfer time, applied
    # after scenario degradation (calibration's per-link WAN-skew output;
    # repro.trace.calibrate).  None = off; the replay path above bypasses
    # it (measured durations are already per-link).  Accepts either a dense
    # (M, M) array (legacy/calibration form) or a sparse ``{(i, m): factor}``
    # dict — both are folded into an internal edge map holding only the
    # non-unit entries, so fleet-scale models never pay (M, M) memory for
    # a handful of skewed WAN links.
    link_scale: object | None = None

    def __post_init__(self):
        # Observation tap for ``network_time`` (NOT a constructor field):
        # when set to a callable ``tap(i, m, value, dead)`` every query is
        # reported just before it returns.  The simulators' sync loops
        # install it around ``round_timing`` so traced runs capture the
        # per-link times a round draws (repro.trace); it never alters the
        # returned value or the rng stream.
        self.query_tap = None
        self._rng = np.random.default_rng(self.seed)
        self._slow_edge: tuple[int, int] | None = None
        self._slow_factor: float = 1.0
        self._next_change: float = 0.0
        nc = self.topology.n_clusters
        self._wan_rng = np.random.default_rng(
            self.seed + 1 if self.wan_seed is None else self.wan_seed
        )
        # Antisymmetric direction skew and AR(1) states, drawn up front for
        # every cluster pair so determinism is independent of query order.
        self._wan_dir = np.zeros((nc, nc))
        if self.wan_asymmetry > 0 and nc > 1:
            s = np.triu(self._wan_rng.standard_normal((nc, nc)), k=1)
            self._wan_dir = s - s.T
        self._wan_state = np.zeros((nc, nc))
        self._wan_next: float = 0.0
        self._scn = None
        self._scn_idx = 0
        if self.scenario is not None:
            scn = self.scenario
            if not hasattr(scn, "segments"):  # a declarative Timeline
                scn = scn.compile(self.topology)
            if scn.n_workers != self.topology.n_workers:
                raise ValueError(
                    f"scenario compiled for {scn.n_workers} workers, "
                    f"topology has {self.topology.n_workers}"
                )
            self._scn = scn
        # Non-unit link-scale entries as a sparse edge map (a multiply by
        # exactly 1.0 is a bit-exact no-op, so dropping unit entries keeps
        # dense-array inputs bit-identical to the legacy dense path).
        self._scale_map: dict[tuple[int, int], float] = {}
        if self.link_scale is not None:
            M = self.topology.n_workers
            if isinstance(self.link_scale, dict):
                for (i, m), f in self.link_scale.items():
                    if not (0 <= i < M and 0 <= m < M):
                        raise ValueError(
                            f"link_scale key ({i}, {m}) out of range for M={M}"
                        )
                    if f != 1.0:
                        self._scale_map[(int(i), int(m))] = float(f)
            else:
                self.link_scale = np.asarray(self.link_scale, dtype=float)
                if self.link_scale.shape != (M, M):
                    raise ValueError(
                        f"link_scale shape {self.link_scale.shape} != ({M}, {M})"
                    )
                for a, b in zip(*np.nonzero(self.link_scale != 1.0)):
                    self._scale_map[(int(a), int(b))] = float(
                        self.link_scale[a, b]
                    )

    @property
    def compiled_scenario(self):
        """The compiled timeline driving this model (None when static)."""
        return self._scn

    @property
    def current_segment(self):
        """The sparse link-state ``Segment`` in effect at the model's
        current virtual time (``advance_to``); None when no scenario is
        attached.  O(1) — used by the scenario drivers to answer Monitor
        reachability queries without materializing dense masks."""
        if self._scn is None:
            return None
        return self._scn.segments[self._scn_idx]

    # -- dynamics -----------------------------------------------------------
    def advance_to(self, now: float) -> None:
        """Re-draw the slowed link if the change interval elapsed; advance
        the correlated-WAN-jitter AR(1) states on their own cadence; step
        the scenario's piecewise link state to the segment containing
        ``now`` (deterministic, no rng)."""
        if self._scn is not None:
            self._scn_idx = self._scn.segment_index(now, hint=self._scn_idx)
        while now >= self._next_change:
            M = self.topology.n_workers
            i = int(self._rng.integers(M))
            m = int(self._rng.integers(M - 1))
            m = m if m < i else m + 1
            self._slow_edge = (i, m)
            lo, hi = self.slowdown_range
            self._slow_factor = float(self._rng.uniform(lo, hi))
            self._next_change += self.slow_interval
        if self.wan_jitter > 0 and self.topology.n_clusters > 1:
            nc = self.topology.n_clusters
            rho = self.wan_jitter_corr
            while now >= self._wan_next:
                noise = np.triu(self._wan_rng.standard_normal((nc, nc)), k=1)
                noise = noise + noise.T  # shared by both directions
                self._wan_state = (
                    rho * self._wan_state + np.sqrt(1.0 - rho * rho) * noise
                )
                self._wan_next += self.wan_jitter_interval

    def _wan_factor(self, i: int, m: int) -> float:
        """Current inter_cluster multiplier for the directed link i -> m."""
        ci, cm = self.topology.cluster_of(i), self.topology.cluster_of(m)
        f = 1.0
        if self.wan_asymmetry > 0:
            f *= float(np.exp(self.wan_asymmetry * self._wan_dir[ci, cm]))
        if self.wan_jitter > 0:
            f *= float(np.exp(self.wan_jitter * self._wan_state[ci, cm]))
        return f

    def link_dead(self, i: int, m: int) -> bool:
        """Whether the scenario currently marks the directed link i -> m
        dead (cluster outage or a departed endpoint).  Reflects the state
        as of the last ``advance_to``."""
        if self._scn is None:
            return False
        return self._scn.segments[self._scn_idx].link_dead(i, m)

    # -- queries ------------------------------------------------------------
    def network_time(self, i: int, m: int, now: float = 0.0) -> float:
        self.advance_to(now)
        if self._scn is not None:
            seg = self._scn.segments[self._scn_idx]
            if seg.link_dead(i, m):
                # Timed-out transfer: a deterministic stall — no jitter or
                # slow-link factor applies and no rng is consumed.
                if self.query_tap is not None:
                    self.query_tap(i, m, self.dead_link_timeout, True)
                return self.dead_link_timeout
        if self.time_source is not None:
            # Measured duration served verbatim: embeds every factor below,
            # so none applies and no rng is consumed.  None = past the trace
            # horizon, fall through to the model.
            served = self.time_source.network_time(i, m, now)
            if served is not None:
                if self.query_tap is not None:
                    self.query_tap(i, m, float(served), False)
                return float(served)
        tier = self.topology.tier(i, m)
        t = self.base_times[tier]
        if self._scn is not None:
            t *= self._scn.segments[self._scn_idx].degrade_factor(i, m)
        if self._scale_map:
            t *= self._scale_map.get((i, m), 1.0)
        if tier == "inter_cluster" and (self.wan_jitter > 0 or self.wan_asymmetry > 0):
            t *= self._wan_factor(i, m)
        if self._slow_edge in ((i, m), (m, i)):
            t *= self._slow_factor
        if self.jitter > 0:
            t *= float(np.exp(self._rng.normal(0.0, self.jitter)))
        if self.query_tap is not None:
            self.query_tap(i, m, t, False)
        return t

    def iteration_time(self, i: int, m: int, now: float = 0.0) -> float:
        """t_{i,m} = max(C_i, N_{i,m})  (paper §II-B)."""
        return max(self.compute_time, self.network_time(i, m, now))

    def matrix(self, now: float = 0.0) -> np.ndarray:
        """Expected iteration-time matrix at virtual time ``now`` (no jitter).

        Inherently dense — (M, M) output for the Monitor's policy LP and
        the dense test/analysis paths — but computed from the sparse link
        state with vectorized tier arithmetic (no Python double loop), and
        bit-identical to the historical per-element computation.
        """
        self.advance_to(now)
        topo = self.topology
        M = topo.n_workers
        host, pod, cl = topo.host_ids(), topo.pod_ids(), topo.cluster_ids()
        bt = self.base_times
        T = np.where(
            host[:, None] == host[None, :],
            bt["intra_host"],
            np.where(
                pod[:, None] == pod[None, :],
                bt["intra_pod"],
                np.where(
                    cl[:, None] == cl[None, :],
                    bt["inter_pod"],
                    bt["inter_cluster"],
                ),
            ),
        ).astype(float)
        seg = self._scn.segments[self._scn_idx] if self._scn is not None else None
        # Per-element factor order matches network_time exactly (degrade,
        # link_scale, WAN, slow link) so the values stay bit-identical.
        if seg is not None:
            for (i, m), f in seg.degrade_map.items():
                T[i, m] *= f
        for (i, m), f in self._scale_map.items():
            T[i, m] *= f
        if (self.wan_jitter > 0 or self.wan_asymmetry > 0) and topo.n_clusters > 1:
            # Slow-moving expected factors (direction skew + current AR(1)
            # congestion state); only the iid jitter is left out.
            F = np.ones((topo.n_clusters, topo.n_clusters))
            if self.wan_asymmetry > 0:
                F = F * np.exp(self.wan_asymmetry * self._wan_dir)
            if self.wan_jitter > 0:
                F = F * np.exp(self.wan_jitter * self._wan_state)
            cross = cl[:, None] != cl[None, :]
            Ffull = F[cl[:, None], cl[None, :]]
            T[cross] *= Ffull[cross]
        if self._slow_edge is not None:
            i, m = self._slow_edge
            T[i, m] *= self._slow_factor
            T[m, i] *= self._slow_factor
        T = np.maximum(self.compute_time, T)
        if seg is not None:
            T[seg.dead] = max(self.compute_time, self.dead_link_timeout)
        if self.time_source is not None:
            exp = getattr(self.time_source, "expected", None)
            if exp is not None:
                for i in range(M):
                    for m in range(M):
                        if i == m or (seg is not None and seg.link_dead(i, m)):
                            continue
                        served = exp(i, m, now)
                        if served is not None:
                            T[i, m] = max(self.compute_time, float(served))
        np.fill_diagonal(T, 0.0)
        return T

    def link_state_nbytes(self) -> int:
        """Host memory held by the model's link state: scenario segments,
        the sparse link-scale map, and the per-cluster WAN states.  O(M)
        for sparse configurations — the fleet-scale regression test pins
        this stays far below the (M, M) dense footprint."""
        n = self._wan_dir.nbytes + self._wan_state.nbytes
        n += 64 * len(self._scale_map)
        if isinstance(self.link_scale, np.ndarray):
            n += self.link_scale.nbytes
        if self._scn is not None:
            n += self._scn.nbytes
        return n


def homogeneous_times(M: int, t: float = 0.02) -> np.ndarray:
    """Uniform-link matrix (paper §V homogeneous setting)."""
    T = np.full((M, M), t)
    np.fill_diagonal(T, 0.0)
    return T


def pod_link_times(
    M: int,
    workers_per_pod: int,
    intra: float = 0.02,
    inter: float = 0.24,
    compute: float = 0.012,
) -> np.ndarray:
    """Two-tier pod matrix used by the production mesh benchmarks."""
    pod = np.arange(M) // workers_per_pod
    T = np.where(pod[:, None] == pod[None, :], max(compute, intra),
                 max(compute, inter)).astype(float)
    np.fill_diagonal(T, 0.0)
    return T
