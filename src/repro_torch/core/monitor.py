"""Network Monitor (paper Algorithm 1) + worker-side EMA (Algorithm 2, 19-22).

The Monitor is a *host-side control-plane* component: it never touches model
parameters (unlike a parameter server), only per-link iteration-time EMAs.
Every schedule period it pulls the EMA matrix from the workers and publishes
a fresh (P, rho) produced by Algorithm 3.

Fault tolerance (DESIGN.md §14): two independent detectors feed the same
connectivity mask —

* **missed reports** — a worker that stopped reporting has its links marked
  dead (time = inf) after ``dead_after`` missed reports (covers crashes and
  elastic departures);
* **failure notifications** — the data plane reports each timed-out pull
  (``notify_failure``); the Monitor masks the link, *escalates* the mask to
  the whole failure domain (a peer when several pullers fail to reach it, a
  cluster pair when failures span several peers across one WAN pair), and
  proposes an out-of-schedule Eq.-14 refresh so the policy re-routes without
  waiting for the next T_s tick.  Masks expire after ``revive_after``
  refreshes (probation): a recovered link is re-probed and, if still dead,
  re-masked by the next notification.

Algorithm 3 then optimizes only over the live subgraph, so the next policy
routes around the failure.  A restarted Monitor rebuilds all state from
worker EMAs — it keeps no durable state of its own.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.policy import PolicyResult, connectivity_key, generate_policy_matrix


@dataclass
class IterationTimeEMA:
    """Worker-side EMA of iteration times (Algorithm 2, UPDATETIMEVECTOR).

    T[m] <- beta * T[m] + (1 - beta) * t_{i,m}.  Smaller beta tracks faster
    networks dynamics (paper §III-B).
    """

    n_workers: int
    beta: float = 0.5
    times: np.ndarray = field(init=False)
    counts: np.ndarray = field(init=False)

    def __post_init__(self):
        self.times = np.zeros(self.n_workers)
        self.counts = np.zeros(self.n_workers, dtype=np.int64)

    def update(self, m: int, t: float) -> None:
        if self.counts[m] == 0:
            self.times[m] = t  # seed the EMA with the first observation
        else:
            self.times[m] = self.beta * self.times[m] + (1.0 - self.beta) * t
        self.counts[m] += 1

    def snapshot(self) -> np.ndarray:
        """Observed EMAs; never-observed links report 0 (Monitor fills them)."""
        return self.times.copy()


@dataclass
class MonitorFailover:
    """Standby-Monitor failover state (DESIGN.md §18).

    One standby candidate runs in every cluster; the current leader renews
    their **leases** by heartbeating at each Monitor wake (heartbeats ride
    the same directed WAN reachability as EMA reports).  A standby whose
    lease has been silent for ``lease_periods`` schedule periods considers
    the leader gone; when enough mutually-reachable standbys agree
    (``quorum``, default a majority of clusters — split-brain can then
    never elect two leaders), the lowest-id fully-WAN-connected candidate
    takes over.  The handoff re-seeds the EMA matrix from the new leader's
    reachable reports, drops the warm LP basis, and clears stale failure
    evidence (it was collected at the old vantage point); the election
    wake itself doubles as the out-of-schedule refresh.  With no quorum
    (or no eligible candidate) no refresh fires and the data plane keeps
    training on its last published per-worker policy rows — degraded, not
    stalled.

    All decisions are pure functions of ``(segment, virtual time, this
    state)`` and consume no RNG — both engines drive them through the
    shared ``scenarios.driver.monitor_boundary``, which is what keeps
    reference-vs-batched parity exact under failover.
    """

    lease_periods: float = 1.0
    quorum: int | None = None  # None = majority of clusters
    last_heartbeat: dict = field(default_factory=dict)  # cluster -> time
    n_failovers: int = 0
    n_skipped_refreshes: int = 0  # wakes with no live leader and no quorum
    leader_log: list = field(default_factory=list)  # [(t, new leader cluster)]


@dataclass
class NetworkMonitor:
    """Algorithm 1.  ``collect`` <- worker EMAs; ``step`` -> (P, rho)."""

    n_workers: int
    alpha: float
    K: int = 8
    R: int = 8
    eps: float = 1e-2
    # T_s (paper uses 2 minutes).  This is the single source of truth for
    # the monitor period: the simulator's event loop schedules refreshes off
    # this value, and SimConfig.monitor_period (when set) is forwarded here
    # by Algorithm.make_monitor rather than tracked separately.
    schedule_period: float = 120.0
    dead_after: int = 3
    # Base connectivity mask (M, M); None = fully connected.  step() combines
    # it with the live-worker mask so Algorithm 3 only routes over live links.
    d: np.ndarray | None = None
    # -- dead-link detection from failure notifications (DESIGN.md §14) ----
    # Worker placement, for failure-domain escalation (a control plane knows
    # its own topology); None disables cluster-level escalation.
    topology: object | None = None
    # Out-of-schedule refresh fires this long after the first failure of a
    # burst — detection is only honest once the pull's timeout has elapsed,
    # so drivers default it to the link model's dead_link_timeout, by which
    # point the whole failure domain has evidence pending.  None = unset.
    reroute_delay: float | None = None
    # A failure mask expires after this many refreshes (probation): the link
    # is re-opened, re-probed, and re-masked on the next failure if the
    # outage persists.  This is what lets a recovered cluster rejoin.
    revive_after: int = 3
    # Escalation thresholds: distinct pullers failing to reach one peer =>
    # the peer is down; distinct unreachable peers across one directed
    # cluster pair => the WAN between the two clusters is down.
    peer_escalation: int = 2
    cluster_escalation: int = 2
    # The cluster the Monitor physically lives in (control plane placement).
    # None = the legacy omniscient Monitor that sees every report regardless
    # of partitions.  When set, the scenario drivers drop EMA reports and
    # failure notifications from workers that cannot currently reach this
    # cluster, and policy publishes only land on workers the Monitor can
    # reach — the far side of a partition keeps training on its stale
    # policy (scenarios/driver.monitor_reach / publish_policy).
    home_cluster: int | None = None
    # Standby-Monitor failover (None = a single pinned Monitor:
    # if its cluster dies, no refresh ever fires again).  Requires
    # ``home_cluster``; driven by scenarios/driver.monitor_boundary.
    failover: MonitorFailover | None = None

    _T: np.ndarray = field(init=False)
    _missed: np.ndarray = field(init=False)
    policy: PolicyResult | None = field(init=False, default=None)
    history: list = field(init=False, default_factory=list)
    # Warm-start protocol (DESIGN.md §13): the last refresh's optimal LP
    # basis, threaded into the next Algorithm-3 sweep so steady-state
    # re-solves are dual-simplex restarts of a handful of pivots.  Opaque;
    # ``step`` drops it explicitly whenever the effective edge set changes
    # (``_basis_key``) — a basis from a larger live set must never be
    # re-threaded (the solver's shape validation is a fallback, not the
    # invalidation mechanism).
    _basis: object | None = field(init=False, default=None)
    _basis_key: bytes | None = field(init=False, default=None)
    # Failure evidence: directed link -> refresh index when last reported.
    _fail_links: dict = field(init=False, default_factory=dict)
    _fail_wake: float | None = field(init=False, default=None)
    _refresh_idx: int = field(init=False, default=0)

    def __post_init__(self):
        M = self.n_workers
        self._T = np.zeros((M, M))
        self._missed = np.zeros(M, dtype=np.int64)

    # -- data plane ----------------------------------------------------------
    def collect(self, reports: dict[int, np.ndarray]) -> None:
        """Receive {worker_id: EMA vector}; absent workers accrue a miss."""
        for i in range(self.n_workers):
            if i in reports:
                self._T[i, :] = reports[i]
                self._missed[i] = 0
            else:
                self._missed[i] += 1

    def _time_matrix(self) -> np.ndarray:
        """EMA matrix with dead workers masked and unobserved links imputed."""
        T = self._T.copy()
        observed = T[T > 0]
        fill = float(observed.mean()) if observed.size else 1.0
        T[T <= 0] = fill  # never-measured links: assume average cost
        np.fill_diagonal(T, 0.0)
        dead = self._missed >= self.dead_after
        T[dead, :] = np.inf
        T[:, dead] = np.inf
        return T

    def notify_failure(self, i: int, m: int, now: float) -> float | None:
        """Data-plane report: worker ``i``'s pull from ``m`` timed out.

        Records the evidence and returns the virtual time at which an
        out-of-schedule Eq.-14 refresh should fire (the driver lowers its
        next Monitor wake to this); one wake covers a whole failure burst.
        """
        self._fail_links[(int(i), int(m))] = self._refresh_idx
        if self._fail_wake is None:
            self._fail_wake = now + (self.reroute_delay or 0.0)
        return self._fail_wake

    def _failure_masks(self, conn: np.ndarray) -> None:
        """Mask reported-dead links out of ``conn``, escalated to the
        failure domain the evidence supports (module docstring)."""
        # Evidence recorded after refresh ``age`` masks refreshes age+1
        # .. age+revive_after, then expires (the link re-opens on probation).
        for k in [k for k, age in self._fail_links.items()
                  if self._refresh_idx - age > self.revive_after]:
            del self._fail_links[k]
        if not self._fail_links:
            return
        cluster = (
            [self.topology.cluster_of(w) for w in range(self.n_workers)]
            if self.topology is not None else None
        )
        pullers: dict[int, set] = {}
        for i, m in self._fail_links:
            # Evidence is directed — i's pull from m timed out — and so is
            # the mask: the reverse link m->i may be perfectly alive under
            # an asymmetric (one-direction) outage, and if it is not, m's
            # own failed pulls report it independently.
            conn[i, m] = 0.0
            pullers.setdefault(m, set()).add(i)
        for m, ps in pullers.items():
            # A WAN outage also produces many cross-cluster failures toward
            # each remote peer; "the peer itself is down" is only the best
            # explanation once one of its own cluster-mates can't reach it
            # (a crashed worker fails intra pulls too, a WAN outage never
            # does).  Without topology info, any quorum escalates.
            same = cluster is None or any(cluster[i] == cluster[m] for i in ps)
            if len(ps) >= self.peer_escalation and same:
                conn[m, :] = 0.0
                conn[:, m] = 0.0
        if cluster is None:
            return
        peers_by_pair: dict[tuple, set] = {}
        for i, m in self._fail_links:
            if cluster[i] != cluster[m]:
                peers_by_pair.setdefault((cluster[i], cluster[m]), set()).add(m)
        for (ca, cb), peers in peers_by_pair.items():
            if len(peers) >= self.cluster_escalation:
                # Directed escalation: the evidence says pulls FROM ca
                # TOWARD cb die, so only that direction of the WAN pair is
                # masked — a symmetric outage generates the mirror evidence
                # stream and masks the reverse within the same burst.
                a = np.array([c == ca for c in cluster])
                b = np.array([c == cb for c in cluster])
                conn[np.ix_(a, b)] = 0.0

    def adopt_leader(self, cluster: int, now: float) -> None:
        """Leadership handoff to the standby in ``cluster`` (DESIGN.md §18).

        A standby holds none of the old leader's soft state, and all of it
        is rebuildable from worker reports — so the handoff *drops* it:
        the EMA matrix and missed-report counters reset (the next
        ``collect`` re-seeds them from the workers the new leader can
        reach), the warm LP basis is invalidated (never thread
        a basis across a vantage change), and pending failure evidence is
        cleared (it was directed evidence *toward the old home*; the new
        leader re-accumulates its own within one reroute delay).
        """
        fo = self.failover
        self.home_cluster = int(cluster)
        self._T[:] = 0.0
        self._missed[:] = 0
        self._basis = None
        self._basis_key = None
        self._fail_links.clear()
        self._fail_wake = None
        fo.n_failovers += 1
        fo.leader_log.append((float(now), int(cluster)))
        # The new leader's own heartbeat starts every lease afresh.
        for c in list(fo.last_heartbeat):
            fo.last_heartbeat[c] = float(now)

    # -- control plane -------------------------------------------------------
    def step(self) -> PolicyResult:
        """One Algorithm-1 period: recompute and publish (P, rho)."""
        self._refresh_idx += 1
        T = self._time_matrix()
        live = ~np.all(~np.isfinite(T) | (T == 0), axis=1)
        # Connectivity mask consistent with ``live``: base topology minus
        # links to/from dead workers (Algorithm 3 then optimizes only over
        # the live subgraph instead of re-deriving liveness from inf times),
        # minus the failure-notification masks.
        conn = np.ones((self.n_workers, self.n_workers)) if self.d is None else self.d.copy()
        np.fill_diagonal(conn, 0.0)
        conn[~live, :] = 0.0
        conn[:, ~live] = 0.0
        self._failure_masks(conn)
        # Warm-start invalidation: the cached basis belongs to the previous
        # refresh's live edge set; if the set changed (a worker died or
        # rejoined, links were masked or revived), drop it — never re-thread
        # a basis across a membership change.
        key = connectivity_key(conn)
        if self._basis is not None and key != self._basis_key:
            self._basis = None
        self._basis_key = key
        res = generate_policy_matrix(
            self.alpha, self.K, self.R, T, d=conn, eps=self.eps,
            warm=self._basis,
        )
        self._basis = res.basis
        self._fail_wake = None
        self.policy = res
        self.history.append(
            dict(
                rho=res.rho,
                t_bar=res.t_bar,
                lambda2=res.lambda2,
                T_convergence=res.T_convergence,
                n_live=int(live.sum()),
                n_dead_links=len(self._fail_links),
                n_pivots=res.n_pivots,
                n_warm_used=res.n_warm_used,
            )
        )
        return res

    @property
    def live_workers(self) -> np.ndarray:
        return np.where(self._missed < self.dead_after)[0]
