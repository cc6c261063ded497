"""Declarative network-dynamics timelines (DESIGN.md §14).

A ``Timeline`` is a plain list of scheduled events over *virtual* time:

* ``ClusterOutage``   — WAN (``inter_cluster``) links touching one cluster
  are dead during ``[start, end)`` (paper §V: a whole cluster drops off
  the wide-area network; the Monitor must re-route around it).
  ``direction`` narrows the cut: ``"out"`` kills only pulls *originating*
  in the cluster, ``"in"`` only pulls *targeting* it, ``"both"`` (default)
  kills both directions.
* ``LinkDegrade``     — one link's transfer time is multiplied by
  ``factor`` during ``[start, end)`` (bandwidth degradation/restoration).
* ``WorkerLeave`` / ``WorkerRejoin`` — elastic churn: a departed worker
  generates no events, all its links are dead, and on rejoin its replica is
  reseeded from a live neighbor (``train/elastic.py``).

``Timeline.compile(topology)`` turns the event list into an immutable
piecewise **link-state machine**: a sorted sequence of segments, each
holding *sparse* directed link state — per-worker dead flags, per-cluster
WAN-outage flags, and a degraded-edge map, O(M) per segment instead of
(M, M) — plus the sorted churn *actions* the simulation loops must apply
(heap membership and replica reseeding are loop-side effects; pure link
state is not).  Dense ``Segment.dead`` / ``Segment.degrade`` matrices are
still available as lazily-materialized views for dense consumers
(``LinkTimeModel.matrix``, tests); fleet-scale hot paths use the O(1)
``Segment.link_dead`` / ``Segment.degrade_factor`` queries and never
allocate (M, M).

The compiled form is runtime-free: ``LinkTimeModel`` keeps its own segment
pointer (advanced by ``advance_to``) and every engine loop walks its own
``ScenarioCursor``, so one compiled timeline can drive any number of
independent, bit-identical runs.

Everything here is deterministic and consumes **no RNG** — scenario state
is a pure function of virtual time, which is what keeps the reference and
batched engines bit-exact on the same timeline (tests/test_engines.py).
Seedable *generation* of timelines lives in ``repro.scenarios.presets``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass(frozen=True)
class ClusterOutage:
    """``inter_cluster`` links touching ``cluster`` are dead during
    ``[start, end)``; intra-cluster links keep working.  ``direction``
    selects which directed links die: ``"out"`` — pulls *by* the cluster's
    workers across the WAN; ``"in"`` — pulls *from* the cluster by outside
    workers; ``"both"`` (default) — the symmetric cut."""

    cluster: int
    start: float
    end: float
    direction: str = "both"


@dataclass(frozen=True)
class LinkDegrade:
    """Multiply the transfer time of link (i, m) by ``factor`` during
    ``[start, end)``; ``symmetric`` applies it to both directions."""

    i: int
    m: int
    start: float
    end: float
    factor: float
    symmetric: bool = True


@dataclass(frozen=True)
class WorkerLeave:
    """Worker departs at ``time``: no more events, all its links dead."""

    worker: int
    time: float


@dataclass(frozen=True)
class WorkerRejoin:
    """Worker returns at ``time``; its replica is reseeded from
    ``seed_from`` (default: the lowest-indexed active worker)."""

    worker: int
    time: float
    seed_from: int | None = None


#: Churn event types the simulation loops must act on (vs pure link state).
ACTION_EVENTS = (WorkerLeave, WorkerRejoin)


class Segment:
    """One piece of the piecewise link state: valid on [start, next start).

    Link state is **sparse** — O(M + n_clusters + #degraded-edges) per
    segment, never (M, M):

    * ``dead_out[i]``  — every link *from* worker ``i`` is dead (churn).
    * ``dead_in[m]``   — every link *to* worker ``m`` is dead (churn).
    * ``wan_out[c]``   — WAN pulls *by* workers in cluster ``c`` are dead.
    * ``wan_in[c]``    — WAN pulls *from* cluster ``c`` are dead.
    * ``degrade_map``  — ``{(i, m): factor}`` for degraded directed links.

    Directed link i->m is dead iff ``dead_out[i] or dead_in[m]`` or the
    endpoints sit in different clusters and ``wan_out[cluster[i]] or
    wan_in[cluster[m]]``.  The dense ``.dead`` / ``.degrade`` matrices
    materialize lazily for dense consumers (``LinkTimeModel.matrix``,
    tests); fleet-scale hot paths use ``link_dead`` / ``degrade_factor``
    and never allocate (M, M).
    """

    __slots__ = (
        "start", "dead_out", "dead_in", "wan_out", "wan_in",
        "degrade_map", "cluster", "_dead_dense", "_degrade_dense",
    )

    def __init__(
        self, start, dead_out, dead_in, wan_out, wan_in, degrade_map, cluster
    ):
        self.start = float(start)
        self.dead_out = dead_out  # (M,) bool
        self.dead_in = dead_in  # (M,) bool
        self.wan_out = wan_out  # (n_clusters,) bool
        self.wan_in = wan_in  # (n_clusters,) bool
        self.degrade_map = degrade_map  # {(i, m): float}
        self.cluster = cluster  # (M,) int, shared across segments
        self._dead_dense = None
        self._degrade_dense = None

    # -- O(1) directed queries (the fleet-scale hot path) --------------------
    def link_dead(self, i: int, m: int) -> bool:
        if i == m:
            return False
        if self.dead_out[i] or self.dead_in[m]:
            return True
        ci, cm = self.cluster[i], self.cluster[m]
        return bool(ci != cm and (self.wan_out[ci] or self.wan_in[cm]))

    def degrade_factor(self, i: int, m: int) -> float:
        return self.degrade_map.get((i, m), 1.0)

    @property
    def nbytes(self) -> int:
        """Host memory held by this segment's link state (O(M), pinned by
        the fleet-scale regression test)."""
        arrays = (self.dead_out, self.dead_in, self.wan_out, self.wan_in)
        return sum(a.nbytes for a in arrays) + 64 * len(self.degrade_map)

    # -- dense views (lazy; Monitor/matrix()/test paths only) ----------------
    @property
    def dead(self) -> np.ndarray:
        """(M, M) bool, directed: link i->m is dead.  Materialized lazily —
        O(M^2); never touched by the event loops."""
        if self._dead_dense is None:
            c = self.cluster
            wan = c[:, None] != c[None, :]
            dead = (
                self.dead_out[:, None]
                | self.dead_in[None, :]
                | (wan & (self.wan_out[c][:, None] | self.wan_in[c][None, :]))
            )
            np.fill_diagonal(dead, False)
            self._dead_dense = dead
        return self._dead_dense

    @property
    def degrade(self) -> np.ndarray:
        """(M, M) float multiplier on transfer time (lazy dense view)."""
        if self._degrade_dense is None:
            M = len(self.dead_out)
            degrade = np.ones((M, M))
            for (i, m), f in self.degrade_map.items():
                degrade[i, m] = f
            self._degrade_dense = degrade
        return self._degrade_dense


@dataclass(frozen=True)
class CompiledTimeline:
    """Immutable compiled form; see module docstring."""

    n_workers: int
    segments: tuple  # Segment, ascending start; segments[0].start == -inf
    actions: tuple  # churn events sorted by (time, worker-leave-first)
    boundaries: tuple  # every distinct event time (window-split points)
    events: tuple  # the original declarative events, for introspection

    def segment_index(self, now: float, hint: int = 0) -> int:
        """Index of the segment containing ``now`` (monotonic ``hint``
        makes repeated forward queries O(1) amortized)."""
        k = hint
        segs = self.segments
        while k + 1 < len(segs) and now >= segs[k + 1].start:
            k += 1
        return k

    def dead_intervals(self, i: int, m: int) -> tuple:
        """Maximal ``[start, end)`` windows during which directed link
        i->m is scenario-dead.  Every ``timeout`` record a traced run
        (repro.trace) carries for that link must start inside one of these
        windows — the cross-check tests/test_trace.py pins."""
        out = []
        open_start = None
        for seg in self.segments:
            dead = seg.link_dead(i, m)
            if dead and open_start is None:
                open_start = seg.start
            elif not dead and open_start is not None:
                out.append((open_start, seg.start))
                open_start = None
        if open_start is not None:
            out.append((open_start, float("inf")))
        return tuple(out)

    @property
    def nbytes(self) -> int:
        """Total host memory of the compiled link state — O(M) per segment
        (the fleet-scale memory regression pin sums this)."""
        return sum(seg.nbytes for seg in self.segments)

    def active_workers(self, now: float) -> np.ndarray:
        """Workers present at ``now`` (before applying actions at ``now``
        itself: an action at exactly ``now`` counts as already fired,
        matching the loops' fire-before-the-crossing-event convention)."""
        active = np.ones(self.n_workers, dtype=bool)
        for act in self.actions:
            if act.time > now:
                break
            active[act.worker] = isinstance(act, WorkerRejoin)
        return active


class ScenarioCursor:
    """A loop's private walk over a compiled timeline's boundaries.

    The engines use two operations, both pure host logic so the reference
    and batched loops stay bit-identical:

    * ``next_time`` — the earliest unprocessed boundary.  The batched
      engine flushes its current window/round block before this time, so
      no fused cohort or scan chain ever spans a scenario boundary.
    * ``pop_due(t)`` — consume every boundary with time <= ``t`` (the next
      unit of work's start time) and return the churn actions among them,
      in order.  Link-state boundaries return nothing (the LinkTimeModel
      advances itself); they still split windows.
    """

    def __init__(self, compiled: CompiledTimeline):
        self._boundaries = compiled.boundaries
        self._actions = compiled.actions
        self._bi = 0
        self._ai = 0

    @property
    def next_time(self) -> float:
        if self._bi >= len(self._boundaries):
            return float("inf")
        return self._boundaries[self._bi]

    def pop_due(self, t: float) -> list:
        while self._bi < len(self._boundaries) and self._boundaries[self._bi] <= t:
            self._bi += 1
        due = []
        while self._ai < len(self._actions) and self._actions[self._ai].time <= t:
            due.append(self._actions[self._ai])
            self._ai += 1
        return due


@dataclass
class Timeline:
    """Declarative event list; ``compile`` validates and freezes it."""

    events: list = field(default_factory=list)

    def add(self, *events) -> "Timeline":
        self.events.extend(events)
        return self

    # -- validation ---------------------------------------------------------
    def _validate(self, topology) -> None:
        M = topology.n_workers
        nc = topology.n_clusters
        pending: dict[int, bool] = {}  # worker -> currently departed
        # Overlap detection per failure domain: two events occupying the
        # same directed domain over intersecting [start, end) windows would
        # compile into an ambiguous segment machine (outage flags OR
        # silently, degrade factors *multiply* silently) — reject loudly
        # instead.  Domains: (cluster, wan-direction) for outages, the
        # directed link (i, m) for degrades (a symmetric degrade occupies
        # both directions).
        outage_spans: dict[tuple, list] = {}
        degrade_spans: dict[tuple, list] = {}
        # Same (time, rank) order compile() and the runtime use — equal-time
        # leaves fire before rejoins, and validation must see that order.
        for e in sorted(self.events, key=lambda e: (_event_time(e), _event_rank(e))):
            if isinstance(e, ClusterOutage):
                if not (0 <= e.cluster < nc):
                    raise ValueError(
                        f"ClusterOutage cluster {e.cluster} out of range "
                        f"(topology has {nc} clusters)"
                    )
                if not (np.isfinite(e.start) and e.start >= 0 and e.start < e.end):
                    raise ValueError(f"ClusterOutage needs 0 <= start < end, got {e}")
                if e.direction not in ("both", "out", "in"):
                    raise ValueError(
                        f"ClusterOutage direction must be 'both', 'out' or "
                        f"'in', got {e.direction!r}"
                    )
                dirs = ("out", "in") if e.direction == "both" else (e.direction,)
                for dr in dirs:
                    _note_span(
                        outage_spans,
                        (e.cluster, dr),
                        e,
                        f"cluster {e.cluster} WAN-{dr} outage",
                    )
            elif isinstance(e, LinkDegrade):
                if not (0 <= e.i < M and 0 <= e.m < M and e.i != e.m):
                    raise ValueError(f"LinkDegrade endpoints invalid: {e}")
                if not (e.factor > 0 and np.isfinite(e.factor)):
                    raise ValueError(f"LinkDegrade factor must be finite > 0: {e}")
                if not (np.isfinite(e.start) and e.start >= 0 and e.start < e.end):
                    raise ValueError(f"LinkDegrade needs 0 <= start < end, got {e}")
                links = ((e.i, e.m), (e.m, e.i)) if e.symmetric else ((e.i, e.m),)
                for lk in links:
                    _note_span(degrade_spans, lk, e, f"link {lk[0]}->{lk[1]} degrade")
            elif isinstance(e, WorkerLeave):
                if not (0 <= e.worker < M) or not (np.isfinite(e.time) and e.time >= 0):
                    raise ValueError(f"WorkerLeave worker/time invalid: {e}")
                if pending.get(e.worker, False):
                    raise ValueError(f"worker {e.worker} leaves twice without a rejoin")
                pending[e.worker] = True
            elif isinstance(e, WorkerRejoin):
                if not (0 <= e.worker < M) or not (np.isfinite(e.time) and e.time >= 0):
                    raise ValueError(f"WorkerRejoin worker/time invalid: {e}")
                if e.seed_from is not None and not (
                    0 <= e.seed_from < M and e.seed_from != e.worker
                ):
                    raise ValueError(f"WorkerRejoin seed_from invalid: {e}")
                if not pending.get(e.worker, False):
                    raise ValueError(f"worker {e.worker} rejoins without having left")
                pending[e.worker] = False
            else:
                raise TypeError(f"unknown scenario event {e!r}")

    # -- compilation --------------------------------------------------------
    def compile(self, topology) -> CompiledTimeline:
        """Freeze into the piecewise link-state machine (module docstring)."""
        self._validate(topology)
        M = topology.n_workers
        events = tuple(
            sorted(self.events, key=lambda e: (_event_time(e), _event_rank(e)))
        )
        actions = tuple(e for e in events if isinstance(e, ACTION_EVENTS))

        times = set()
        for e in events:
            if isinstance(e, ACTION_EVENTS):
                times.add(float(e.time))
            else:
                times.add(float(e.start))
                times.add(float(e.end))
        boundaries = tuple(sorted(t for t in times if np.isfinite(t)))

        # Churn compiles to dead-link intervals too: a departed worker's
        # links are down from leave to rejoin (or forever).
        churn_intervals: list[tuple[int, float, float]] = []
        open_since: dict[int, float] = {}
        for a in actions:
            if isinstance(a, WorkerLeave):
                open_since[a.worker] = a.time
            else:
                churn_intervals.append((a.worker, open_since.pop(a.worker), a.time))
        for w, t0 in open_since.items():
            churn_intervals.append((w, t0, float("inf")))

        # Sparse link state needs only the cluster id per worker — the old
        # dense (M, M) WAN mask is recovered lazily by Segment.dead.
        cluster = np.array([topology.cluster_of(i) for i in range(M)])
        nc = topology.n_clusters

        def state_at(t0: float) -> Segment:
            dead_out = np.zeros(M, dtype=bool)
            dead_in = np.zeros(M, dtype=bool)
            wan_out = np.zeros(nc, dtype=bool)
            wan_in = np.zeros(nc, dtype=bool)
            degrade_map: dict[tuple[int, int], float] = {}
            for e in events:
                if isinstance(e, ClusterOutage) and e.start <= t0 < e.end:
                    if e.direction in ("both", "out"):
                        wan_out[e.cluster] = True
                    if e.direction in ("both", "in"):
                        wan_in[e.cluster] = True
                elif isinstance(e, LinkDegrade) and e.start <= t0 < e.end:
                    key = (e.i, e.m)
                    degrade_map[key] = degrade_map.get(key, 1.0) * e.factor
                    if e.symmetric:
                        rkey = (e.m, e.i)
                        degrade_map[rkey] = degrade_map.get(rkey, 1.0) * e.factor
            for w, a, b in churn_intervals:
                if a <= t0 < b:
                    dead_out[w] = True
                    dead_in[w] = True
            return Segment(
                t0, dead_out, dead_in, wan_out, wan_in, degrade_map, cluster
            )

        # Segment 0 covers (-inf, first boundary): nothing is active yet.
        pre = boundaries[0] - 1.0 if boundaries else 0.0
        seg0 = state_at(pre)
        seg0.start = float("-inf")
        segments = (seg0,) + tuple(state_at(s) for s in boundaries)

        # A timeline must never depopulate the run, and every automatic
        # rejoin needs a live reseed source — validated by replaying the
        # actions in the exact runtime order (equal-time leaves fire before
        # rejoins; the active set may be empty transiently *within* one
        # instant, but never after it, and a rejoin's automatic source is
        # whatever is live at its own fire point).
        live = set(range(M))
        for k, a in enumerate(actions):
            if isinstance(a, WorkerLeave):
                live.discard(a.worker)
            else:
                if a.seed_from is None and not (live - {a.worker}):
                    raise ValueError(
                        f"worker {a.worker} rejoins at t={a.time} with no "
                        "live worker to reseed from"
                    )
                live.add(a.worker)
            group_ends = k + 1 == len(actions) or actions[k + 1].time != a.time
            if group_ends and not live:
                raise ValueError(
                    f"timeline leaves zero active workers at t={a.time}"
                )

        return CompiledTimeline(
            n_workers=M,
            segments=segments,
            actions=actions,
            boundaries=boundaries,
            events=events,
        )


def _note_span(spans: dict, domain, e, what: str) -> None:
    """Record ``e``'s [start, end) against ``domain``; raise on overlap.

    Events arrive in ascending start order (the caller iterates the sorted
    list), so overlap with the previous span on the same domain is the
    only case to check — half-open windows may abut (a.end == b.start)."""
    prev = spans.get(domain)
    if prev is not None and e.start < prev[1]:
        raise ValueError(
            f"overlapping same-domain events: {what} [{e.start}, {e.end}) "
            f"overlaps an earlier event on the same domain "
            f"[{prev[0]}, {prev[1]})"
        )
    if prev is None or e.end > prev[1]:
        spans[domain] = (e.start, e.end)


def _event_time(e) -> float:
    return float(e.time if isinstance(e, ACTION_EVENTS) else e.start)


def _event_rank(e) -> int:
    """Equal-time determinism: leaves before rejoins, link events last."""
    if isinstance(e, WorkerLeave):
        return 0
    if isinstance(e, WorkerRejoin):
        return 1
    return 2
