"""Deadline-aware admission control in front of the policy solve path.

``AdmissionController`` sits between callers (the RPC front-end, or
in-process tenants) and a ``PolicyServer``/``ShardRouter`` backend and
decides *which* requests get solver time when there is not enough of it
for everyone (DESIGN.md §19):

* **Bounded queue.**  At most ``max_queue`` requests wait at once.  When
  the queue is full, the worst pending entry — lowest priority class,
  then latest deadline — competes against the newcomer: whichever loses
  is shed immediately with the ladder's terminal ``ok=False`` uniform
  fallback (``PolicyServer._degraded``'s last rung, core/policy.py's
  AD-PSGD fallback).  Overload therefore displaces *low-priority slack*,
  never high-priority work.
* **EDF within priority class.**  Dispatch order is
  ``(priority, absolute deadline, arrival seq)`` — strict priority
  classes (smaller number = more urgent), earliest-deadline-first inside
  a class, FIFO among no-deadline peers.  Per-tenant default priorities
  are configured up front (``tenant_priority``) and overridable per
  request.
* **Shed-on-hopeless-deadline.**  At dispatch, an entry whose remaining
  deadline budget cannot cover the estimated service time (EWMA of
  observed service, headroom factor ``safety``) is shed rather than
  served late — a deadline violation costs the caller more than an
  honest ``ok=False`` (they keep their previous policy or fall back to
  uniform AD-PSGD locally).  This is what makes "zero deadline
  violations among admitted requests" a testable property.

Chaos seam: ``scenarios.chaos.ChaosInjector.injected_queue_delay_ms``
charges artificial queueing latency against an entry's deadline at
dispatch — charged *virtually* (never slept), so a seeded injector
deterministically steers chosen requests into the shed path while the
controller's real latency stays test-fast.

Shed answers never come from the backend: they are built here from the
normalized edge set, so a shed request costs zero solver/cache work.
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from dataclasses import dataclass, field

from repro_torch.core.policy import PolicyResult, uniform_policy
from repro_torch.serve.policy import normalize_instance


@dataclass
class AdmissionStats:
    """Counters for one ``AdmissionController`` (thread-safe bumps)."""

    n_submitted: int = 0
    n_served: int = 0
    n_shed_queue_full: int = 0
    n_shed_hopeless: int = 0
    n_displaced: int = 0
    n_deadline_violations: int = 0
    _lock: threading.Lock = field(
        init=False, repr=False, compare=False, default_factory=threading.Lock
    )

    def bump(self, name: str, k: int = 1) -> None:
        """Atomically increment counter ``name`` by ``k``."""
        with self._lock:
            setattr(self, name, getattr(self, name) + k)

    @property
    def n_shed(self) -> int:
        """Total requests answered with the shed uniform fallback."""
        return self.n_shed_queue_full + self.n_shed_hopeless

    def snapshot(self) -> dict:
        """Plain-dict view of all counters (for stats()/RPC)."""
        return {
            "n_submitted": self.n_submitted,
            "n_served": self.n_served,
            "n_shed_queue_full": self.n_shed_queue_full,
            "n_shed_hopeless": self.n_shed_hopeless,
            "n_shed": self.n_shed,
            "n_displaced": self.n_displaced,
            "n_deadline_violations": self.n_deadline_violations,
        }


class _Entry:
    """One queued request (identity-compared; ordered via its key)."""

    __slots__ = (
        "T", "d", "tenant", "priority", "deadline_ms", "t0",
        "charged_ms", "seq", "done", "result", "meta", "cancelled",
    )

    def __init__(self, T, d, tenant, priority, deadline_ms, seq):
        """Capture the request payload and stamp its arrival time."""
        self.T, self.d, self.tenant = T, d, tenant
        self.priority = priority
        self.deadline_ms = deadline_ms
        self.t0 = time.perf_counter()
        self.charged_ms = 0.0
        self.seq = seq
        self.done = threading.Event()
        self.result = None
        self.meta = None
        self.cancelled = False

    def key(self):
        """EDF ordering: (priority class, absolute deadline, arrival)."""
        dl = (
            self.t0 + self.deadline_ms / 1e3
            if self.deadline_ms is not None
            else float("inf")
        )
        return (self.priority, dl, self.seq)

    def elapsed_ms(self) -> float:
        """Wall time since submit plus virtually-charged chaos delay."""
        return (time.perf_counter() - self.t0) * 1e3 + self.charged_ms


class AdmissionController:
    """Bounded-queue EDF admission in front of a policy backend.

    ``backend`` is anything with the ``PolicyServer`` request surface
    (``request_meta``; a ``ShardRouter`` works unchanged).  ``workers``
    dispatcher threads drain the queue, so up to ``workers`` solves run
    concurrently while everything else waits in deadline order.  Use as
    a context manager or call ``close()`` — pending entries are shed on
    close, never abandoned.
    """

    def __init__(
        self,
        backend,
        max_queue: int = 64,
        workers: int = 2,
        default_priority: int = 1,
        tenant_priority: dict | None = None,
        safety: float = 2.0,
        service_ms_init: float = 10.0,
        ewma: float = 0.2,
        chaos=None,
    ):
        """Validate knobs and start the dispatcher threads."""
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        if safety < 1.0:
            raise ValueError(f"safety must be >= 1.0, got {safety}")
        if not (0.0 < ewma <= 1.0):
            raise ValueError(f"ewma must be in (0, 1], got {ewma}")
        self.backend = backend
        self.max_queue = int(max_queue)
        self.default_priority = int(default_priority)
        self.tenant_priority = dict(tenant_priority or {})
        self.safety = float(safety)
        self.ewma = float(ewma)
        self.chaos = chaos
        self.stats = AdmissionStats()
        self._service_ms = float(service_ms_init)
        self._seq = itertools.count()
        self._heap: list = []          # (key, entry), lazy-deleted
        self._n_pending = 0            # live (non-cancelled) queued entries
        self._cond = threading.Condition()
        self._closed = False
        self._threads = [
            threading.Thread(target=self._worker, daemon=True)
            for _ in range(int(workers))
        ]
        for t in self._threads:
            t.start()

    # -- lifecycle -----------------------------------------------------------
    def __enter__(self):
        """Context-manager entry (controller is already running)."""
        return self

    def __exit__(self, *exc):
        """Context-manager exit: drain and stop the dispatchers."""
        self.close()

    def close(self) -> None:
        """Stop dispatchers; shed (never abandon) still-queued entries."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            pending = [e for _, e in self._heap if not e.cancelled]
            self._heap.clear()
            self._n_pending = 0
            self._cond.notify_all()
        for e in pending:
            self._shed(e, "n_shed_queue_full")
        for t in self._threads:
            t.join(timeout=5.0)

    def invalidate(self, d) -> None:
        """Forward an edge-set invalidation to the backend (not queued).

        Invalidation is control-plane, not a solve: it runs immediately
        rather than competing with policy requests for queue slots.
        """
        self.backend.invalidate(d)

    # -- submission ----------------------------------------------------------
    def submit(self, T, d=None, tenant=None, priority=None,
               deadline_ms=None):
        """Queue one request; block until answered; never raise.

        Returns ``(result, meta)``.  ``meta["rung"]`` is the backend's
        rung (hit/coalesced/fresh/stale/uniform) for served requests or
        ``"shed"`` for requests the controller answered with the uniform
        ``ok=False`` fallback; ``meta["queued_ms"]`` is time spent
        waiting (including virtually-charged chaos delay).  ``priority``
        overrides the tenant's configured class (smaller = more urgent);
        ``deadline_ms`` is a relative deadline from submission.
        """
        if deadline_ms is not None and not deadline_ms > 0:
            raise ValueError(f"deadline_ms must be > 0, got {deadline_ms}")
        if priority is None:
            priority = self.tenant_priority.get(tenant, self.default_priority)
        entry = _Entry(T, d, tenant, int(priority), deadline_ms,
                       next(self._seq))
        self.stats.bump("n_submitted")
        with self._cond:
            if self._closed:
                self._shed_locked_free(entry, "n_shed_queue_full")
                return entry.result, entry.meta
            victim = None
            if self._n_pending >= self.max_queue:
                worst = max(
                    (e for _, e in self._heap if not e.cancelled),
                    key=lambda e: e.key(),
                    default=None,
                )
                if worst is not None and worst.key() > entry.key():
                    # Newcomer outranks the worst queued entry: displace.
                    worst.cancelled = True
                    self._n_pending -= 1
                    victim = worst
                    self.stats.bump("n_displaced")
                else:
                    self._shed_locked_free(entry, "n_shed_queue_full")
                    return entry.result, entry.meta
            heapq.heappush(self._heap, (entry.key(), entry))
            self._n_pending += 1
            self._cond.notify()
        if victim is not None:
            self._shed(victim, "n_shed_queue_full")
        entry.done.wait()
        return entry.result, entry.meta

    # -- shed path -----------------------------------------------------------
    def _uniform(self, d):
        """The ladder's terminal rung: AD-PSGD uniform, ``ok=False``."""
        P = uniform_policy(d)
        alpha = getattr(self.backend, "alpha", None)
        if alpha is None:  # ShardRouter: all shards share one config
            alpha = self.backend.servers[0].alpha
        rho = 0.25 / alpha / max(1.0, d.sum(axis=1).max())
        return PolicyResult(P, rho, 0.0, 1.0, float("inf"))

    def _shed(self, entry, counter: str) -> None:
        """Answer ``entry`` with the uniform fallback (no backend work)."""
        _, dn = normalize_instance(entry.T, entry.d)
        entry.result = self._uniform(dn)
        entry.meta = {
            "rung": "shed",
            "queued_ms": entry.elapsed_ms(),
            "priority": entry.priority,
        }
        self.stats.bump(counter)
        entry.done.set()

    def _shed_locked_free(self, entry, counter: str) -> None:
        """Shed without ever having queued (entry is thread-local)."""
        self._shed(entry, counter)

    # -- dispatch ------------------------------------------------------------
    def _pop(self):
        """Block for the next live entry (None once closed and drained)."""
        with self._cond:
            while True:
                while self._heap and self._heap[0][1].cancelled:
                    heapq.heappop(self._heap)
                if self._heap:
                    _, entry = heapq.heappop(self._heap)
                    self._n_pending -= 1
                    return entry
                if self._closed:
                    return None
                self._cond.wait()

    def _hopeless(self, entry) -> bool:
        """True when the remaining budget cannot cover estimated service."""
        if entry.deadline_ms is None:
            return False
        with self._cond:
            est = self._service_ms
        budget = entry.deadline_ms - entry.elapsed_ms()
        return budget < self.safety * est

    def _worker(self) -> None:
        while True:
            entry = self._pop()
            if entry is None:
                return
            if self.chaos is not None:
                entry.charged_ms += self.chaos.injected_queue_delay_ms()
            if self._hopeless(entry):
                self._shed(entry, "n_shed_hopeless")
                continue
            queued_ms = entry.elapsed_ms()
            try:
                res, meta = self.backend.request_meta(
                    entry.T, d=entry.d, tenant=entry.tenant
                )
            except Exception:
                # The backend is total by contract; this is belt-and-
                # braces so a dispatcher thread can never die silently.
                self._shed(entry, "n_shed_hopeless")
                continue
            served_ms = meta.get("ms", 0.0)
            with self._cond:
                self._service_ms += self.ewma * (served_ms - self._service_ms)
            meta["queued_ms"] = queued_ms
            meta["priority"] = entry.priority
            total_ms = entry.elapsed_ms()
            if entry.deadline_ms is not None and total_ms > entry.deadline_ms:
                self.stats.bump("n_deadline_violations")
                meta["deadline_violated"] = True
            entry.result = res
            entry.meta = meta
            self.stats.bump("n_served")
            entry.done.set()
