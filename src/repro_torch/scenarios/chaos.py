"""Deterministic fault injection for control-plane robustness tests.

``ChaosInjector`` is the seeded seam through which tests and benchmarks
exercise the degraded-mode machinery without any real failure happening:

* **solver faults** — ``maybe_fail_solver()`` raises ``ChaosError`` with
  probability ``solver_fail_rate`` per attempt; ``solver_delay_ms()``
  injects artificial latency that counts against a ``PolicyServer``
  deadline (the serve degradation ladder: retry -> stale -> uniform,
  DESIGN.md §18).
* **dropped Monitor reports** — ``drop_report(worker, t)`` decides
  whether a worker's EMA report is lost on the way to the Monitor this
  refresh (``report_drop_rate``).
* **admission-queue delay** — ``injected_queue_delay_ms()`` charges
  artificial queueing latency against a request's deadline before the
  ``serve.admission`` controller dispatches it (``queue_delay_rate``),
  deterministically steering chosen requests into the hopeless-deadline
  shed path.
* **delayed policy publishes** — ``publish_lost(t, period)`` models a
  publish delayed past the point of usefulness: a delay drawn beyond the
  refresh period is superseded by the next refresh before it lands, so
  the workers keep their stale rows (``scenarios.driver.monitor_boundary``
  treats it as a lost publish and counts it here).

Each channel draws from its own ``np.random.default_rng`` stream (spawned
from one ``SeedSequence``), so e.g. raising the solver fault rate never
perturbs the report-drop decisions.  Determinism is per *call order*: two
runs that make the same sequence of calls see the same faults — which is
exactly the situation for the reference and batched engines, whose shared
``monitor_boundary`` makes identical calls at identical virtual times, so
engine parity survives chaos injection.  Reuse one injector across runs
and the streams continue where they left off; build a fresh one per run
when comparing runs.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


class ChaosError(RuntimeError):
    """Injected failure (distinguishable from real solver errors)."""


@dataclass
class ChaosInjector:
    """Seeded fault-injection harness (module docstring)."""

    seed: int = 0
    solver_fail_rate: float = 0.0
    solver_delay_rate: float = 0.0
    solver_delay_ms: float = 0.0
    report_drop_rate: float = 0.0
    publish_delay_rate: float = 0.0
    # Injected publish delay, in units of the Monitor refresh period; >= 1
    # means the publish is superseded before it lands (treated as lost).
    publish_delay_periods: float = 1.0
    # Admission-queue channel (serve.admission): artificial queueing
    # latency charged against a request's deadline before it is served.
    queue_delay_rate: float = 0.0
    queue_delay_ms: float = 0.0
    # Fault counters (surfaced by tests/benchmarks next to ServeStats).
    n_solver_faults: int = field(init=False, default=0)
    n_injected_delays: int = field(init=False, default=0)
    n_dropped_reports: int = field(init=False, default=0)
    n_lost_publishes: int = field(init=False, default=0)
    n_queue_delays: int = field(init=False, default=0)

    def __post_init__(self):
        for name in (
            "solver_fail_rate",
            "solver_delay_rate",
            "report_drop_rate",
            "publish_delay_rate",
            "queue_delay_rate",
        ):
            p = getattr(self, name)
            if not (0.0 <= p <= 1.0):
                raise ValueError(f"{name} must be in [0, 1], got {p}")
        # Spawned children are deterministic by index, so appending the
        # queue stream leaves the first four channels' draws untouched —
        # existing seeded tests/benchmarks see identical fault schedules.
        solver, delay, report, publish, queue = (
            np.random.default_rng(s)
            for s in np.random.SeedSequence(self.seed).spawn(5)
        )
        self._solver_rng = solver
        self._delay_rng = delay
        self._report_rng = report
        self._publish_rng = publish
        self._queue_rng = queue

    # -- solver channel (PolicyServer) --------------------------------------
    def maybe_fail_solver(self) -> None:
        """Raise ``ChaosError`` for this solve attempt with the configured
        probability (each retry re-rolls, so bounded retry can recover)."""
        if self.solver_fail_rate and self._solver_rng.uniform() < self.solver_fail_rate:
            self.n_solver_faults += 1
            raise ChaosError("injected solver failure")

    def injected_delay_ms(self) -> float:
        """Artificial solve latency charged against the serve deadline."""
        if (
            self.solver_delay_rate
            and self._delay_rng.uniform() < self.solver_delay_rate
        ):
            self.n_injected_delays += 1
            return float(self.solver_delay_ms)
        return 0.0

    # -- admission-queue channel (serve.admission) ---------------------------
    def injected_queue_delay_ms(self) -> float:
        """Artificial queueing latency charged against a request deadline.

        Drawn by ``AdmissionController`` when an entry is dequeued; like
        the solver delay it is charged *virtually* (never slept), so a
        seeded injector pushes specific requests past their deadline —
        deterministically — to exercise the hopeless-deadline shed path.
        """
        if (
            self.queue_delay_rate
            and self._queue_rng.uniform() < self.queue_delay_rate
        ):
            self.n_queue_delays += 1
            return float(self.queue_delay_ms)
        return 0.0

    # -- Monitor control-plane channels -------------------------------------
    def drop_report(self, worker: int, t: float) -> bool:
        """True when ``worker``'s EMA report is lost this refresh."""
        if self.report_drop_rate and self._report_rng.uniform() < self.report_drop_rate:
            self.n_dropped_reports += 1
            return True
        return False

    def publish_lost(self, t: float, period: float) -> bool:
        """True when this refresh's policy publish is delayed past the next
        refresh (and therefore never lands; workers keep stale rows)."""
        if not self.publish_delay_rate:
            return False
        if self._publish_rng.uniform() < self.publish_delay_rate:
            if self.publish_delay_periods >= 1.0:
                self.n_lost_publishes += 1
                return True
        return False
