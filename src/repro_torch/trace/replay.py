"""Trace-backed time source for the ``LinkTimeModel.time_source`` seam.

``ReplayLinkSource`` hands back *measured* durations: per directed link, in
recorded order, one per ``network_time`` query.  Once a link's recordings
run out (past the trace horizon) it returns None and the model — normally
the calibrated one — takes over.  Scenario dead-link semantics are
untouched: ``LinkTimeModel`` resolves dead links *before* consulting the
source, exactly as the original run priced its timeouts without drawing
link times (timeout records are therefore excluded from the replay queues
by default — reattach the scenario to regenerate them).

Why same-seed replay is exact (pinned by tests/test_trace.py): peer
selection and batch draws come from the simulator rng, jitter from the
model's private rng — a served duration consumes neither, so the streams
stay aligned; serving event k its recorded link time reproduces its heap
reschedule time exactly, hence the same pop order, hence (by induction)
the same peer/batch draws for every later event.  Each async record
carries ``net`` — the *raw* ``iteration_time`` the event drew, before any
strategy multiplier — and the seam feeds ``iteration_time = max(C,
served)`` back into ``event_timing``, which re-applies ps-async's
congestion multiplier and netmax-topk's wire ratio deterministically.
Raw values are already ``max(C, N)``, so the max is idempotent and the
duration and its comm/compute split round-trip bit-exactly for **all
eight strategies**.  Legacy traces without ``net`` fall back to the
recorded event duration, which equals the raw link time for the
unit-multiplier gossip family (the pre-``net`` exactness contract) and
degrades to a link-conditions replay for ps-async/netmax-topk.

Synchronous strategies replay exactly too, by a different route: the
traced round loop taps every raw per-link network time a round queries
(see ``traced_round_timing``), ``round_timing`` queries links in a fixed
deterministic order, and the per-link FIFO queues here serve those draws
back in that order — so the recomputed round durations (congestion and
ring aggregation included, both deterministic) match bit-exactly.
"""

from __future__ import annotations

from collections import deque

import numpy as np

from repro_torch.core.nettime import LinkTimeModel
from repro_torch.trace.schema import Trace


class ReplayLinkSource:
    """Serve measured per-link durations in order; None past the horizon."""

    def __init__(self, trace: Trace, include_timeouts: bool = False):
        kinds = ("pull", "timeout") if include_timeouts else ("pull",)
        by_link = trace.by_link(kinds=kinds)
        # Serve the raw link time (``net``) when the record carries one —
        # event_timing re-applies any strategy multiplier on top — and the
        # event duration for legacy records (exact for gossip, where the
        # two coincide).
        self._queues = {
            lk: deque(
                r.duration if r.net is None else r.net for r in v
            ) for lk, v in by_link.items()
        }
        self._median = {
            lk: float(
                np.median([r.duration if r.net is None else r.net for r in v])
            )
            for lk, v in by_link.items()
        }
        self.horizon = trace.horizon
        self.served = 0
        self.fallbacks = 0

    # -- LinkTimeModel seam --------------------------------------------------
    def network_time(self, i: int, m: int, now: float):
        q = self._queues.get((i, m))
        if q:
            self.served += 1
            return q.popleft()
        self.fallbacks += 1
        return None

    def expected(self, i: int, m: int, now: float):
        """Non-consuming estimate for ``LinkTimeModel.matrix``."""
        return self._median.get((i, m))

    # -- introspection / what-if hooks --------------------------------------
    def remaining(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def scale_link(self, i: int, m: int, factor: float,
                   floor: float = 0.0) -> None:
        """Multiply the link's queued durations (and its estimate) by
        ``factor`` — a what-if link upgrade/downgrade applied to the
        measured timeline itself.  ``floor`` clamps from below (durations
        are event times, so a compute floor keeps them physical)."""
        if factor <= 0:
            raise ValueError(f"scale factor must be positive, got {factor}")
        q = self._queues.get((i, m))
        if q is not None:
            self._queues[(i, m)] = deque(max(floor, d * factor) for d in q)
            self._median[(i, m)] = max(floor, self._median[(i, m)] * factor)

    def drop_worker(self, w: int) -> None:
        """Forget every measurement touching worker ``w`` (a what-if move:
        its old links no longer exist, the model prices the new ones)."""
        for lk in [lk for lk in self._queues if w in lk]:
            del self._queues[lk]
            del self._median[lk]

    def links(self):
        return sorted(self._queues)


def replay_model(
    trace: Trace,
    calibration=None,
    include_timeouts: bool = False,
    **model_kwargs,
) -> LinkTimeModel:
    """A ``LinkTimeModel`` that replays ``trace`` and falls back to the
    calibrated model past the horizon.

    ``calibration`` is a ``CalibrationResult`` (fitted here from the trace
    when omitted); its model's parameters seed the fallback.  Keyword
    overrides (``seed=``, ``scenario=``, ...) win over calibrated values.
    """
    if calibration is None:
        from repro_torch.trace.calibrate import calibrate

        calibration = calibrate(trace)
    base = calibration.model
    kwargs = dict(
        compute_time=base.compute_time,
        base_times=dict(base.base_times),
        jitter=base.jitter,
        slowdown_range=base.slowdown_range,
        seed=base.seed,
        link_scale=None if base.link_scale is None else base.link_scale.copy(),
    )
    kwargs.update(model_kwargs)
    return LinkTimeModel(
        base.topology,
        time_source=ReplayLinkSource(trace, include_timeouts=include_timeouts),
        **kwargs,
    )
