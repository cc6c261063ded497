"""Lazy-invalidation event queue shared by both async engine loops.

Both the reference loop (train/simulator.py) and the batched engine
(train/engine.py) schedule worker events on a binary heap of ``(time,
worker)`` entries, one live entry per worker.  Scenario churn used to
*eagerly* prune a departing worker's entry — an O(M) list rebuild plus
re-heapify per leave, which made the ``federated_cohorts`` preset's t=0
leave storm O(M^2) at boot.

``EventHeap`` keeps the heap untouched on a leave and marks the worker's
entry dead instead (O(1)); dead entries are discarded when they surface at
the top (``_prune``), so the total cost of a leave storm is O(M log M) —
the pops the eager path was paying anyway.  Event *order* is unchanged:
popping-and-skipping a dead entry consumes no RNG and advances no clock,
so the sequence of live events (and every ``peek_time`` a loop uses to
gate scenario/boundary decisions) is identical to the eager-prune
behaviour — tests/test_scenarios.py pins the equivalence on randomized
push/invalidate/pop schedules, and the engine-parity suites pin it end to
end through churn timelines.

Liveness is *entry identity*, not ``(time, worker)`` value: a worker that
leaves and rejoins has a fresh live entry while its pre-leave entry may
still be buried in the heap, and the two could even carry equal times.
``_live`` maps each worker to the exact tuple object that is current, so
the stale twin is recognized (``is``) and dropped when it surfaces.
"""

from __future__ import annotations

import heapq
import math


class EventHeap:
    """Min-heap of ``(time, worker)`` with O(1) worker invalidation."""

    __slots__ = ("_heap", "_live")

    def __init__(self):
        self._heap: list[tuple[float, int]] = []
        self._live: dict[int, tuple[float, int]] = {}

    def push(self, t: float, i: int) -> None:
        """Schedule worker ``i``'s next event at time ``t`` (the worker's
        previous entry, if any, becomes stale and is skipped on surfacing)."""
        e = (t, i)
        self._live[i] = e
        heapq.heappush(self._heap, e)

    def invalidate(self, i: int) -> None:
        """Drop worker ``i``'s scheduled event (churn leave).  O(1): the
        heap entry stays put and is discarded when it reaches the top."""
        self._live.pop(i, None)

    def _prune(self) -> None:
        h = self._heap
        while h and self._live.get(h[0][1]) is not h[0]:
            heapq.heappop(h)

    def peek_time(self) -> float:
        """Time of the next *live* event (inf when none are scheduled)."""
        self._prune()
        return self._heap[0][0] if self._heap else math.inf

    def pop(self) -> tuple[float, int]:
        """Pop the next live event; raises IndexError when empty."""
        self._prune()
        e = heapq.heappop(self._heap)
        del self._live[e[1]]
        return e

    def __len__(self) -> int:  # live entries only
        return len(self._live)

    def __bool__(self) -> bool:
        return bool(self._live)
