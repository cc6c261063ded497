"""Network-dynamics scenarios: declarative timelines of outages, link
degradation, and worker churn, compiled into the piecewise link-state
machine that ``core.nettime.LinkTimeModel`` executes.

Ported so far: ``timeline`` and the engines' shared ``driver``.  The
seeded generators (``presets``, ``hazard``) and ``chaos`` are ROADMAP A1
work still open."""

from repro_torch.scenarios.timeline import (
    ACTION_EVENTS,
    ClusterOutage,
    CompiledTimeline,
    LinkDegrade,
    ScenarioCursor,
    Timeline,
    WorkerLeave,
    WorkerRejoin,
)

__all__ = [
    "ACTION_EVENTS",
    "ClusterOutage",
    "CompiledTimeline",
    "LinkDegrade",
    "ScenarioCursor",
    "Timeline",
    "WorkerLeave",
    "WorkerRejoin",
]
