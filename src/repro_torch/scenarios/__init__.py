"""Network-dynamics scenarios: declarative timelines of outages, link
degradation, and worker churn, compiled into the piecewise link-state
machine that ``core.nettime.LinkTimeModel`` executes; the seeded
generators (``presets``, ``hazard``) and control-plane fault injection
(``chaos``), copied from the JAX package's numpy modules."""

from repro_torch.scenarios import presets
from repro_torch.scenarios.chaos import ChaosError, ChaosInjector
from repro_torch.scenarios.hazard import HazardConfig, hazard_timeline, storm
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
    "ChaosError",
    "ChaosInjector",
    "ClusterOutage",
    "CompiledTimeline",
    "HazardConfig",
    "LinkDegrade",
    "ScenarioCursor",
    "Timeline",
    "WorkerLeave",
    "WorkerRejoin",
    "hazard_timeline",
    "presets",
    "storm",
]
