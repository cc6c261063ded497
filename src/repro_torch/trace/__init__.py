"""repro_torch.trace — trace-driven replay, calibration, and what-if analysis.

The simulator's wall-clock claims come from a *modeled* link-time process
(core/nettime.py).  This package closes the loop with measured timelines
(DESIGN.md §15):

* ``schema``    — versioned per-event trace records + JSONL/CSV ingest,
  including loaders for externally-measured timelines;
* ``export``    — Chrome-trace / Perfetto JSON from a traced ``SimResult``
  (per-worker tracks, Monitor refreshes as instant events);
* ``calibrate`` — fit ``LinkTimeModel`` parameters (tier base times,
  compute time, jitter spread, per-directed-link WAN skew) from a trace
  with robust estimators and a reported residual;
* ``replay``    — a trace-backed time source plugged into the
  ``LinkTimeModel.time_source`` seam: measured durations replayed by
  directed link in order, calibrated-model fallback past the horizon;
* ``whatif``    — wall-clock / time-to-loss deltas for mutations of a
  calibrated baseline (upgrade a WAN link, move a worker, switch
  algorithm).

``python -m repro_torch.trace FILE`` summarizes any trace file.
"""

from repro_torch.trace.calibrate import CalibrationResult, calibrate
from repro_torch.trace.export import chrome_trace, write_chrome_trace
from repro_torch.trace.replay import ReplayLinkSource, replay_model
from repro_torch.trace.schema import (
    KINDS,
    SCHEMA,
    Trace,
    TraceRecord,
    from_sim_result,
    load_trace,
    read_csv,
    read_jsonl,
    write_jsonl,
)
from repro_torch.trace.whatif import (
    MoveWorker,
    SwitchAlgorithm,
    UpgradeLink,
    WhatIf,
    WhatIfReport,
)

__all__ = [
    "KINDS",
    "SCHEMA",
    "CalibrationResult",
    "MoveWorker",
    "ReplayLinkSource",
    "SwitchAlgorithm",
    "Trace",
    "TraceRecord",
    "UpgradeLink",
    "WhatIf",
    "WhatIfReport",
    "calibrate",
    "chrome_trace",
    "from_sim_result",
    "load_trace",
    "read_csv",
    "read_jsonl",
    "replay_model",
    "write_chrome_trace",
    "write_jsonl",
]
