"""Fit LinkTimeModel parameters from an ingested trace (DESIGN.md §15).

Estimators are deliberately robust — medians and MADs, never means — so
the transient artifacts the model itself injects (the 2x-100x roaming slow
link, WAN congestion waves, timeout stalls) cannot drag the fit:

* compute time   — median ``local`` duration (a compute-only event costs
  exactly C); falls back to the minimum observed duration;
* tier bases     — per-directed-link median pull duration, then the median
  over links within each tier; missing tiers are filled from the default
  model's tier ratios; a final cummax clamp restores the documented
  ``TIERS`` ordering invariant;
* jitter         — 1.4826 * MAD of log-residuals around each link's own
  median (the lognormal sigma a robust estimator sees), from links whose
  median clears the compute floor (censored links carry no spread info);
* per-link skew  — ``link_scale`` entries for inter_cluster (WAN) directed
  links whose median deviates from the tier base (the paper's measured
  WAN asymmetry), 1.0 elsewhere.

Durations recorded by the simulator are event times max(C, N): links whose
transfer is faster than compute are *censored* — their base time is only
known to be <= C.  Calibration records those tiers in ``censored_tiers``
and pins their base at the observed median, which leaves every
``iteration_time`` query identical (the max() floor hides the difference).

The returned model disables the synthetic perturbations (no roaming slow
link) — measured traces already embed whatever slowness really happened.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.nettime import TIERS, LinkTimeModel, Topology
from repro_torch.trace.schema import Trace

#: Relative clearance over the compute floor below which a link's median is
#: treated as censored (duration == C tells us nothing about N).
_CENSOR_EPS = 1e-6


@dataclass
class CalibrationResult:
    model: LinkTimeModel
    compute_time: float
    base_times: dict
    jitter: float
    link_scale: np.ndarray
    #: median relative |observed - predicted| / observed over uncensored pulls
    residual: float
    n_pulls: int
    censored_tiers: tuple = ()
    per_link_median: dict = field(default_factory=dict)

    def summary(self) -> str:
        bt = ", ".join(f"{t}={self.base_times[t]:.4g}" for t in TIERS)
        return (
            f"calibrated from {self.n_pulls} pulls: compute="
            f"{self.compute_time:.4g}s, {bt}, jitter={self.jitter:.3f}, "
            f"residual={self.residual:.3%}"
            + (f", censored={list(self.censored_tiers)}"
               if self.censored_tiers else "")
        )


def _median(xs) -> float:
    return float(np.median(np.asarray(list(xs), dtype=float)))


def calibrate(
    trace: Trace,
    topology: Topology | None = None,
    seed: int = 0,
    **model_kwargs,
) -> CalibrationResult:
    """Fit a fresh ``LinkTimeModel`` to ``trace`` on ``topology``.

    ``topology`` defaults to the one recorded in the trace meta.  Extra
    ``model_kwargs`` pass through to the ``LinkTimeModel`` constructor
    (e.g. ``scenario=`` or ``dead_link_timeout=``).
    """
    if topology is None:
        topology = trace.topology()
    if topology is None:
        raise ValueError(
            "calibrate() needs a Topology: none passed and the trace meta "
            "carries no placement"
        )

    by_link = trace.by_link(kinds=("pull",))
    n_pulls = sum(len(v) for v in by_link.values())
    defaults = LinkTimeModel(topology).base_times

    # -- compute time -------------------------------------------------------
    local_durs = [r.duration for r in trace.records if r.kind == "local"]
    meta_compute = trace.meta.get("compute_time")
    if local_durs:
        compute = _median(local_durs)
    elif meta_compute is not None:
        # Sync-only traces carry no "local" records, and their per-link
        # pulls are raw network times (can dip *below* compute), so the
        # min-pull floor would underestimate; the exporter's recorded
        # compute is exact.
        compute = float(meta_compute)
    elif n_pulls:
        compute = min(min(r.duration for r in v) for v in by_link.values())
    else:
        compute = LinkTimeModel(topology).compute_time

    # -- per-link medians, grouped into tiers -------------------------------
    link_med = {lk: _median(r.duration for r in v) for lk, v in by_link.items()}
    tier_meds: dict = {t: [] for t in TIERS}
    for (i, m), med in link_med.items():
        tier_meds[topology.tier(i, m)].append(med)

    base: dict = {}
    censored = []
    for t in TIERS:
        if tier_meds[t]:
            base[t] = _median(tier_meds[t])
            if base[t] <= compute * (1.0 + _CENSOR_EPS):
                censored.append(t)
    if base:
        # Missing tiers: scale a neighboring observed tier by the default
        # model's tier ratios (best prior available without observations).
        ref = next(t for t in TIERS if t in base)
        for t in TIERS:
            if t not in base:
                base[t] = base[ref] * defaults[t] / defaults[ref]
    else:
        base = dict(defaults)
    # Restore the documented ordering invariant (cummax along TIERS): a
    # censored near tier can observe *above* a far tier's true base.
    prev = 0.0
    for t in TIERS:
        base[t] = max(base[t], prev)
        prev = base[t]

    # -- jitter: robust lognormal sigma from uncensored links ---------------
    log_resid = []
    for lk, v in by_link.items():
        med = link_med[lk]
        if med <= compute * (1.0 + _CENSOR_EPS) or len(v) < 3:
            continue
        log_resid.extend(np.log(r.duration) - np.log(med) for r in v)
    if len(log_resid) >= 8:
        jitter = float(min(1.0, 1.4826 * np.median(np.abs(log_resid))))
    else:
        jitter = 0.0

    # -- per-directed-link WAN skew -----------------------------------------
    M = topology.n_workers
    link_scale = np.ones((M, M))
    for (i, m), med in link_med.items():
        if topology.tier(i, m) != "inter_cluster":
            continue
        if med <= compute * (1.0 + _CENSOR_EPS):
            continue
        link_scale[i, m] = med / base["inter_cluster"]

    # -- residual of the fitted model over uncensored pulls -----------------
    rel = []
    for (i, m), v in by_link.items():
        pred = max(compute, base[topology.tier(i, m)] * link_scale[i, m])
        for r in v:
            if r.duration > compute * (1.0 + _CENSOR_EPS):
                rel.append(abs(r.duration - pred) / r.duration)
    residual = _median(rel) if rel else 0.0

    model = LinkTimeModel(
        topology,
        compute_time=compute,
        base_times=dict(base),
        jitter=jitter,
        # Measured traces already contain whatever slowness really happened;
        # don't re-inject the synthetic roaming slow link.
        slowdown_range=(1.0, 1.0),
        seed=seed,
        link_scale=link_scale.copy(),
        **model_kwargs,
    )
    return CalibrationResult(
        model=model,
        compute_time=compute,
        base_times=dict(base),
        jitter=jitter,
        link_scale=link_scale,
        residual=residual,
        n_pulls=n_pulls,
        censored_tiers=tuple(censored),
        per_link_median=link_med,
    )
