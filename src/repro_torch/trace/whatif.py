"""What-if cost model over a calibrated, replayed baseline (DESIGN.md §15).

The capacity-planning questions the paper's heterogeneity numbers raise —
which link upgrade, placement change, or strategy switch buys the most
wall-clock — answered by re-running the *measured* timeline under a
mutation:

    session = WhatIf(trace, calibration, cfg, data)
    session.query(UpgradeLink(0, 31, speedup=4.0))
    session.query(MoveWorker(7, cluster=0))
    session.query(SwitchAlgorithm("netmax"))

Each query replays the trace through ``ReplayLinkSource`` with the
mutation applied — scaled measured durations for a link upgrade, dropped
measurements + calibrated-model pricing of the new links for a moved
worker, the same link timeline under a different strategy for a switch —
and reports wall-clock and time-to-loss deltas against the unmutated
replay baseline.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np

from repro_torch.core.nettime import LinkTimeModel
from repro_torch.trace.calibrate import CalibrationResult
from repro_torch.trace.replay import ReplayLinkSource
from repro_torch.trace.schema import Trace


# -- mutations ---------------------------------------------------------------


@dataclass(frozen=True)
class UpgradeLink:
    """Speed the directed link src->dst up by ``speedup``x (>1 = faster;
    0.5 = a 2x *downgrade*).  ``symmetric`` applies it both ways — the
    physical-link upgrade the paper's WAN numbers suggest."""

    src: int
    dst: int
    speedup: float
    symmetric: bool = True

    def describe(self) -> str:
        arrow = "<->" if self.symmetric else "->"
        return f"upgrade link {self.src}{arrow}{self.dst} by {self.speedup}x"


@dataclass(frozen=True)
class MoveWorker:
    """Relocate ``worker`` into ``cluster``: its measured link history is
    discarded (those links no longer exist) and the calibrated model
    prices its new links — inter_pod within the new cluster, WAN across."""

    worker: int
    cluster: int

    def describe(self) -> str:
        return f"move worker {self.worker} to cluster {self.cluster}"


@dataclass(frozen=True)
class SwitchAlgorithm:
    """Run a different registered strategy over the same link timeline."""

    algorithm: str

    def describe(self) -> str:
        return f"switch algorithm to {self.algorithm}"


class RelocatedTopology:
    """Duck-typed Topology with one worker moved to another cluster.

    The moved worker lands in its own pod there, so its links resolve to
    ``inter_pod`` within the destination cluster and ``inter_cluster``
    across — the coarsest (most conservative) placement a relocation can
    guarantee.  Everything else delegates to the base placement.
    """

    def __init__(self, base, worker: int, cluster: int):
        if not (0 <= worker < base.n_workers):
            raise ValueError(f"worker {worker} not in topology")
        if cluster < 0:
            raise ValueError(f"bad cluster {cluster}")
        self.base = base
        self.worker = worker
        self.cluster = cluster
        self.n_workers = base.n_workers
        self.n_clusters = max(base.n_clusters, cluster + 1)

    def cluster_of(self, i: int) -> int:
        return self.cluster if i == self.worker else self.base.cluster_of(i)

    def host_of(self, i: int) -> int:
        if i == self.worker:  # a host of its own, past every real one
            return self.base.host_of(self.n_workers - 1) + 1
        return self.base.host_of(i)

    def pod_of(self, i: int) -> int:
        if i == self.worker:
            return self.base.pod_of(self.n_workers - 1) + 1
        return self.base.pod_of(i)

    def tier(self, i: int, m: int) -> str:
        if self.worker in (i, m):
            if self.cluster_of(i) != self.cluster_of(m):
                return "inter_cluster"
            return "inter_pod"
        return self.base.tier(i, m)

    def __getattr__(self, name):
        return getattr(self.base, name)


# -- the query session -------------------------------------------------------


@dataclass
class WhatIfReport:
    mutation: str
    target_loss: float
    baseline_wall_clock: float
    mutated_wall_clock: float
    baseline_time_to_loss: float
    mutated_time_to_loss: float
    baseline_final_loss: float
    mutated_final_loss: float

    @property
    def wall_clock_delta(self) -> float:
        """Virtual seconds saved (positive = the mutation is faster)."""
        return self.baseline_wall_clock - self.mutated_wall_clock

    @property
    def wall_clock_speedup(self) -> float:
        return self.baseline_wall_clock / self.mutated_wall_clock

    @property
    def time_to_loss_delta(self) -> float:
        return self.baseline_time_to_loss - self.mutated_time_to_loss

    @property
    def time_to_loss_speedup(self) -> float:
        return self.baseline_time_to_loss / self.mutated_time_to_loss

    def summary(self) -> str:
        return (
            f"{self.mutation}: wall-clock {self.baseline_wall_clock:.2f}s -> "
            f"{self.mutated_wall_clock:.2f}s ({self.wall_clock_speedup:.2f}x)"
            f", time-to-loss({self.target_loss:.3f}) "
            f"{self.baseline_time_to_loss:.2f}s -> "
            f"{self.mutated_time_to_loss:.2f}s"
        )


class WhatIf:
    """Replayed-baseline what-if queries.

    ``data`` is the simulate() data bundle ``(data_x, data_y, part_idx,
    eval_x, eval_y)``; ``cfg`` the baseline SimConfig (its seed pins the
    replay, see replay.py).  ``target_loss`` defaults to 3/4 of the
    baseline replay's loss descent — a level both runs cross unless the
    mutation is catastrophic; pass one explicitly to compare at a fixed
    quality bar.  ``device`` and ``init_params`` are passed on to every
    ``simulate`` run (CUDA by default; ``device="cpu"`` for the CPU).
    """

    def __init__(
        self,
        trace: Trace,
        calibration: CalibrationResult,
        cfg,
        data,
        target_loss: float | None = None,
        record_every: int = 100,
        device=None,
        init_params=None,
    ):
        self.trace = trace
        self.calibration = calibration
        self.cfg = cfg
        self.data = data
        self.record_every = record_every
        self.device = device
        self.init_params = init_params
        self._target = target_loss
        self._baseline = None

    # -- internals ----------------------------------------------------------
    def _model(self, mutations) -> LinkTimeModel:
        cal = self.calibration.model
        topo = cal.topology
        scale = (
            np.ones((topo.n_workers, topo.n_workers))
            if cal.link_scale is None
            else cal.link_scale.copy()
        )
        source = ReplayLinkSource(self.trace)
        for mut in mutations:
            if isinstance(mut, UpgradeLink):
                pairs = [(mut.src, mut.dst)]
                if mut.symmetric:
                    pairs.append((mut.dst, mut.src))
                for i, m in pairs:
                    source.scale_link(
                        i, m, 1.0 / mut.speedup, floor=cal.compute_time
                    )
                    scale[i, m] /= mut.speedup
            elif isinstance(mut, MoveWorker):
                topo = RelocatedTopology(topo, mut.worker, mut.cluster)
                source.drop_worker(mut.worker)
                # Its calibrated per-link skew described links that no
                # longer exist.
                scale[mut.worker, :] = 1.0
                scale[:, mut.worker] = 1.0
            elif not isinstance(mut, SwitchAlgorithm):
                raise TypeError(f"unknown mutation {mut!r}")
        return LinkTimeModel(
            topo,
            compute_time=cal.compute_time,
            base_times=dict(cal.base_times),
            jitter=cal.jitter,
            slowdown_range=cal.slowdown_range,
            seed=cal.seed,
            link_scale=scale,
            time_source=source,
        )

    def _cfg(self, mutations):
        for mut in mutations:
            if isinstance(mut, SwitchAlgorithm):
                return dataclasses.replace(self.cfg, algorithm=mut.algorithm)
        return self.cfg

    def _run(self, mutations):
        from repro_torch.train.simulator import simulate

        return simulate(
            self._cfg(mutations),
            self._model(mutations),
            *self.data,
            record_every=self.record_every,
            init_params=self.init_params,
            device=self.device,
        )

    @property
    def baseline(self):
        """The unmutated replay (cached)."""
        if self._baseline is None:
            self._baseline = self._run(())
        return self._baseline

    @property
    def target_loss(self) -> float:
        if self._target is None:
            base = self.baseline
            lo, hi = base.losses[-1], base.losses[0]
            self._target = lo + 0.25 * (hi - lo)
        return self._target

    # -- the query API ------------------------------------------------------
    def query(self, mutation) -> WhatIfReport:
        """Evaluate one mutation (or a sequence applied together)."""
        mutations = (
            tuple(mutation)
            if isinstance(mutation, (list, tuple))
            else (mutation,)
        )
        base, mut = self.baseline, self._run(mutations)
        target = self.target_loss
        return WhatIfReport(
            mutation="; ".join(m.describe() for m in mutations),
            target_loss=target,
            baseline_wall_clock=base.times[-1],
            mutated_wall_clock=mut.times[-1],
            baseline_time_to_loss=base.time_to_loss(target),
            mutated_time_to_loss=mut.time_to_loss(target),
            baseline_final_loss=base.losses[-1],
            mutated_final_loss=mut.losses[-1],
        )
