"""Versioned trace schema + ingest (DESIGN.md §15).

One trace = a header (schema tag + free-form meta) and a time-ordered list
of records ``(t_start, duration, src, dst, kind)``:

* ``pull``    — worker ``src`` pulled from ``dst``; duration is the full
  event time max(compute, transfer) the simulator charged (or a measured
  pull time when ingested from an external timeline).  Pulls emitted
  *inside a synchronous round* instead carry the raw per-link network
  time the round queried (no compute floor) — that is what makes sync
  replay exact;
* ``local``   — a compute-only event (no peer, or a masked edge); dst = -1;
* ``timeout`` — the pull crossed a dead link and stalled for the timeout;
* ``round``   — one synchronous round (src = dst = -1), preceded at the
  same ``t_start`` by the per-link pulls it drew;
* ``refresh`` — a Monitor policy publish (instant; duration = 0).

Async records additionally carry ``net`` — the raw link time the event
drew before any strategy multiplier (ps-async congestion, netmax-topk
wire ratio).  Replay serves ``net`` back through the link seam so the
multipliers re-apply deterministically, making replay bit-exact for every
strategy; absent (older traces), replay falls back to ``duration``.

On disk the canonical form is JSONL: a header line ``{"schema":
"repro.trace/v1", "meta": {...}}`` followed by one object per record.  A
bare record stream (no header) is accepted on read — that is the shape an
external measurement harness most easily produces — as is CSV with columns
``t_start,duration,src,dst[,kind]`` (``read_csv``).
"""

from __future__ import annotations

import csv as _csv
import json
from dataclasses import dataclass, field

SCHEMA = "repro.trace/v1"
KINDS = ("pull", "local", "timeout", "round", "refresh")


@dataclass(frozen=True)
class TraceRecord:
    t_start: float
    duration: float
    src: int  # -1 when not worker-attributed (round / refresh)
    dst: int  # -1 when there is no peer
    kind: str
    # Raw link time the event drew (``Timing.net``), before any strategy
    # multiplier — ps-async congestion, netmax-topk wire ratio.  Replay
    # serves it back through the link seam so ``event_timing`` re-applies
    # the multipliers deterministically (bit-exact async replay for every
    # strategy).  None for records that never drew a link time and for
    # legacy/v1-early traces — replay then falls back to ``duration``,
    # exact for the unit-multiplier gossip family.
    net: float | None = None

    def validate(self) -> "TraceRecord":
        if self.kind not in KINDS:
            raise ValueError(f"unknown record kind {self.kind!r}")
        if not (self.duration >= 0.0):  # also rejects NaN
            raise ValueError(f"bad duration {self.duration!r}")
        if not (self.t_start >= 0.0):
            raise ValueError(f"bad t_start {self.t_start!r}")
        if self.net is not None and not (self.net >= 0.0):
            raise ValueError(f"bad net {self.net!r}")
        return self


@dataclass
class Trace:
    """An ingested trace: validated records in t_start order + meta."""

    records: list = field(default_factory=list)
    meta: dict = field(default_factory=dict)

    @property
    def horizon(self) -> float:
        """Virtual time the measurements cover (max record end time)."""
        return max((r.t_start + r.duration for r in self.records), default=0.0)

    def pulls(self) -> list:
        return [r for r in self.records if r.kind == "pull"]

    def by_link(self, kinds=("pull",)) -> dict:
        """records grouped by directed link (src, dst), each in time order."""
        out: dict = {}
        for r in self.records:
            if r.kind in kinds and r.src >= 0 and r.dst >= 0:
                out.setdefault((r.src, r.dst), []).append(r)
        return out

    def counts(self) -> dict:
        out = {k: 0 for k in KINDS}
        for r in self.records:
            out[r.kind] += 1
        return out

    def topology(self):
        """Reconstruct the Topology recorded in meta (None if absent)."""
        t = self.meta.get("topology")
        if not t:
            return None
        from repro_torch.core.nettime import Topology

        return Topology(
            n_workers=int(t["n_workers"]),
            workers_per_host=int(t.get("workers_per_host", 4)),
            hosts_per_pod=int(t.get("hosts_per_pod", 2)),
            pods_per_cluster=t.get("pods_per_cluster"),
        )


def from_sim_result(res, cfg=None, link_model=None) -> Trace:
    """Build a Trace from a ``SimConfig.trace``-enabled run.

    ``res.trace_events`` carries the per-event stream; Monitor publishes
    from ``res.policy_log`` become ``refresh`` records.  ``cfg`` and
    ``link_model`` (both optional) stamp provenance into meta — with a
    link model attached the topology round-trips, which is what lets
    ``calibrate`` map links to tiers without being told the placement.
    """
    if not res.trace_events and res.times and res.events and res.events[-1]:
        raise ValueError(
            "SimResult has no trace_events; run simulate() with "
            "SimConfig(trace=True)"
        )
    records = [
        TraceRecord(
            float(t), float(dur), int(src), int(dst), str(kind),
            net=None if net is None else float(net),
        ).validate()
        for (t, dur, src, dst, kind, _comm, _comp, net) in res.trace_events
    ]
    records.extend(
        TraceRecord(float(t), 0.0, -1, -1, "refresh")
        for (t, _rho, _P) in res.policy_log
    )
    records.sort(key=lambda r: (r.t_start, r.kind))
    meta: dict = {"engine": res.engine}
    if cfg is not None:
        meta["algorithm"] = getattr(cfg.algorithm, "name", cfg.algorithm)
        meta["n_workers"] = cfg.n_workers
        meta["seed"] = cfg.seed
        meta["total_events"] = cfg.total_events
    if link_model is not None:
        topo = link_model.topology
        meta["topology"] = {
            "n_workers": topo.n_workers,
            "workers_per_host": topo.workers_per_host,
            "hosts_per_pod": topo.hosts_per_pod,
            "pods_per_cluster": topo.pods_per_cluster,
        }
        meta["compute_time"] = link_model.compute_time
    return Trace(records=records, meta=meta)


# -- serialization -----------------------------------------------------------


def write_jsonl(trace: Trace, path) -> None:
    with open(path, "w") as f:
        f.write(json.dumps({"schema": SCHEMA, "meta": trace.meta}) + "\n")
        for r in trace.records:
            # repr-level floats: a written trace round-trips bit-exactly
            # (the replay-exactness pin in tests/test_trace.py relies on it)
            obj = {
                "t": r.t_start,
                "dur": r.duration,
                "src": r.src,
                "dst": r.dst,
                "kind": r.kind,
            }
            if r.net is not None:
                obj["net"] = r.net
            f.write(json.dumps(obj) + "\n")


def _record_from_obj(obj: dict) -> TraceRecord:
    net = obj.get("net")
    return TraceRecord(
        t_start=float(obj["t"]),
        duration=float(obj["dur"]),
        src=int(obj.get("src", -1)),
        dst=int(obj.get("dst", -1)),
        kind=str(obj.get("kind", "pull")),
        net=None if net is None else float(net),
    ).validate()


def read_jsonl(path) -> Trace:
    meta: dict = {}
    records: list = []
    with open(path) as f:
        for n, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            obj = json.loads(line)
            if "schema" in obj:
                if obj["schema"] != SCHEMA:
                    raise ValueError(
                        f"{path}: unsupported trace schema {obj['schema']!r} "
                        f"(this reader speaks {SCHEMA})"
                    )
                meta = dict(obj.get("meta", {}))
                continue
            try:
                records.append(_record_from_obj(obj))
            except (KeyError, ValueError, TypeError) as e:
                raise ValueError(f"{path}:{n + 1}: bad trace record: {e}") from e
    records.sort(key=lambda r: (r.t_start, r.kind))
    return Trace(records=records, meta=meta)


def read_csv(path) -> Trace:
    """Externally-measured timeline: ``t_start,duration,src,dst[,kind]``.

    The minimal shape a measurement harness produces — kind defaults to
    ``pull``.  Extra columns are ignored; header row required.
    """
    records: list = []
    with open(path, newline="") as f:
        reader = _csv.DictReader(f)
        need = {"t_start", "duration", "src", "dst"}
        cols = set(reader.fieldnames or [])
        if not need <= cols:
            raise ValueError(
                f"{path}: CSV trace needs columns {sorted(need)}, "
                f"got {sorted(cols)}"
            )
        for n, row in enumerate(reader):
            try:
                records.append(
                    TraceRecord(
                        t_start=float(row["t_start"]),
                        duration=float(row["duration"]),
                        src=int(row["src"]),
                        dst=int(row["dst"]),
                        kind=(row.get("kind") or "pull").strip(),
                    ).validate()
                )
            except (ValueError, TypeError) as e:
                raise ValueError(f"{path}:{n + 2}: bad trace row: {e}") from e
    records.sort(key=lambda r: (r.t_start, r.kind))
    return Trace(records=records, meta={"source": "csv"})


def load_trace(path) -> Trace:
    """Load a trace by extension: ``.csv`` -> read_csv, else JSONL."""
    if str(path).endswith(".csv"):
        return read_csv(path)
    return read_jsonl(path)
