"""Chrome-trace / Perfetto export of a traced simulation (DESIGN.md §15).

``chrome_trace`` turns a ``SimConfig.trace``-enabled ``SimResult`` (or an
ingested ``Trace``) into the Chrome Trace Event JSON that chrome://tracing
and https://ui.perfetto.dev open directly:

* one track (tid) per worker, carrying its events as complete ("X") slices
  — pulls named ``pull i->m``, compute-only events ``local``, stalls
  ``timeout i->m`` — with the comm/compute split in args when available;
* synchronous rounds on their own track (they span all workers);
* Monitor policy publishes as global instant ("i") events.

Timestamps are virtual-time microseconds (the simulator's seconds * 1e6).
"""

from __future__ import annotations

import json

from repro_torch.trace.schema import Trace

_PID = 0


def _meta_event(name: str, tid: int, label: str) -> dict:
    return {
        "ph": "M",
        "pid": _PID,
        "tid": tid,
        "name": name,
        "args": {"name": label},
    }


def _slices(records):
    """Yield (t, dur, src, dst, kind, extra) from either source shape."""
    for r in records:
        if isinstance(r, tuple):  # SimResult.trace_events 8-tuple
            t, dur, src, dst, kind, comm, comp, _net = r
            yield t, dur, src, dst, kind, {"comm": comm, "compute": comp}
        else:  # TraceRecord
            yield r.t_start, r.duration, r.src, r.dst, r.kind, {}


def chrome_trace(source, meta: dict | None = None) -> dict:
    """Build the Chrome Trace Event dict from a SimResult or Trace."""
    if isinstance(source, Trace):
        records = source.records
        refreshes = [
            (r.t_start, None) for r in source.records if r.kind == "refresh"
        ]
        meta = dict(source.meta, **(meta or {}))
    else:  # SimResult
        if not source.trace_events and source.events and source.events[-1]:
            raise ValueError(
                "SimResult has no trace_events; run simulate() with "
                "SimConfig(trace=True)"
            )
        records = source.trace_events
        refreshes = [(t, rho) for (t, rho, _P) in source.policy_log]
        meta = dict(meta or {})

    events: list = [_meta_event("process_name", 0, "repro simulation")]
    workers = sorted(
        {s for (_, _, s, _, k, _) in _slices(records) if s >= 0 and k != "refresh"}
    )
    for w in workers:
        events.append(_meta_event("thread_name", w, f"worker {w}"))
    round_tid = (max(workers) + 1) if workers else 0
    has_rounds = any(k == "round" for (_, _, _, _, k, _) in _slices(records))
    if has_rounds:
        events.append(_meta_event("thread_name", round_tid, "rounds"))

    for t, dur, src, dst, kind, extra in _slices(records):
        if kind == "refresh":
            continue  # emitted below from the refresh list
        if kind == "round":
            name, tid = "round", round_tid
        elif kind == "local":
            name, tid = "local", src
        else:  # pull / timeout
            name, tid = f"{kind} {src}->{dst}", src
        ev = {
            "ph": "X",
            "pid": _PID,
            "tid": tid,
            "name": name,
            "cat": kind,
            "ts": t * 1e6,
            "dur": dur * 1e6,
        }
        args = {"src": src, "dst": dst, **extra}
        ev["args"] = args
        events.append(ev)

    for t, rho in refreshes:
        ev = {
            "ph": "i",
            "pid": _PID,
            "tid": 0,
            "name": "monitor refresh",
            "cat": "refresh",
            "ts": t * 1e6,
            "s": "g",  # global scope: draws a full-height marker line
        }
        if rho is not None:
            ev["args"] = {"rho": rho}
        events.append(ev)

    out = {"traceEvents": events, "displayTimeUnit": "ms"}
    if meta:
        out["otherData"] = meta
    return out


def write_chrome_trace(source, path, meta: dict | None = None) -> None:
    """Write Perfetto-openable JSON for a SimResult or Trace."""
    with open(path, "w") as f:
        json.dump(chrome_trace(source, meta=meta), f)
