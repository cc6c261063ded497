"""Trace summarizer CLI: ``python -m repro_torch.trace FILE [--top N]``.

Prints per-tier latency statistics, the slowest directed links, and
timeout counts for any trace file (JSONL or CSV) — the quick look a
measured timeline gets before calibration, and the CI sanity-print for
the committed fixture.  Tier attribution needs the topology recorded in
the trace meta (simulator exports carry it); without one the per-link
view still prints.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from repro_torch.trace.schema import load_trace


def _pct(xs, q):
    return float(np.percentile(np.asarray(xs, dtype=float), q))


def summarize(path, top: int = 5, out=None) -> None:
    trace = load_trace(path)
    w = (sys.stdout if out is None else out).write
    counts = trace.counts()
    meta = trace.meta
    w(f"trace {path}\n")
    if meta:
        keys = ("algorithm", "engine", "n_workers", "seed", "total_events")
        kv = ", ".join(f"{k}={meta[k]}" for k in keys if k in meta)
        if kv:
            w(f"  meta: {kv}\n")
    w(
        f"  records: {len(trace.records)} "
        f"({', '.join(f'{k}={v}' for k, v in counts.items() if v)})\n"
    )
    w(f"  horizon: {trace.horizon:.3f}s virtual\n")

    by_link = trace.by_link(kinds=("pull",))
    if not by_link:
        w("  no pull records — nothing to profile\n")
        return

    topo = trace.topology()
    if topo is not None:
        tiers: dict = {}
        for (i, m), recs in by_link.items():
            tiers.setdefault(topo.tier(i, m), []).extend(
                r.duration for r in recs
            )
        w("  per-tier pull latency (seconds):\n")
        for tier, durs in tiers.items():
            w(
                f"    {tier:<14} n={len(durs):<6} "
                f"p50={_pct(durs, 50):.4g} p90={_pct(durs, 90):.4g} "
                f"p99={_pct(durs, 99):.4g} max={max(durs):.4g}\n"
            )
    else:
        w("  (no topology in meta — skipping tier attribution)\n")

    med = {
        lk: float(np.median([r.duration for r in v]))
        for lk, v in by_link.items()
    }
    slowest = sorted(med.items(), key=lambda kv: -kv[1])[:top]
    w(f"  slowest directed links (median, top {len(slowest)}):\n")
    for (i, m), d in slowest:
        w(f"    {i}->{m}: {d:.4g}s over {len(by_link[(i, m)])} pulls\n")

    timeouts: dict = {}
    for r in trace.records:
        if r.kind == "timeout":
            timeouts[(r.src, r.dst)] = timeouts.get((r.src, r.dst), 0) + 1
    if timeouts:
        total = sum(timeouts.values())
        w(f"  timeouts: {total} across {len(timeouts)} links\n")
        for (i, m), n in sorted(timeouts.items(), key=lambda kv: -kv[1])[:top]:
            w(f"    {i}->{m}: {n}\n")
    else:
        w("  timeouts: none\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.trace",
        description="Summarize a repro.trace file (JSONL or CSV).",
    )
    ap.add_argument("file", help="trace file (.jsonl or .csv)")
    ap.add_argument(
        "--top", type=int, default=5,
        help="how many slowest links / noisiest timeout links to list",
    )
    args = ap.parse_args(argv)
    summarize(args.file, top=args.top)
    return 0


if __name__ == "__main__":
    sys.exit(main())
