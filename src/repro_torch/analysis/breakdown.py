"""Per-op cost breakdown of a counted run -- the dry-run "profiler".

The port of ``repro/analysis/breakdown.py``.  No wall clock exists on a
dry-run, so a perf iteration reads this instead: the top contributors to
FLOPs, HBM bytes and collective bytes, from ``analysis.cost``'s per-op log.
Each row's scope is the chain of ``repro_torch`` functions on the Python
stack when the op ran (``lm.prefill_logits/transformer.forward/.../
attention.chunked_attention``), where the JAX module reads the HLO's
``op_name`` metadata; a kernel call is one row, ``kernel.<name>``.
``peak_groups`` does the same for memory: the tensors live at the counted
run's peak.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.analysis.cost import CostReport


@dataclass
class Contributor:
    kind: str  # flops | bytes | collective
    value: float
    opcode: str
    scope: str
    shape: str


class Breakdown:
    def __init__(self, report: CostReport):
        self.report = report

    def top(self, n: int = 15):
        """Returns dict(kind -> [Contributor]), largest first."""
        contributions: list[Contributor] = []
        for op in self.report.ops:
            if op.collective:
                contributions.append(Contributor("collective", op.collective_bytes, op.op,
                                                 op.scope, op.shape[:48]))
                continue
            if op.flops:
                contributions.append(Contributor("flops", op.flops, op.op, op.scope,
                                                 op.shape[:48]))
            if op.bytes:
                contributions.append(Contributor("bytes", op.bytes, op.op, op.scope,
                                                 op.shape[:48]))
        out = {}
        for kind in ("flops", "bytes", "collective"):
            rows = [c for c in contributions if c.kind == kind]
            rows.sort(key=lambda c: -c.value)
            out[kind] = rows[:n]
        return out


def print_breakdown(report: CostReport, n: int = 12) -> None:
    tops = Breakdown(report).top(n)
    for kind, rows in tops.items():
        total = sum(r.value for r in rows)
        print(f"\n== top {kind} (sum of top-{n}: {total:.3e}) ==")
        for r in rows:
            scope = r.scope.split("/")[-1][:60] if r.scope else "?"
            print(f"  {r.value:12.3e}  {r.opcode:30s} {r.shape:40s} {scope}")


#: Rows ``peak_groups`` keeps.
PEAK_ROWS = 10


def peak_groups(buffers) -> list:
    """The tensors live at a counter's peak (``CostCounter.peak_buffers``)
    grouped by op, shape and scope, largest total first: up to
    ``PEAK_ROWS`` rows of (bytes, tensors, op, shape, scope)."""
    groups: dict = {}
    for b in buffers:
        key = (b.op, b.shape, b.scope)
        nbytes, count = groups.get(key, (0.0, 0))
        groups[key] = (nbytes + b.bytes, count + 1)
    rows = [(nbytes, count, *key) for key, (nbytes, count) in groups.items()]
    rows.sort(key=lambda r: -r[0])
    return rows[:PEAK_ROWS]
