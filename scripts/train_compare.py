"""Time one training phase of ``chip_smoke.py`` in two source trees, in turns.

    python3 scripts/train_compare.py --before DIR [--after DIR] [--arch NAME]
                                     [--out FILE]

``DIR`` is the root of a checkout of the repo (``git archive <commit> | tar
-x -C DIR``); ``--after`` defaults to this checkout.  Each tree runs, in a
process of its own and in turns (before, after, after, before), its own
``chip_smoke.py``'s ``phase_family_train`` for the row of ``FAMILY_TRAIN``
whose arch is ``--arch`` (default ``whisper-small``: phase 31, trained whole
at M = 4), with its kernels built from its own sources.  Prints per run the
median round (host clock around rounds ended by a synchronise), the device
ms a round and the busy share of the profiled rounds, the device ms a round
of B3 and of its backward (kernels named ``flash_fwd*`` / ``flash_bwd*``),
the launches a round, and the card's name and power limit; with ``--out``
also the numbers as JSON.  Needs a card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def run_one(root: Path, arch: str) -> dict:
    """One tree's phase, in this process (its ``chip_smoke.py`` and ``src``)."""
    sys.path.insert(0, str(root))
    import chip_smoke as cs

    sys.path.insert(0, str(root / "src"))
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.phase_card(torch)
    row = next(r for r in cs.FAMILY_TRAIN if r[1] == arch)
    out = cs.phase_family_train(torch, card, *row)
    prof = out["profile"]
    return {"card": card, "phase": row[0],
            **{k: out[k] for k in ("round_ms_median", "round_ms_mean", "tokens_per_s",
                                   "peak_memory_bytes", "launches_per_round")},
            "profile": {k: prof[k] for k in ("rounds", "wall_s", "device_s", "busy_share",
                                             "device_s_by")}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--before", type=Path, help="root of the earlier checkout")
    ap.add_argument("--after", type=Path, default=ROOT, help="root of the later checkout")
    ap.add_argument("--arch", default="whisper-small", help="an arch of FAMILY_TRAIN")
    ap.add_argument("--out", type=Path, default=None, help="JSON file for the numbers")
    ap.add_argument("--one", type=Path, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one is not None:  # a child: one tree's run, a JSON line last
        print("TRAIN_COMPARE " + json.dumps(run_one(args.one.resolve(), args.arch)))
        return 0
    if args.before is None:
        ap.error("--before is required")
    runs = []
    for label, root in (("before", args.before), ("after", args.after),
                        ("after", args.after), ("before", args.before)):
        proc = subprocess.run([sys.executable, __file__, "--arch", args.arch, "--one",
                               str(root)], capture_output=True, text=True, timeout=1800)
        line = [x for x in proc.stdout.splitlines() if x.startswith("TRAIN_COMPARE ")]
        if proc.returncode != 0 or not line:
            print(proc.stdout[-4000:], proc.stderr[-4000:], sep="\n")
            return 1
        r = {"label": label, "root": str(root), **json.loads(line[-1].split(" ", 1)[1])}
        runs.append(r)
        per_round = {k: v * 1e3 / r["profile"]["rounds"]
                     for k, v in r["profile"]["device_s_by"].items()}
        device = r["profile"]["device_s"] * 1e3 / r["profile"]["rounds"]
        print(f"{label:6s} {r['phase']}: round median {r['round_ms_median']:.1f} ms (mean "
              f"{r['round_ms_mean']:.1f}); device {device:.1f} ms a round, busy "
              f"{r['profile']['busy_share']:.3f}; B3 "
              f"{per_round.get('flash_fwd', 0.0):.1f} ms, B3 bwd "
              f"{per_round.get('flash_bwd', 0.0):.1f} ms a round; launches a round "
              f"{r['launches_per_round']}; {r['card']}")
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(runs, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
