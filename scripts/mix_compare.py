"""Time the cohort's gossip mix of two source trees of the port on one card.

    python3 scripts/mix_compare.py --before DIR [--after DIR] [--out FILE]

``DIR`` is the root of a checkout of the repo (``git archive <commit> | tar
-x -C DIR``); ``--after`` defaults to this checkout.  Each tree is timed in a
process of its own, in turns (before, after, after, before), each through
its own ``repro_torch.kernels.ops.gossip_mix_tree`` -- the batched engine's
mix, whatever its design -- and its own ``gossip_mix_rows`` and
``gossip_mix`` at the large shapes, with its kernels built from its own
sources into its own ``build/``; and one replica's six leaves through its own
``gossip_mix`` beside ``torch.lerp``.  Per case: device time from torch.profiler
(all kernels of a call), the time per call back to back (CUDA events) and
the host's enqueue time per call.  The mix runs on the simulator's MLP tree
[32, 128, 64, 10] stacked over 32 rows, f32, u = 0.  Prints one line per
run and case, and the card's name and power limit; with ``--out`` also
writes the numbers as JSON.  Needs a card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MLP_DIMS = [32, 128, 64, 10]
ROWS = 32
#: name -> (entry point, shape, iterations)
LARGE = {"rows_f32": ("gossip_mix_rows", (8, 2 ** 24), "float32", 5),
         "rows_bf16": ("gossip_mix_rows", (8, 2 ** 24), "bfloat16", 5),
         "scalar_f32": ("gossip_mix", (2 ** 27,), "float32", 5)}


def _events_ms(torch, fn, iters, reps=7):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / iters)
    return statistics.median(times)


def _host_ms(torch, fn, iters):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    secs = time.perf_counter() - t0
    torch.cuda.synchronize()
    return secs / iters * 1e3


def _device_ms(torch, fn, iters):
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages())
    if us <= 0:
        raise SystemExit("the profiler traced no device time")
    return us / iters / 1e3


def run_one(src: Path) -> dict:
    """Time one tree's mix in this process (``src``: its ``src/``)."""
    sys.path.insert(0, str(src))
    import torch

    from repro_torch.kernels import gossip_mix as tk
    from repro_torch.kernels import ops

    assert Path(tk.__file__).resolve().is_relative_to(src.resolve()), tk.__file__
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    tree = []
    for a, b in zip(MLP_DIMS[:-1], MLP_DIMS[1:]):
        tree.append({"w": (ROWS, a, b), "b": (ROWS, b)})
    draw = lambda s, dt=torch.float32: torch.randn(s, generator=gen, device=dev).to(dt)  # noqa: E731
    h = [{k: draw(s) for k, s in layer.items()} for layer in tree]
    p = [{k: draw(s) for k, s in layer.items()} for layer in tree]
    w = torch.rand(ROWS, generator=gen, device=dev)
    out = {}

    def case(name, fn, iters):
        tk.reset_launches()
        fn()
        torch.cuda.synchronize()
        launches = sum(tk.LAUNCHES.values())
        out[name] = {"launches_a_call": launches, "device_ms": _device_ms(torch, fn, iters),
                     "call_ms": _events_ms(torch, fn, iters),
                     "host_ms": _host_ms(torch, fn, iters)}

    case("tree", lambda: ops.gossip_mix_tree(h, p, w), 200)
    # One replica's six leaves through the scalar entry point, one call each,
    # and torch.lerp on the same leaves (u = 0 only; a yardstick).
    leaves = [(layer[k], pl[k]) for layer, pl in zip(h, p) for k in layer]
    replica = [(x[0].contiguous(), q[0].contiguous(), torch.zeros_like(x[0]))
               for x, q in leaves]
    case("replica", lambda: [tk.gossip_mix(x, z, q, 0.3) for x, q, z in replica], 200)
    case("replica_lerp", lambda: [torch.lerp(x, q, 0.3) for x, q, _ in replica], 200)
    for name, (entry, shape, dt, iters) in LARGE.items():
        x, u, q = (draw(shape, getattr(torch, dt)) for _ in range(3))
        if entry == "gossip_mix_rows":
            wr = torch.linspace(0.0, 1.0, shape[0], device=dev)
            case(name, lambda: tk.gossip_mix_rows(x, u, q, wr), iters)
        else:
            case(name, lambda: tk.gossip_mix(x, u, q, 0.3), iters)
        del x, u, q
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--before", type=Path, help="root of the earlier checkout")
    ap.add_argument("--after", type=Path, default=ROOT, help="root of the later checkout")
    ap.add_argument("--out", type=Path, default=None, help="JSON file for the numbers")
    ap.add_argument("--one", type=Path, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one is not None:  # a child: time one tree, print its JSON
        print(json.dumps(run_one(args.one)))
        return 0
    if args.before is None:
        ap.error("--before is required")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip()
    print(card)
    runs = []
    for label, root in (("before", args.before), ("after", args.after),
                        ("after", args.after), ("before", args.before)):
        proc = subprocess.run([sys.executable, __file__, "--one", str(root / "src")],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], sep="\n")
            return 1
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        runs.append({"label": label, "root": str(root), "cases": res})
        for name, r in res.items():
            print(f"{label:6s} {name:10s} launches {r['launches_a_call']:2d}  device "
                  f"{r['device_ms'] * 1e3:9.2f} us  per call {r['call_ms'] * 1e3:9.2f} us  "
                  f"host {r['host_ms'] * 1e3:8.2f} us")
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": card, "runs": runs}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
