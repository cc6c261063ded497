#!/usr/bin/env python3
"""Where an iteration of the float64 device simplex spends its time.

    python3 scripts/lp_profile.py [--M 128] [--K 8] [--R 8] [--out DIR]

Builds the batched Eq.-14 sweep's LP stack (``policy._eq14_grid_stack``,
K x R grid, the symmetric U(0.01, 0.05) link times with one slow link that
``chip_smoke.py``'s device-LP phase uses) and solves it with
``solver.batch_torch`` in two modes, each three times (once to warm up,
once timed on the wall clock, ended by a device synchronise, once under
``torch.profiler``): ``graph``, the solver as it runs (an iteration
replayed as one CUDA graph), and ``eager``, the same windows with every
kernel launched on its own.
From the profile it prints, per lockstep iteration: the host's wall time,
the device's busy time (the sum of its kernels), the kernels launched,
the host time inside each group of aten operators (their own CPU time)
and inside the CUDA runtime calls (launches, copies, synchronises), and
the 15 largest operators; and the run's read-backs and rolled-back windows.  ``--out DIR`` writes the numbers to
``DIR/lp_profile.json``.  Imports nothing of JAX; ``--device cpu`` runs it
on the CPU at a small M for a dry run.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

GROUPS = (
    ("index_put", ("aten::index_put_", "aten::_index_put_impl_")),
    ("indexing", ("aten::index", "aten::gather", "aten::scatter_", "aten::select",
                  "aten::slice", "aten::as_strided", "aten::view", "aten::unsqueeze",
                  "aten::expand", "aten::transpose", "aten::t", "aten::clamp")),
    ("matmul", ("aten::bmm", "aten::mm", "aten::matmul", "aten::mv")),
    ("read_back", ("aten::_local_scalar_dense", "aten::item", "aten::is_nonzero",
                   "aten::_to_copy", "aten::copy_", "aten::to", "aten::nonzero")),
    ("inverse", ("aten::linalg_inv_ex",)),
)
RUNTIME = ("cudaLaunchKernel", "cudaMemcpyAsync", "cudaStreamSynchronize",
           "cudaDeviceSynchronize", "cudaLaunchKernelExC", "cuLaunchKernel",
           "cudaGraphLaunch", "cudaEventRecord", "cudaEventSynchronize")


def hetero_times(M, seed=0, slow_factor=10.0):
    import numpy as np

    rng = np.random.default_rng(seed)
    T = rng.uniform(0.01, 0.05, size=(M, M))
    T = (T + T.T) / 2
    i, m = rng.choice(M, size=2, replace=False)
    T[i, m] = T[m, i] = T[i, m] * slow_factor
    np.fill_diagonal(T, 0.0)
    return T


def group_of(name):
    for g, names in GROUPS:
        if name in names:
            return g
    return "elementwise_other" if name.startswith("aten::") else None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--M", type=int, default=128)
    ap.add_argument("--K", type=int, default=8)
    ap.add_argument("--R", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import policy
    from repro_torch.solver import batch_torch

    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    if cuda and not torch.cuda.is_available():
        print("lp_profile: needs a CUDA card (or --device cpu)", file=sys.stderr)
        return 1
    M = args.M
    d = np.ones((M, M)) - np.eye(M)
    inst, _, _, b, lb, _ = policy._eq14_grid_stack(0.1, args.K, args.R, hetero_times(M), d)
    S = b.shape[0]

    def solve(graph):
        sol = batch_torch.make_solver(inst.c, inst.A, b, lb, inst.ub, device=dev)
        sol.use_graph = graph
        _, _, pivots = sol.solve()
        if cuda:
            torch.cuda.synchronize()
        return sol, pivots.cpu()

    def dev_self(e):
        for k in ("self_device_time_total", "self_cuda_time_total"):
            v = getattr(e, k, None)
            if v is not None:
                return v
        return 0.0

    card = "cpu"
    if cuda:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True).stdout.strip()
    recs = {}
    for mode in ("graph", "eager"):
        solve(mode == "graph")
        t0 = time.perf_counter()
        sol, pivots = solve(mode == "graph")
        wall = time.perf_counter() - t0
        iters = sol.iterations
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=acts) as prof:
            solve(mode == "graph")
        host_groups = defaultdict(float)
        runtime = {}
        ops = []
        for e in prof.key_averages():
            g = group_of(e.key)
            if g is not None:
                host_groups[g] += e.self_cpu_time_total
                ops.append((e.key, e.count, e.self_cpu_time_total, dev_self(e)))
            elif e.key in RUNTIME:
                runtime[e.key] = {"calls_per_iter": e.count / iters,
                                  "us_per_iter": e.self_cpu_time_total / iters}
        # Device kernels: the events that ran on the card.
        kernels = [e for e in prof.events() if getattr(e, "device_type", None) is not None
                   and str(e.device_type).endswith("CUDA")]
        dev_us = sum(e.time_range.elapsed_us() for e in kernels)
        ops.sort(key=lambda o: -o[2])
        rec = recs[mode] = {
            "M": M, "S": S, "m": int(b.shape[1]), "n": int(inst.n), "card": card,
            "mode": mode, "iterations": iters, "readbacks": sol.readbacks,
            "rollbacks": sol.rollbacks, "max_pivots": int(pivots.max()),
            "wall_s": wall, "wall_us_per_iter": wall * 1e6 / iters,
            "device_busy_us_per_iter": dev_us / iters,
            "kernels_per_iter": len(kernels) / iters,
            "host_op_self_us_per_iter": {g: v / iters for g, v in sorted(host_groups.items())},
            "runtime": runtime,
            "top_ops": [{"op": k, "calls_per_iter": c / iters, "host_us_per_iter": h / iters,
                         "device_us_per_iter": dv / iters} for k, c, h, dv in ops[:15]],
        }
        print(f"[{card}] M = {M}, {mode}: {S} LPs, m = {rec['m']}, n = {rec['n']}, "
              f"{iters} iterations ({sol.rollbacks} windows rolled back), "
              f"{sol.readbacks} read-backs, most pivots {rec['max_pivots']}; wall "
              f"{wall:.4f} s = {rec['wall_us_per_iter']:.1f} us an iteration; device busy "
              f"{rec['device_busy_us_per_iter']:.1f} us, {rec['kernels_per_iter']:.1f} "
              "kernels an iteration (under the profiler)")
        for g, v in rec["host_op_self_us_per_iter"].items():
            print(f"  host, aten {g}: {v:.1f} us an iteration")
        for k, v in runtime.items():
            print(f"  host, {k}: {v['calls_per_iter']:.2f} calls, {v['us_per_iter']:.1f} us "
                  "an iteration")
        for o in rec["top_ops"]:
            print(f"  {o['op']}: {o['calls_per_iter']:.2f} calls, host "
                  f"{o['host_us_per_iter']:.1f} us, device {o['device_us_per_iter']:.1f} us "
                  "an iteration")
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "lp_profile.json").write_text(json.dumps(recs, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
