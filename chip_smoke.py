#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:

1. card    — require CUDA; print nvidia-smi's name and power limit line;
2. build   — compile every CUDA source of the port with nvcc (one process
             per source, all started together) and print the seconds;
3. kernels — every hand-written kernel against its plain torch version on
             the card, at the test shapes, the main path's shapes and a
             large shape: max error within tolerance, and per kernel the
             median time (CUDA events), the HBM-bytes bound, the plain
             version's time and the ``torch.lerp`` yardstick;
4. main    — the paper's NetMax loop through ``simulate`` at the repo's
             model width (MLP [32, 128, 64, 10], 32 workers, 3000 events):
             the launch counters are zeroed just before and read just
             after, and every kernel of the path must have launched;
5. parity  — the same configuration, 1000 events, on the card and on the
             CPU: host-side outputs bit-equal, losses within 5e-4.

Prints one ``{"kernels": [...]}`` JSON line, then, last, the
``{"ok": true, "device": {...}}`` line.  With ``--out DIR`` the per-case
kernel numbers and the main path's profile also go to
``DIR/chip_smoke_kernels.json``.  It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
SRC = HERE / "src"

#: The simulator MLP, [D, 128, 64, C] at train_eval_split(4000, 800, 32, 10).
MLP_DIMS = [32, 128, 64, 10]
N_WORKERS = 32

#: HBM bytes/s by card name (NVIDIA data sheets); the SXM H100 otherwise.
HBM_BYTES_PER_S = {"H100 PCIe": 2.0e12, "H100 NVL": 3.9e12, "H200": 4.8e12}
H100_SXM_BYTES_PER_S = 3.35e12

#: tests/test_kernels.py MIX_CASES / MIX_ROWS_CASES, with their tolerances.
MIX_CASES = [((1024,), "float32", 0.25), ((127, 33), "float32", 0.8),
             ((8, 64, 32), "bfloat16", 0.5), ((70000,), "float32", 0.0),
             ((256,), "float32", 1.0)]
MIX_ROWS_CASES = [((4, 1024), "float32"), ((3, 127, 33), "float32"),
                  ((8, 64, 32), "bfloat16"), ((1, 70000), "float32")]
TOL = {"float32": 1e-6, "bfloat16": 2e-2}


class SmokeError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


def leaf_shapes(rows=None):
    """The MLP's parameter shapes, stacked over ``rows`` when given."""
    out = []
    for a, b in zip(MLP_DIMS[:-1], MLP_DIMS[1:]):
        for s in ((a, b), (b,)):
            out.append(s if rows is None else (rows,) + s)
    return out


def cuda_ms(torch, fn, iters, reps=7):
    """Median per-call device time of ``fn`` (ms), from CUDA events around
    ``iters`` back-to-back calls, after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def device_ms(torch, fn, iters, match=None):
    """Mean device time per call (ms) of the kernels ``fn`` launches whose
    name contains ``match`` (all when None), from a torch.profiler (CUPTI)
    trace; None when the trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if match is None or match in e.key)
    return us / iters / 1e3 if us > 0 else None


def hbm_rate(name: str) -> float:
    for key, rate in HBM_BYTES_PER_S.items():
        if key in name:
            return rate
    return H100_SXM_BYTES_PER_S


def phase_card(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0 and smi.stdout.strip(),
          f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip()
    print(card)
    return card


def phase_build():
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    libs = build.build()
    secs = time.perf_counter() - t0
    print(f"build: {sorted(libs)} in {secs:.2f} s (build dir {build.build_dir()})")
    return secs


def phase_kernels(torch, rate):
    """Every kernel against its plain version; returns per-kernel summaries
    (without launches) and the per-case records."""
    from repro_torch.kernels import gossip_mix as tk
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def draw(shape, dtype):
        x, u, p = (torch.randn(shape, generator=gen, device=dev) for _ in range(3))
        u.mul_(0.01)
        return tuple(t.to(getattr(torch, dtype)) for t in (x, u, p))

    records = []

    def run_case(kernel, shape, dtype, w, role, iters):
        x, u, p = draw(shape, dtype)
        if kernel == "gossip_mix_rows":
            R = shape[0]
            wt = (torch.linspace(0.0, 1.0, R, device=dev) if w is None
                  else torch.full((R,), w, device=dev))
            k_fn = lambda: tk.gossip_mix_rows(x, u, p, wt)  # noqa: E731
            p_fn = lambda: ref.reference_gossip_mix_rows(x, u, p, wt)  # noqa: E731
            wl = wt.reshape((-1,) + (1,) * (len(shape) - 1))
            lib_fn = lambda: torch.lerp(x, p, wl)  # noqa: E731
            n_w = R
        else:
            k_fn = lambda: tk.gossip_mix(x, u, p, w)  # noqa: E731
            p_fn = lambda: ref.reference_gossip_mix(x, u, p, w)  # noqa: E731
            lib_fn = lambda: torch.lerp(x, p, w)  # noqa: E731
            n_w = 1
        got, want = k_fn(), p_fn()
        torch.cuda.synchronize()
        check(got.shape == x.shape and got.dtype == x.dtype,
              f"{kernel} {shape}: output {tuple(got.shape)} {got.dtype}")
        err = (got.float() - want.float()).abs().max().item()
        check(err <= TOL[dtype], f"{kernel} {shape} {dtype}: max |err| {err}")
        nbytes = 4 * x.numel() * x.element_size() + 4 * n_w
        rec = {"kernel": kernel, "role": role, "shape": list(shape), "dtype": dtype,
               "max_abs_err": err, "bound_ms": nbytes / rate * 1e3, "bytes": nbytes}
        # torch.lerp(x, p, w) computes the u = 0 case; a yardstick only.
        fns = {"": k_fn, "plain_": p_fn}
        if role == "main":
            fns["library_"] = lib_fn
        for key, fn in fns.items():
            # Device time of the kernels alone (profiler) and the time per
            # call back to back (CUDA events), which includes the host's
            # launch cost whenever the kernel is shorter than that.
            call = cuda_ms(torch, fn, iters)
            dev_ms = device_ms(torch, fn, iters,
                               "mix_rows_kernel" if key == "" else None)
            rec[key + "ms"] = call if dev_ms is None else dev_ms
            rec[key + "ms_from"] = "events" if dev_ms is None else "profiler"
            rec[key + "call_ms"] = call
        rec.setdefault("library_ms", None)
        records.append(rec)
        return rec

    for shape, dtype, w in MIX_CASES:
        run_case("gossip_mix", shape, dtype, w, "test", 50)
    for shape, dtype in MIX_ROWS_CASES:
        run_case("gossip_mix_rows", shape, dtype, None, "test", 50)
    for dtype in ("float32", "bfloat16"):
        run_case("gossip_mix_rows", (8, 2 ** 24), dtype, None, "large", 5)
    run_case("gossip_mix", (2 ** 27,), "float32", 0.3, "large", 5)
    # The main path: the batched engine mixes a full cohort of 32 rows per
    # parameter leaf (u = 0 there; random u here, same work); a single
    # replica's leaves for the scalar entry point.
    for shape in leaf_shapes(N_WORKERS):
        run_case("gossip_mix_rows", shape, "float32", None, "main", 200)
    for shape in leaf_shapes():
        run_case("gossip_mix", shape, "float32", 0.3, "main", 200)

    def summary(kernel, source, replaces):
        main = [r for r in records if r["kernel"] == kernel and r["role"] == "main"]
        mine = [r for r in records if r["kernel"] == kernel]
        return {
            "name": kernel, "route": "cuda", "source": source,
            "replaces": replaces,
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            # One mix of the whole MLP tree: the six leaves' launches.
            "ms": sum(r["ms"] for r in main),
            "plain_ms": sum(r["plain_ms"] for r in main),
            "bound_ms": sum(r["bound_ms"] for r in main),
            "bound_by": "bytes",
            "library_ms": sum(r["library_ms"] for r in main),
        }

    src = "src/repro_torch/kernels/csrc/gossip_mix.cu"
    summaries = [
        summary("gossip_mix_rows", src, "src/repro/kernels/gossip_mix.py:82"),
        summary("gossip_mix", src, "src/repro/kernels/gossip_mix.py:42"),
    ]
    for s in summaries:
        print(f"kernel {s['name']}: max|err| {s['max_abs_err']:.3g}, main-path tree "
              f"{s['ms'] * 1e3:.2f} us on the device (plain {s['plain_ms'] * 1e3:.2f}"
              f" us, lerp {s['library_ms'] * 1e3:.2f} us, bound "
              f"{s['bound_ms'] * 1e3:.3f} us)")
    for r in records:
        print(f"  {r['kernel']} {r['role']} {r['shape']} {r['dtype']}: device "
              f"{r['ms'] * 1e3:.2f} us ({r['ms_from']}), per call {r['call_ms'] * 1e3:.2f}"
              f" us, plain {r['plain_ms'] * 1e3:.2f} us, bound {r['bound_ms'] * 1e3:.3f} us"
              f" ({r['bytes'] / (r['ms'] * 1e-3) / 1e12:.3f} TB/s)")
    return summaries, records


def sim_setup(n_events, trace, seed=0):
    from repro_torch.core.nettime import LinkTimeModel, Topology
    from repro_torch.data.partition import uniform_partition
    from repro_torch.data.synthetic import train_eval_split
    from repro_torch.train.simulator import SimConfig

    x, y, ex, ey = train_eval_split(4000, 800, 32, 10, seed=seed)
    parts = uniform_partition(len(y), N_WORKERS, seed=seed)
    topo = Topology(n_workers=N_WORKERS, workers_per_host=4, hosts_per_pod=1)
    link = LinkTimeModel(topo, jitter=0.02, seed=5)
    cfg = SimConfig(algorithm="netmax", n_workers=N_WORKERS, engine="batched",
                    use_mix_kernel=True, total_events=n_events,
                    monitor_period=0.5, seed=seed, trace=trace)
    return cfg, link, (x, y, parts, ex, ey)


def phase_main(torch):
    from repro_torch.kernels import gossip_mix as tk
    from repro_torch.train import engine
    from repro_torch.train.simulator import simulate

    cfg, link, (x, y, parts, ex, ey) = sim_setup(3000, trace=False)
    # Host seconds inside Monitor wakes (Algorithm 3's LP sweep), measured by
    # wrapping the engine's one call site for this run only.
    monitor_s = [0.0]
    boundary = engine.monitor_boundary

    def timed_boundary(*args, **kwargs):
        t = time.perf_counter()
        try:
            return boundary(*args, **kwargs)
        finally:
            monitor_s[0] += time.perf_counter() - t

    torch.cuda.synchronize()
    tk.reset_launches()
    engine.monitor_boundary = timed_boundary
    try:
        t0 = time.perf_counter()
        res = simulate(cfg, link, x, y, parts, ex, ey, record_every=500,
                       device="cuda")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        engine.monitor_boundary = boundary
    launches = dict(tk.LAUNCHES)
    check(res.engine == "batched", f"engine {res.engine}")
    check(res.policy_updates >= 3, f"policy_updates {res.policy_updates} < 3")
    check(all(map(math.isfinite, res.losses)), f"non-finite losses {res.losses}")
    check(res.losses[-1] < res.losses[0], f"loss did not fall: {res.losses}")
    check(launches["gossip_mix_rows"] >= 6 * res.cohorts,
          f"gossip_mix_rows launched {launches['gossip_mix_rows']} times for "
          f"{res.cohorts} cohorts (need >= 6 per cohort)")
    ev = res.events[-1]
    print(f"main path: {ev} events, {res.cohorts} cohorts, {res.dispatches} "
          f"dispatches, {res.policy_updates} policy updates in {secs:.3f} s: "
          f"{ev / secs:.1f} events/s, {secs / ev * 1e6:.1f} us/event; Monitor "
          f"wakes {monitor_s[0]:.3f} s; losses {[round(v, 4) for v in res.losses]};"
          f" launches {launches}")
    return {"events": ev, "seconds": secs, "events_per_s": ev / secs,
            "us_per_event": secs / ev * 1e6, "cohorts": res.cohorts,
            "dispatches": res.dispatches, "policy_updates": res.policy_updates,
            "monitor_s": monitor_s[0], "losses": res.losses,
            "launches": launches}


def phase_profile(torch, main):
    """The main path once more under torch.profiler (device activity only):
    device busy share against the unprofiled run's wall time, and the
    kernels that hold the device longest."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.train.simulator import simulate

    cfg, link, (x, y, parts, ex, ey) = sim_setup(3000, trace=False)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        simulate(cfg, link, x, y, parts, ex, ey, record_every=500, device="cuda")
        torch.cuda.synchronize()
    avg = sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)
    device_s = sum(e.self_device_time_total for e in avg) * 1e-6
    mix_s = sum(e.self_device_time_total for e in avg
                if "mix_rows_kernel" in e.key) * 1e-6
    top = [(e.key[:80], e.count, e.self_device_time_total * 1e-3) for e in avg[:8]]
    print(f"main path device time {device_s:.4f} s = {device_s / main['seconds']:.4f} "
          f"of the wall; gossip_mix_rows {mix_s:.4f} s; top kernels (name, count, ms):")
    for row in top:
        print(f"  {row}")
    return {"device_s": device_s, "busy_share": device_s / main["seconds"],
            "mix_rows_device_s": mix_s, "top_kernels": top}


def phase_parity(torch):
    from repro_torch.train.simulator import simulate

    out = {}
    for dev in ("cuda", "cpu"):
        cfg, link, (x, y, parts, ex, ey) = sim_setup(1000, trace=True)
        t0 = time.perf_counter()
        out[dev] = simulate(cfg, link, x, y, parts, ex, ey, record_every=500,
                            device=dev)
        print(f"parity run on {dev}: {time.perf_counter() - t0:.2f} s")
    a, b = out["cuda"], out["cpu"]
    check(a.times == b.times and a.events == b.events, "times/events differ")
    check(a.comm_time == b.comm_time, "comm_time differs")
    check(a.trace_events == b.trace_events, "trace_events differ")
    check(len(a.policy_log) == len(b.policy_log), "policy_log lengths differ")
    for (ta, ra, Pa), (tb, rb, Pb) in zip(a.policy_log, b.policy_log):
        check(ta == tb and ra == rb and (Pa == Pb).all(), "policy_log differs")
    # Two devices sum f32 matmuls in different orders: 5e-4, as the
    # engine-parity tests allow (rtol = atol = 5e-4).
    diff = max(abs(u - v) for u, v in zip(a.losses, b.losses))
    check(all(abs(u - v) <= 5e-4 + 5e-4 * abs(v) for u, v in zip(a.losses, b.losses)),
          f"cuda vs cpu losses differ by {diff}: {a.losses} vs {b.losses}")
    print(f"parity: host-side outputs bit-equal, max |loss diff| {diff:.3g}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None,
                    help="directory for chip_smoke_kernels.json (per-case numbers)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on a card",
              file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    try:
        card = phase_card(torch)
        name = torch.cuda.get_device_name(0)
        phase_build()
        summaries, records = phase_kernels(torch, hbm_rate(name))
        main_path = phase_main(torch)
        main_path["profile"] = phase_profile(torch, main_path)
        phase_parity(torch)
    except SmokeError as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    for s in summaries:
        s["launches"] = main_path["launches"][s["name"]]
    order = ["name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
             "plain_ms", "bound_ms", "bound_by", "library_ms"]
    kernels = [{k: s[k] for k in order} for s in summaries]
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "chip_smoke_kernels.json").write_text(json.dumps(
            {"card": card, "device": name, "kernels": kernels, "cases": records,
             "main_path": main_path},
            indent=1))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
