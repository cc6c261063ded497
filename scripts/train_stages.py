#!/usr/bin/env python3
"""Per-stage time and memory of NetMax training rounds on one card.

    python3 scripts/train_stages.py [--layers 8] [--rounds 3]

Builds ``launch.train.TrainLoop`` at the widths of tinyllama-1.1b (depth cut
to ``--layers``; M = 4 workers, 4 x 512 tokens a worker, as
``chip_smoke.py``'s training phase) and runs ``--rounds`` rounds with each
stage of the trainer's step wrapped: the grads (``microbatch_scan`` over the
workers' forward and backward), the optimizer's update and apply, the
gossip pull and the mix.  Per stage it prints the wall time (ended by a
device synchronise, so the stages do not overlap), the memory allocated
before it, its peak and what it leaves allocated.  Then, unwrapped, one
more round under the profiler (device time) and one under cProfile (the
host's Python time by function, the 15 largest own times).  Imports nothing
of JAX; needs a CUDA card.
"""

from __future__ import annotations

import argparse
import cProfile
import dataclasses
import pstats
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

GB = 1e9


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()

    import torch

    from repro_torch.configs.base import get_arch
    from repro_torch.dist import gossip
    from repro_torch.kernels import ops
    from repro_torch.launch.train import TrainLoop
    from repro_torch.optim.optimizers import Optimizer
    from repro_torch.train import trainer

    if not torch.cuda.is_available():
        print("train_stages: needs a CUDA card", file=sys.stderr)
        return 1

    def stage(name, fn):
        def wrapped(*a, **k):
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            print(f"  {name:24s} {1e3 * (time.perf_counter() - t):8.1f} ms; allocated "
                  f"before {before / GB:6.2f} GB, peak {torch.cuda.max_memory_allocated() / GB:6.2f}"
                  f" GB, after {torch.cuda.memory_allocated() / GB:6.2f} GB")
            return out
        wrapped.__wrapped__ = fn
        return wrapped

    cfg = dataclasses.replace(get_arch("tinyllama-1.1b"), n_layers=args.layers)
    loop = TrainLoop(cfg, workers=4, seq=512, batch_per_worker=4, lr=0.02,
                     monitor_every=4, device="cuda")
    torch.cuda.synchronize()
    print(f"{torch.cuda.get_device_name(0)}: {cfg.name} widths at {cfg.n_layers} layers, "
          f"M = 4; state after init {torch.cuda.memory_allocated() / GB:.2f} GB")
    trainer.microbatch_scan = stage("grads (microbatch_scan)", trainer.microbatch_scan)
    ops.gossip_mix_tree = stage("mix (gossip_mix_tree)", ops.gossip_mix_tree)
    gossip.pull_gather = stage("pull_gather", gossip.pull_gather)
    for cell in loop.step_fn.__closure__:
        if isinstance(cell.cell_contents, Optimizer):
            opt = cell.cell_contents
            object.__setattr__(opt, "update", stage("optimizer.update", opt.update))
            object.__setattr__(opt, "apply", stage("optimizer.apply", opt.apply))
    wrapped = (trainer.microbatch_scan, ops.gossip_mix_tree, gossip.pull_gather)
    for r in range(args.rounds):
        torch.cuda.synchronize()
        t = time.perf_counter()
        m = loop.round(r)
        torch.cuda.synchronize()
        print(f"round {r}: {1e3 * (time.perf_counter() - t):.1f} ms, loss {float(m['loss']):.4f}, "
              f"allocated after {torch.cuda.memory_allocated() / GB:.2f} GB")
    trainer.microbatch_scan, ops.gossip_mix_tree, gossip.pull_gather = (
        f.__wrapped__ for f in wrapped)
    object.__setattr__(opt, "update", opt.update.__wrapped__)
    object.__setattr__(opt, "apply", opt.apply.__wrapped__)

    r = args.rounds
    torch.cuda.synchronize()
    t = time.perf_counter()
    loop.round(r)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        loop.round(r + 1)
        torch.cuda.synchronize()
    device_ms = sum(e.self_device_time_total for e in prof.key_averages()) / 1e3
    print(f"round {r}: {wall * 1e3:.1f} ms unwrapped; round {r + 1}: {device_ms:.1f} ms of "
          f"device time ({device_ms / (wall * 1e3):.3f} of round {r}'s wall)")
    pr = cProfile.Profile()
    t = time.perf_counter()
    pr.enable()
    loop.round(r + 2)
    torch.cuda.synchronize()
    pr.disable()
    print(f"round {r + 2} under cProfile: {(time.perf_counter() - t) * 1e3:.1f} ms; host time "
          "by function (own time):")
    pstats.Stats(pr).sort_stats("tottime").print_stats(15)
    return 0


if __name__ == "__main__":
    sys.exit(main())
