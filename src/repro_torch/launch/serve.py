"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id>``.

Runs the batched KV-cache engine of the port with random weights drawn
from seed 0, for every registered arch.  The same flags as
``repro.launch.serve``, plus ``--device`` (default ``cuda``, which raises
without a card) and ``--layers``.  On the card it runs the full config;
with ``--reduced`` or ``--device cpu`` the tiny same-family config, as the
JAX launcher does on its CPU backend.  ``--layers N`` keeps N layers of
that config (whisper: decoder layers; every_2 and hybrid models: whole
periods): one 80 GB card holds phi3.5-moe at 8 of its 32 layers, llama4 at
2 of 48 and jamba at 8 of 32, the depths ``chip_smoke.py`` serves.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=64)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--layers", type=int, default=None,
                    help="keep this many layers (the full config does not fit one "
                         "card for phi3.5-moe, llama4 and jamba)")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs.base import get_arch
    from repro_torch.device import resolve_device
    from repro_torch.models import lm
    from repro_torch.serve.engine import Request, ServeEngine

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced or dev.type == "cpu":
        cfg = cfg.reduced()
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    eng = ServeEngine(cfg, params, batch_capacity=args.batch, max_seq=args.max_seq)

    rng = np.random.default_rng(0)
    reqs = [
        Request(rid=i,
                prompt=rng.integers(0, cfg.vocab_size, size=args.prompt_len).astype(np.int32),
                max_new=args.max_new)
        for i in range(args.requests)
    ]
    t0 = time.time()
    done = eng.run(reqs)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    toks = sum(len(r.out) for r in done)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"arch={cfg.name} on {where}: served {len(done)} requests, {toks} tokens "
          f"in {dt:.1f}s ({toks/dt:.1f} tok/s, batch={args.batch})")
    for r in done[:3]:
        print(f"  req {r.rid}: prompt={r.prompt.tolist()} -> {r.out}")


if __name__ == "__main__":
    main()
