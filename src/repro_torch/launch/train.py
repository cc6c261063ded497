"""Training launcher: ``python -m repro_torch.launch.train --arch <id> ...``

The port of ``repro.launch.train``: arch config -> NetMax trainer (or a
baseline strategy) -> Network Monitor -> checkpoint/restart, with the same
flags and the same loop, plus ``--device`` (default ``cuda``, which raises
without a card).  On the card it trains the full config; with ``--reduced``
or ``--device cpu`` the tiny same-family config, as the JAX launcher does on
its CPU backend.  Its batches hold token ids and labels only, as the JAX
launcher's do, so it trains the text families (dense, moe, ssm, hybrid):
attention through the flash-attention kernels, the ssm family's WKV
recurrence through the WKV kernels, forward and backward.  The audio and
vlm families need frames or vision tokens that neither launcher builds
(ROADMAP C10): ``TrainLoop`` refuses them, and they train through
``train.trainer.make_train_step`` with a batch shaped by
``launch.specs.train_batch_specs``.  Gossip
strategies mix through the fused tree mix (``use_gossip_mix_kernel``): on
the card one gossip-mix kernel launch per round.

``TrainLoop`` holds the loop's state and runs one round per ``round(r)``
call, so a caller (``chip_smoke.py``) can time and profile rounds of the
same loop.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.algos import get_algorithm
from repro_torch.configs.base import get_arch
from repro_torch.core.consensus import sample_round
from repro_torch.core.monitor import IterationTimeEMA, NetworkMonitor
from repro_torch.core.nettime import LinkTimeModel, Topology
from repro_torch.data.synthetic import TokenStream
from repro_torch.device import resolve_device
from repro_torch.optim import sgd
from repro_torch.train import checkpoint as ckpt_mod
from repro_torch.train.trainer import TrainStepConfig, init_stacked, make_train_step
from repro_torch.tree import tree_leaves

ALGOS = ["netmax", "allreduce", "prague", "local"]


class TrainLoop:
    """The launcher's state: trainer step, token stream, simulated links,
    Monitor, policy (P, rho) and the round draws.  ``start`` is the first
    round to run (after a resume from ``ckpt``)."""

    def __init__(self, cfg, *, workers=4, seq=128, batch_per_worker=4, lr=0.02,
                 algo="netmax", gossip="gather", ckpt=None, ckpt_every=50,
                 monitor_every=10, device=None, seed=0):
        if cfg.family == "audio" or cfg.n_vis_tokens:
            raise ValueError(
                f"{cfg.name}: the launcher's batches hold tokens and labels only, and "
                f"the {cfg.family} family also needs "
                f"{'frames' if cfg.family == 'audio' else 'vis_embeds'} (ROADMAP C10, as "
                "in the JAX launcher); train it through train.trainer.make_train_step "
                "with a batch shaped by launch.specs.train_batch_specs")
        self.device = resolve_device(device)
        M = workers
        self.cfg, self.M, self.lr, self.algo_name = cfg, M, lr, algo
        self.ckpt, self.ckpt_every, self.monitor_every = ckpt, ckpt_every, monitor_every
        opt = sgd(momentum=0.9, weight_decay=1e-4)
        if algo == "prague":
            algorithm = get_algorithm("prague", trainer_groups=max(2, M // 2))
        else:
            algorithm = get_algorithm("netmax" if algo == "local" else algo)
        self.step_cfg = TrainStepConfig(
            gossip_mode="none" if algo in ("allreduce", "local") else gossip,
            use_gossip_mix_kernel=True,
        )
        self.step_fn = make_train_step(cfg, opt, M, algorithm, self.step_cfg)
        self.stream = TokenStream(cfg.vocab_size, seq, batch_per_worker, seed=0)
        self.link = LinkTimeModel(Topology(M, workers_per_host=max(1, M // 2),
                                           hosts_per_pod=1), jitter=0.05, seed=1)
        self.monitor = NetworkMonitor(M, alpha=lr, K=6, R=6)
        self.emas = [IterationTimeEMA(M, beta=0.5) for _ in range(M)]
        self.d = np.ones((M, M)) - np.eye(M)
        self.P = np.where(self.d > 0, 1.0 / max(M - 1, 1), 0.0)
        self.rho = 0.5 / (2 * lr * max(M - 1, 1))
        self.rng = np.random.default_rng(seed)
        self.t_virt = 0.0
        self.start = 0
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.params, self.opt_state = init_stacked(cfg, opt, M, gen)
        if ckpt and ckpt_mod.latest_step(ckpt) is not None:
            self.params, self.opt_state, man, mon = ckpt_mod.restore(
                ckpt, self.params, self.opt_state, device=self.device)
            self.start = man["data_cursor"].get("round", 0)
            if mon and "P" in mon:
                self.P, self.rho = np.asarray(mon["P"]), mon.get("rho", self.rho)

    def batch(self, r: int) -> dict:
        """Round r's (M, b, S) token and label tensors on the device."""
        per = [self.stream.batch(w, r) for w in range(self.M)]  # one draw a worker
        return {k: torch.from_numpy(np.stack([b[k] for b in per]).astype(np.int64))
                .to(self.device) for k in ("tokens", "labels")}

    def round(self, r: int) -> dict:
        """Run round r; returns the step's metrics plus the round's draws."""
        M = self.M
        batch = self.batch(r)
        nb, wts = sample_round(self.rng, self.P, self.lr, self.rho, self.d)
        gi = {"neighbors": nb, "weights": wts, "lr": np.float32(self.lr)}
        self.params, self.opt_state, m = self.step_fn(self.params, self.opt_state, batch, gi)
        link, t = self.link, self.t_virt
        for i in range(M):
            self.emas[i].update(int(nb[i]), link.iteration_time(i, int(nb[i]), now=t))
        self.t_virt += max(link.iteration_time(i, int(nb[i]), now=t) for i in range(M))
        if self.algo_name == "netmax" and (r + 1) % self.monitor_every == 0:
            self.monitor.collect({i: self.emas[i].snapshot() for i in range(M)})
            pol = self.monitor.step()
            if np.isfinite(pol.T_convergence):
                P, self.rho = pol.P, pol.rho
                bad = P.sum(axis=1) <= 0
                P[bad] = np.where(self.d[bad] > 0, 1.0 / max(M - 1, 1), 0.0)
                self.P = P
        if self.ckpt and (r + 1) % self.ckpt_every == 0:
            ckpt_mod.save(self.ckpt, r + 1, self.params, self.opt_state,
                            monitor_state={"rho": float(self.rho), "P": self.P.tolist()},
                            data_cursor={"round": r + 1})
        return {**m, "neighbors": nb, "weights": wts}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--rounds", type=int, default=100)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-scale reduced config (default with --device cpu)")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch-per-worker", type=int, default=4)
    ap.add_argument("--lr", type=float, default=0.02)
    ap.add_argument("--algo", default="netmax", choices=ALGOS)
    ap.add_argument("--gossip", default="gather",
                    choices=["gather", "masked_psum", "ppermute"])
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--monitor-every", type=int, default=10)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced or dev.type == "cpu":
        cfg = cfg.reduced()
    loop = TrainLoop(cfg, workers=args.workers, seq=args.seq,
                     batch_per_worker=args.batch_per_worker, lr=args.lr, algo=args.algo,
                     gossip=args.gossip, ckpt=args.ckpt, ckpt_every=args.ckpt_every,
                     monitor_every=args.monitor_every, device=dev)
    if loop.start:
        print(f"[resume] round {loop.start}")
    M = args.workers
    n = sum(leaf.numel() for leaf in tree_leaves(loop.params)) // M
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"[{args.algo}] arch={cfg.name} M={M} params/worker={n / 1e6:.1f}M "
          f"gossip={loop.step_cfg.gossip_mode} on {where}")
    for r in range(loop.start, args.rounds):
        t0 = time.time()
        m = loop.round(r)
        loss = float(m["loss"])
        if (r + 1) % args.log_every == 0 or r == loop.start:
            print(f"round {r + 1:5d} loss={loss:.4f} "
                  f"step_wall={time.time() - t0:.2f}s virt={loop.t_virt:.1f}s")
    print("done.")


if __name__ == "__main__":
    main()
