"""Event-driven asynchronous decentralized-training simulator, in torch.

The port of the JAX package's ``train/simulator.py``: each worker has its
own virtual clock; one event = one Alg.-2 iteration of one worker (grad
step on its own data + pull from a sampled neighbor), with the iteration
duration drawn from the heterogeneous LinkTimeModel.  The Network Monitor
wakes on its own schedule (T_s) and republishes (P, rho).

All host-side machinery — heap order, numpy RNG draw order, link-time
draws, EMA updates, Monitor refreshes, scenario actions — is the JAX
package's, verbatim, so virtual times, comm/compute time, published
policies and the trace stream are bit-identical to it.  Only the model
math runs in torch, on ``device``:

    from repro_torch.algos import list_algorithms
    for name in list_algorithms():
        simulate(SimConfig(algorithm=name, ...), ..., device="cuda")

Engines (``SimConfig.engine``): ``"reference"`` (one Python iteration per
event, per-replica parameter trees) and ``"batched"`` (train/engine.py:
stacked replicas; async strategies in causally-independent cohorts per
dispatch, the gossip mix through the CUDA gossip-mix kernel under
``SimConfig.use_mix_kernel``, ps-async through its serialized PS row;
synchronous strategies one round, or one block of rounds, per dispatch);
``"auto"`` picks batched when the strategy supports it.  Every registered
strategy runs on both engines.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.algos import Algorithm, get_algorithm, mean_params
from repro_torch.core.monitor import IterationTimeEMA
from repro_torch.core.nettime import LinkTimeModel
from repro_torch.device import resolve_device
from repro_torch.scenarios.driver import (
    apply_action,
    attempt_fails,
    monitor_boundary,
    notify_monitor,
    prepare_monitor,
)
from repro_torch.scenarios.timeline import ScenarioCursor
from repro_torch.train.elastic import reseed_replica
from repro_torch.train.events import EventHeap
from repro_torch.tree import tree_flatten, tree_map, tree_unflatten

# --------------------------------------------------------------------------
# Small real model: MLP classifier
# --------------------------------------------------------------------------


def mlp_init(generator: torch.Generator, dims, device="cpu"):
    """He-style normal init, ``w ~ N(0, 1/fan_in)``, zero biases, drawn from
    ``generator`` (a CPU ``torch.Generator``) so every device gets the same
    numbers."""
    params = []
    for a, b in zip(dims[:-1], dims[1:]):
        w = torch.randn((a, b), generator=generator) / math.sqrt(a)
        params.append({"w": w.to(device), "b": torch.zeros((b,), device=device)})
    return params


def mlp_apply(params, x):
    """Forward pass; ``x`` (B, D) with unstacked params, or (K, B, D) with
    params stacked along a leading K axis (one batched matmul per layer)."""
    for i, layer in enumerate(params):
        x = torch.matmul(x, layer["w"]) + layer["b"].unsqueeze(-2)
        if i < len(params) - 1:
            x = torch.relu(x)
    return x


def ce_rows(logits, y):
    """Per-example cross entropy, ``logsumexp(logits) - logits[y]``."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, y.unsqueeze(-1)).squeeze(-1)
    return logz - gold


def ce_loss(params, x, y):
    return ce_rows(mlp_apply(params, x), y).mean()


def value_and_grad(loss_fn, params, *args):
    """(loss, grads) of ``loss_fn(params, *args)`` w.r.t. every leaf."""
    leaves, treedef = tree_flatten(params)
    req = [p.detach().requires_grad_(True) for p in leaves]
    with torch.enable_grad():
        loss = loss_fn(tree_unflatten(treedef, req), *args)
        grads = torch.autograd.grad(loss, req)
    return loss.detach(), tree_unflatten(treedef, grads)


def _grad_step(params, x, y, lr, momentum_state, mu):
    """One momentum-SGD step: m <- mu m + g, p <- p - lr m."""
    loss, grads = value_and_grad(ce_loss, params, x, y)
    with torch.no_grad():
        new_m = tree_map(lambda m, g: mu * m + g, momentum_state, grads)
        new_p = tree_map(lambda p, m: p - lr * m, params, new_m)
    return loss, new_p, new_m


@torch.no_grad()
def evaluate(params, x, y) -> tuple[float, float]:
    """(mean loss, accuracy) of one parameter tree on (x, y)."""
    logits = mlp_apply(params, x)
    loss = float(ce_rows(logits, y).mean())
    acc = float((logits.argmax(-1) == y).float().mean())
    return loss, acc


def to_device(a: np.ndarray, device) -> torch.Tensor:
    """Host array -> device tensor the way ``jnp.asarray`` types it for the
    model: floats as float32, integers as int64 (gather indices)."""
    t = torch.as_tensor(np.asarray(a))
    t = t.float() if t.is_floating_point() else t.long()
    return t.to(device)


# --------------------------------------------------------------------------
# Simulation
# --------------------------------------------------------------------------


@dataclass
class SimConfig:
    # Any registered strategy name (repro_torch.algos.list_algorithms()) or
    # an Algorithm instance.
    algorithm: str | Algorithm = "netmax"
    n_workers: int = 8
    lr: float = 0.05
    momentum: float = 0.9
    rho: float | None = None  # netmax: from Monitor
    batch_size: int = 64
    total_events: int = 4000
    # Monitor schedule period T_s.  None defers to NetworkMonitor's own
    # default (the paper's 2 minutes).
    monitor_period: float | None = None
    # Pin the Monitor control plane to a cluster (partition-aware publish).
    # None = omniscient Monitor.
    monitor_home_cluster: int | None = None
    # Standby-Monitor failover; requires monitor_home_cluster.
    monitor_failover: bool = False
    monitor_lease_periods: float = 1.0
    monitor_quorum: int | None = None
    # Control-plane fault injection (a ChaosInjector-like object with
    # drop_report / publish_lost); decided once per wake inside the shared
    # monitor_boundary, so engine parity survives chaos.
    chaos: object | None = None
    ema_beta: float = 0.5
    policy_K: int = 8
    policy_R: int = 8
    prague_group: int = 4
    prague_contention: float = 0.5
    serial_compute: bool = False  # Fig. 7 ablation: no compute/comm overlap
    uniform_policy: bool = False  # Fig. 7 ablation: no adaptive probabilities
    adaptive_weight: bool = True  # NetMax gamma weighting vs fixed 1/2
    ps_node: int = 0  # which worker doubles as the PS (ps-* algorithms)
    ps_congestion: float = 0.4
    seed: int = 0
    # Execution engine: "auto" | "reference" | "batched".
    engine: str = "auto"
    # Batched engine only: route identity-delta mixes through the fused
    # kernels/ops.gossip_mix_tree path (the CUDA gossip-mix kernel on a
    # card, its plain torch version on the CPU) instead of the leaf rule.
    use_mix_kernel: bool = False
    # Batched engine, async gossip family: split the stacked replicas over
    # the ranks of the default process group (one a card; train/engine.py).
    shard_workers: bool = False
    # Batched engine only: fuse consecutive cohorts into one dispatch (a
    # Python loop over levels) plus single-worker burst dispatches.  The
    # logical cohort structure and all host-side results are identical
    # either way; only SimResult.dispatches differs.
    fuse_chains: bool = True
    # Record a per-event trace stream in SimResult.trace_events; host-side
    # bookkeeping, bit-identical across engines and to the JAX package.
    trace: bool = False


@dataclass
class SimResult:
    times: list = field(default_factory=list)  # virtual seconds per record
    losses: list = field(default_factory=list)  # global mean loss
    accs: list = field(default_factory=list)
    events: list = field(default_factory=list)
    comm_time: float = 0.0
    compute_time: float = 0.0
    policy_updates: int = 0
    engine: str = "reference"  # which engine produced this result
    cohorts: int = 0  # batched engine: logical cohorts (levels / rounds)
    dispatches: int = 0  # batched engine: device dispatches (<= cohorts)
    # Scenario telemetry: every timed-out pull as (t, i, m), and every
    # published policy as (t, rho, P).
    failed_pulls: list = field(default_factory=list)
    policy_log: list = field(default_factory=list)
    # Failover telemetry (monitor_failover=True).
    leader_log: list = field(default_factory=list)
    skipped_refreshes: int = 0
    # Per-event trace stream (SimConfig.trace): one tuple
    # ``(t_start, duration, src, dst, kind, comm, compute, net)`` per event
    # in pop order, kind in {"pull", "local", "timeout"} for async events and
    # "round" for synchronous rounds (src = dst = -1), each round preceded by
    # one "pull" (or "timeout") record per link it queried, carrying the raw
    # network time in ``duration``.
    trace_events: list = field(default_factory=list)

    def time_to_loss(self, target: float) -> float:
        for t, l in zip(self.times, self.losses):
            if l <= target:
                return t
        return float("inf")

    def final_accuracy(self) -> float:
        return self.accs[-1] if self.accs else 0.0


def traced_round_timing(algo, state, cfg, link_model, groups, t, res):
    """``algo.round_timing`` plus trace capture (synchronous rounds).

    With tracing off this is a plain pass-through.  Traced, it installs
    ``link_model.query_tap`` for the duration of the call so every
    ``network_time`` query the round makes lands in ``res.trace_events`` as
    a per-link "pull" (or "timeout") record, followed by the aggregate
    "round" record.
    """
    if not cfg.trace:
        return algo.round_timing(state, cfg, link_model, groups, t)
    taps: list = []
    link_model.query_tap = lambda i, m, v, dead: taps.append((i, m, v, dead))
    try:
        timing = algo.round_timing(state, cfg, link_model, groups, t)
    finally:
        link_model.query_tap = None
    res.trace_events.extend(
        (t, v, i, m, "timeout" if dead else "pull", 0.0, 0.0, None)
        for (i, m, v, dead) in taps
    )
    res.trace_events.append(
        (t, timing.duration, -1, -1, "round", timing.comm, timing.compute,
         None)
    )
    return timing


def simulate(
    cfg: SimConfig,
    link_model: LinkTimeModel,
    data_x: np.ndarray,
    data_y: np.ndarray,
    part_idx: list[np.ndarray],
    eval_x: np.ndarray,
    eval_y: np.ndarray,
    record_every: int = 100,
    _cohort_log: list | None = None,
    *,
    init_params=None,
    device=None,
) -> SimResult:
    """Run one simulation; see the module docstring.

    ``init_params`` is the initial parameter tree (a list of ``{"w", "b"}``
    dicts); None draws it with ``mlp_init`` from a ``torch.Generator``
    seeded by ``cfg.seed``.  ``device`` defaults to CUDA and raises when
    there is none; pass ``device="cpu"`` to run on the CPU.
    """
    dev = resolve_device(device)
    algo = get_algorithm(cfg.algorithm)
    M = cfg.n_workers
    rng = np.random.default_rng(cfg.seed)
    dims = [data_x.shape[1], 128, 64, int(data_y.max()) + 1]
    if init_params is None:
        p0 = mlp_init(torch.Generator().manual_seed(cfg.seed), dims, dev)
    else:
        p0 = tree_map(lambda l: l.to(dev, copy=True), init_params)

    state = algo.init_state(cfg, M)
    res = SimResult()

    # ---------------- engine selection --------------------------------------
    engine = cfg.engine
    if engine == "auto":
        engine = "batched" if algo.supports_batched else "reference"
    if engine not in ("reference", "batched"):
        raise ValueError(f"unknown engine {cfg.engine!r}")
    if cfg.shard_workers and (engine != "batched" or algo.synchronous):
        # Where the JAX package would run unsharded, say so instead.
        raise ValueError(
            "cfg.shard_workers runs the batched engine's async gossip-family "
            f"strategies only, not {algo.name!r} on engine {engine!r}"
        )
    if engine == "batched":
        if not algo.supports_batched:
            raise ValueError(
                f"engine='batched' cannot execute {algo.name!r} "
                "(Algorithm.supports_batched is False); use engine='reference'"
            )
        from repro_torch.train.engine import run_batched, run_batched_sync

        if algo.synchronous:
            return run_batched_sync(
                algo, cfg, state, rng, p0, link_model,
                data_x, data_y, part_idx, eval_x, eval_y,
                record_every, res,
            )
        return run_batched(
            algo, cfg, state, rng, p0, link_model,
            data_x, data_y, part_idx, eval_x, eval_y,
            record_every, res, cohort_log=_cohort_log,
        )

    replicas = [tree_map(torch.clone, p0) for _ in range(M)]
    momenta = [tree_map(torch.zeros_like, p0) for _ in range(M)]
    dx, dy = to_device(data_x, dev), to_device(data_y, dev)
    ex, ey = to_device(eval_x, dev), to_device(eval_y, dev)

    def eval_now(t, ev):
        loss, acc = evaluate(mean_params(replicas), ex, ey)
        res.times.append(t)
        res.losses.append(loss)
        res.accs.append(acc)
        res.events.append(ev)

    def grad_step(i):
        idx = rng.choice(part_idx[i], size=min(cfg.batch_size, len(part_idx[i])))
        rows = torch.from_numpy(np.asarray(idx, dtype=np.int64)).to(dev)
        _, new_p, momenta[i] = _grad_step(
            replicas[i], dx[rows], dy[rows], cfg.lr, momenta[i], cfg.momentum
        )
        return new_p

    scn = link_model.compiled_scenario
    cursor = ScenarioCursor(scn) if scn is not None else None
    active = set(range(M))

    def reseed(w, src):
        reseed_replica(replicas, momenta, w, src)

    # ---------------- synchronous strategies: round-based loop ----------------
    if algo.synchronous:
        t = 0.0
        rounds = cfg.total_events // M
        for r in range(rounds):
            # Churn actions fire before the first round starting at or after
            # their time.  For round strategies only the rejoin reseed acts
            # here: the barrier still spans all M workers, so a departed
            # member stalls the round at the link timeout.
            if cursor is not None:
                for act in cursor.pop_due(t):
                    apply_action(act, active=active, reseed=reseed)
            groups = algo.select_groups(state, rng)
            timing = traced_round_timing(
                algo, state, cfg, link_model, groups, t, res
            )
            t += timing.duration
            res.comm_time += timing.comm
            res.compute_time += timing.compute
            for i in range(M):
                replicas[i] = grad_step(i)
            algo.reduce_groups(replicas, groups)
            if r % max(1, record_every // M) == 0:
                eval_now(t, (r + 1) * M)
        eval_now(t, rounds * M)
        return res

    # ---------------- asynchronous strategies: event-driven loop --------------
    monitor = algo.make_monitor(cfg, M, d=state.d) if algo.wants_monitor(cfg) else None
    # O(M^2) worker-side EMA state only exists to feed Monitor.collect.
    emas = ([IterationTimeEMA(M, beta=cfg.ema_beta) for _ in range(M)]
            if monitor is not None else None)
    next_monitor = monitor.schedule_period if monitor else float("inf")
    prepare_monitor(monitor, link_model)

    heap = EventHeap()
    for i in range(M):
        heap.push(rng.exponential(0.005), i)
    ev = 0
    t = 0.0
    while ev < cfg.total_events:
        # Scenario churn actions fire before the first event popping at or
        # after their time (heap membership, EMA reset, replica reseed).
        if cursor is not None:
            for act in cursor.pop_due(heap.peek_time()):
                apply_action(act, active=active, reseed=reseed, rng=rng,
                             heap=heap, emas=emas, ema_beta=cfg.ema_beta)
        t, i = heap.pop()
        ev += 1

        m = algo.select_peer(state, i, rng)
        x_half = grad_step(i)
        # A pull over a scenario-dead link times out: the attempt is priced,
        # nothing is mixed, and the Monitor is notified.
        failed = scn is not None and attempt_fails(link_model, algo, state, i, m, t)
        if failed:
            algo.apply_failed(state, cfg, replicas, i, x_half)
            res.failed_pulls.append((t, i, m))
            next_monitor = notify_monitor(
                monitor, i, m, t, next_monitor, link_model=link_model
            )
            communicated = True
        else:
            communicated = algo.apply_comm(state, cfg, replicas, i, m, x_half)
        timing = algo.event_timing(state, cfg, link_model, i, m, communicated, t)
        if cfg.trace:
            # ``failed`` first: the failed branch sets communicated=True (the
            # attempt is priced) but the record must say "timeout".
            kind = "timeout" if failed else (
                "pull" if communicated else "local"
            )
            res.trace_events.append(
                (t, timing.duration, i, m if m is not None else -1, kind,
                 timing.comm, timing.compute, timing.net)
            )
        res.comm_time += timing.comm
        res.compute_time += timing.compute
        if emas is not None and algo.reports_ema and m is not None:
            emas[i].update(m, timing.duration)

        heap.push(t + timing.duration, i)

        # Network Monitor wakes every T_s or at an out-of-schedule
        # failure-triggered refresh.
        if monitor is not None and t >= next_monitor:
            pol = monitor_boundary(
                monitor, algo, state, link_model, emas, active, t,
                chaos=cfg.chaos,
            )
            if pol is not None:
                res.policy_updates += 1
                res.policy_log.append((t, pol.rho, pol.P.copy()))
            next_monitor += monitor.schedule_period

        if ev % record_every == 0:
            eval_now(t, ev)
    eval_now(t, ev)
    if monitor is not None and monitor.failover is not None:
        res.leader_log = list(monitor.failover.leader_log)
        res.skipped_refreshes = monitor.failover.n_skipped_refreshes
    return res
