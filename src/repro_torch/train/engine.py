"""Batched engine for the event-driven simulator, in torch.

The port of the JAX package's ``train/engine.py``.  It keeps the *exact
same host-side machinery* as the reference loops (heap order, rng draw
order, LinkTimeModel draws, EMA updates, Monitor schedule, round barriers)
but stacks all M replicas/momenta into leading-M tensors and executes many
events per device dispatch.  It covers every registered strategy:

* **async gossip** (netmax, adpsgd, adpsgd+mon, netmax-topk) — cohorts of
  causally-independent events (``Algorithm.batched_variant == "gossip"``);
* **ps-async** — the ``"ps-serial"`` variant: a cohort's grad steps run
  stacked, and the PS running average is folded as a serialized chain over
  the cohort's ``x_half`` rows in pop order inside the same dispatch
  (``s <- s + w delta_transform(x_k - s)``, the reference's
  event-at-a-time recurrence);
* **synchronous rounds** (allreduce, prague, ps-sync) — ``run_batched_sync``
  runs each round as stacked masked grad steps plus one segment mean per
  leaf (``reduce_groups_stacked``); the rounds between record boundaries
  form one block, one dispatch.

Scheduling — verbatim from the JAX package, so ``SimResult.cohorts``,
``SimResult.dispatches`` and the cohort log match it exactly:

* **Windows** — events are *drawn* strictly in heap-pop order (peer
  selection, batch indices, link-time jitter, EMA updates), so every host
  rng consumes bits in exactly the reference order.  A window extends until
  the next *boundary*: a Monitor wake, a ``record_every`` evaluation, a
  scenario boundary, or the event cap.
* **Cohorts** — each window is level-scheduled into causally-independent
  event sets.  One fused dispatch gathers every pull from *pre-cohort*
  replica rows, computes, then scatters all actor rows; an event's level
  is one plus the maximum over its hazards on replica rows: (1) WAW/RAW on
  the actor row, (2) RAW on the peer row, (3) WAR on the actor row (the
  same level is fine: gathers happen before the scatter).  The ps-serial
  variant relaxes rule 2 on the serialized row: pushes into the PS may
  share a level (the step folds them in pop order); the PS node's own grad
  step lands strictly after every prior push.
* **Chains and bursts** — consecutive levels within a 2x row-bucket band
  run as one dispatch (a Python loop over the levels); runs of singleton
  levels of one worker run as one burst dispatch carrying just that
  worker's row (skipped under ``use_mix_kernel``, as in the JAX package,
  so every mix goes through one rule).  Under ps-serial a window runs as
  pop-ordered bursts carrying the PS row, broken where a non-PS actor
  repeats.

Device side: the vmapped ``value_and_grad`` becomes a stacked batched
matmul forward and one autograd pass over the sum of the per-row mean
losses (row k's gradient is exactly the gradient of its own mean loss);
donation becomes in-place ``index_copy_`` into the stacked tensors, after
every gather of the cohort.  Cohorts are padded to ~1.5x-stepped row
buckets with distinct idle workers (valid=0, written back unchanged), as in
the JAX package; chain and burst levels that are pure padding are no-ops
and are skipped.  Under ``SimConfig.use_mix_kernel`` the mix is
``kernels/ops.gossip_mix_tree``: on a card, the CUDA gossip-mix kernel, one
launch for the cohort's whole parameter tree, with no u operand, for
identity-delta gossip strategies only; the ps-serial fold, netmax-topk's
sparsified delta and the sync rounds take the leaf rule, as in the JAX
package.

**Device-sharded** (``SimConfig.shard_workers``, async gossip family only):
the stacked rows split over the ranks of the default process group (one a
card), each rank holding M / world of them.  Every rank runs the whole
host event loop, which is deterministic from the seed, so the host results
are the same on every rank.  Each cohort runs as one full-M masked step
(``_sharded_step``): host vectors perm (M,) (identity for idle workers),
w (M,), valid (M,) and bidx (M, B), of which each rank steps its own rows;
the pre-cohort pull is ``dist.gossip.pull_ppermute`` when every worker has
its own rank and the peer map is a permutation, the cross-rank gather
otherwise.  One dispatch a cohort, as in the JAX package; the evaluation
sees every row (``all_gather``).  The path exists to split replica memory
across cards, not for speed.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.algos.base import Algorithm
from repro_torch.core.monitor import IterationTimeEMA
from repro_torch.dist import gossip
from repro_torch.dist.sharding import worker_shard
from repro_torch.kernels import ops as kops
from repro_torch.scenarios.driver import (
    apply_action,
    attempt_fails,
    monitor_boundary,
    notify_monitor,
    prepare_monitor,
)
from repro_torch.scenarios.timeline import ScenarioCursor
from repro_torch.train import simulator as _sim
from repro_torch.train.elastic import reseed_row
from repro_torch.train.events import EventHeap
from repro_torch.tree import tree_leaves, tree_map


def _bucket(n: int, cap: int) -> int:
    """Smallest ~1.5x-stepped bucket >= n, capped at M (pad rows must be
    distinct)."""
    b = 1
    while b < n:
        b = b * 2 if b < 4 else (b * 3 + 1) // 2
    return min(b, cap)


#: Longest run of cohorts one fused dispatch may carry.
_CHAIN_CAP = 64

#: Shortest singleton-level run worth the dedicated burst dispatch.
_BURST_MIN = 4

#: Longest singleton run one burst dispatch may carry.
_BURST_CAP = 128


def _chain_bucket(n: int, cap: int = _CHAIN_CAP) -> int:
    """~1.5x-stepped bucket for chain lengths, capped (the operand's level
    count; levels past the chain's own are valid=0 no-ops)."""
    b = 2
    while b < n:
        b = (b * 3 + 1) // 2
    return min(b, cap)


def _stacked_loss(params, x, y):
    """Sum over rows of each row's mean cross entropy: its gradient w.r.t.
    row k's parameters is row k's own mean-loss gradient."""
    return _sim.ce_rows(_sim.mlp_apply(params, x), y).mean(-1).sum()


def _keep_valid(valid, new, old):
    def f(n, o):
        return torch.where(valid.reshape((-1,) + (1,) * (n.ndim - 1)), n, o)

    return tree_map(f, new, old)


@torch.no_grad()
def _ps_fold(algo: Algorithm, s, x, wk):
    """One push into the serialized PS row: ``s + w delta_transform(x - s)``,
    ``Algorithm.mix(s, x, w)`` with ``w`` a device scalar."""
    return tree_map(
        lambda s_l, x_l: s_l + wk.to(s_l.dtype) * algo.delta_transform(x_l - s_l), s, x)


def _make_cohort_body(algo: Algorithm, lr: float, mu: float,
                      use_mix_kernel: bool, sr: int | None):
    """The fused step for one cohort.

    Signature: (R, Mom, dx, dy, ints_h, ints, w) -> (R, Mom), updating the
    stacked R/Mom leaves (M, ...) in place.  ``ints`` is a (K, 3+B) int64
    device tensor packing [actor row, peer row (gossip) or push flag
    (ps-serial), valid, batch indices...], ``ints_h`` the same on the host,
    and ``w`` (K,) f32 the mix weights (0 => no communication).  valid=0
    marks padding: the row is written back unchanged.
    """
    identity_delta = type(algo).delta_transform is Algorithm.delta_transform

    def grad_half(R, Mom, dx, dy, ints):
        """Shared front half: stacked grads + momentum + local step."""
        idx = ints[:, 0].contiguous()
        bidx = ints[:, 3:]
        h = tree_map(lambda l: l.index_select(0, idx), R)
        mom = tree_map(lambda l: l.index_select(0, idx), Mom)
        _, grads = _sim.value_and_grad(_stacked_loss, h, dx[bidx], dy[bidx])
        with torch.no_grad():
            new_m = tree_map(lambda m_, g: mu * m_ + g, mom, grads)
            x_half = tree_map(lambda p, m_: p - lr * m_, h, new_m)
        return idx, ints[:, 2] > 0, h, mom, new_m, x_half

    def commit(R, Mom, idx, valid, h, mom, new, new_m):
        new = _keep_valid(valid, new, h)
        new_m = _keep_valid(valid, new_m, mom)
        tree_map(lambda l, v: l.index_copy_(0, idx, v), R, new)
        tree_map(lambda l, v: l.index_copy_(0, idx, v), Mom, new_m)

    if algo.batched_variant == "ps-serial":

        def body(R, Mom, dx, dy, ints_h, ints, w):
            idx, valid, h, mom, new_m, x_half = grad_half(R, Mom, dx, dy, ints)
            s, wrote = None, False
            with torch.no_grad():
                # The serialized row, in pop order; a push's row takes the
                # PS value after it (written into x_half, whose later rows
                # are read before they are written).
                for k in range(len(ints_h)):
                    if not ints_h[k, 2]:
                        continue
                    xk = tree_map(lambda l: l[k], x_half)
                    if ints_h[k, 1]:  # a push into the PS row
                        if s is None:
                            s = tree_map(lambda l: l[sr], R)
                        s = _ps_fold(algo, s, xk, w[k])
                        tree_map(lambda l, v: l.copy_(v), xk, s)
                        wrote = True
                    elif ints_h[k, 0] == sr:  # the PS node's local step
                        s, wrote = xk, True
                commit(R, Mom, idx, valid, h, mom, x_half, new_m)
                if wrote:
                    tree_map(lambda l, v: l[sr].copy_(v), R, s)
            return R, Mom

    else:

        def mix(x_half, pulled, w):
            if use_mix_kernel and identity_delta:
                return kops.gossip_mix_tree(x_half, pulled, w)
            return algo.mix_stacked_tree(x_half, pulled, w)

        def body(R, Mom, dx, dy, ints_h, ints, w):
            idx, valid, h, mom, new_m, x_half = grad_half(R, Mom, dx, dy, ints)
            with torch.no_grad():
                peer = ints[:, 1].contiguous()
                pulled = tree_map(lambda l: l.index_select(0, peer), R)  # pre-cohort
                commit(R, Mom, idx, valid, h, mom, mix(x_half, pulled, w), new_m)
            return R, Mom

    return body


def _make_burst_body(algo: Algorithm, lr: float, mu: float, sr: int | None):
    """Singleton-run step: a stretch of consecutive singleton levels, which
    touches the stacked tensors once at each end instead of once a level.

    * gossip — the run belongs to ONE worker: carry its (row, momentum);
      peers are read from the pre-burst stack (sound: the run's levels
      contain no other events, so no peer row changes mid-burst).
      Signature (R, Mom, dx, dy, i, ints, w), ``i`` the actor, ``ints``
      (L, 2+B) numpy int32 [peer row, valid, batch indices...].
    * ps-serial — the run may mix actors (PS local steps and pushes from
      distinct workers): carry the serialized (PS row, PS momentum); each
      pusher's row/momentum is read from the pre-burst stack (sound: the
      host breaks the run before any non-PS actor repeats) and written
      once after the run.  Signature (R, Mom, dx, dy, ints, w), ``ints``
      (L, 3+B) numpy int32 [actor row, push flag, valid, batch indices...].
    """

    def grad_half(row, mom, xb, yb):
        _, g = _sim.value_and_grad(_sim.ce_loss, row, xb, yb)
        with torch.no_grad():
            mom2 = tree_map(lambda m_, gg: mu * m_ + gg, mom, g)
            x_half = tree_map(lambda p, m_: p - lr * m_, row, mom2)
        return mom2, x_half

    def one_row(tree, i):
        return tree_map(lambda l: l[i], tree)

    if algo.batched_variant == "ps-serial":

        def body(R, Mom, dx, dy, ints, w):
            dev = dx.device
            bidx = torch.from_numpy(ints[:, 3:].astype(np.int64)).to(dev)
            wd = torch.from_numpy(w).to(dev)
            s, mom_s = one_row(R, sr), one_row(Mom, sr)
            out = {}  # non-PS actor -> (row, momentum) to write back
            for k in range(len(ints)):
                if ints[k, 2] == 0:
                    continue  # pad step: a no-op
                actor, push = int(ints[k, 0]), bool(ints[k, 1])
                is_ps = not push and actor == sr
                row, mom = (s, mom_s) if is_ps else (one_row(R, actor), one_row(Mom, actor))
                mom2, xh = grad_half(row, mom, dx[bidx[k]], dy[bidx[k]])
                if push:
                    s = _ps_fold(algo, s, xh, wd[k])
                    out[actor] = (s, mom2)
                elif is_ps:
                    s, mom_s = xh, mom2
                else:
                    out[actor] = (xh, mom2)
            with torch.no_grad():
                for actor, (row, mom) in out.items():
                    tree_map(lambda l, v: l[actor].copy_(v), R, row)
                    tree_map(lambda l, v: l[actor].copy_(v), Mom, mom)
                tree_map(lambda l, v: l[sr].copy_(v), R, s)
                tree_map(lambda l, v: l[sr].copy_(v), Mom, mom_s)
            return R, Mom

    else:

        def body(R, Mom, dx, dy, i, ints, w):
            dev = dx.device
            bidx = torch.from_numpy(ints[:, 2:].astype(np.int64)).to(dev)
            wd = torch.from_numpy(w).to(dev)
            row, mom = one_row(R, i), one_row(Mom, i)
            for k in range(len(ints)):
                if ints[k, 1] == 0:
                    continue  # pad step: a no-op
                mom, xh = grad_half(row, mom, dx[bidx[k]], dy[bidx[k]])
                peer = int(ints[k, 0])
                with torch.no_grad():
                    # THE leaf rule (Algorithm.mix_stacked_tree), applied to
                    # a single row via a length-1 leading axis.
                    row = one_row(
                        algo.mix_stacked_tree(
                            tree_map(lambda l: l[None], xh),
                            tree_map(lambda l: l[peer:peer + 1], R),
                            wd[k:k + 1],
                        ), 0)
            with torch.no_grad():
                tree_map(lambda l, v: l[i].copy_(v), R, row)
                tree_map(lambda l, v: l[i].copy_(v), Mom, mom)
            return R, Mom

    return body


def _operands(ints: np.ndarray, w: np.ndarray, dev):
    return (torch.from_numpy(ints.astype(np.int64)).to(dev),
            torch.from_numpy(w).to(dev))


def _sharded_step(algo: Algorithm, lr: float, mu: float, use_mix_kernel: bool,
                  mesh, shard):
    """The full-M masked cohort step of the device-sharded path.

    Signature: (R, Mom, dx, dy, perm, w, valid, bidx) with R/Mom this
    rank's rows (M/world, ...), updated in place, and host operands over
    all M workers: perm (M,) peer rows (identity for idle workers), w (M,)
    mix weights, valid (M,) actor mask, bidx (M, B) batch indices.  Every
    local row takes the grad + momentum half-step; the actors' rows take
    the mix with their pre-cohort peer rows, the others stay as they were.
    Under ``use_mix_kernel`` identity-delta strategies mix through
    ``kernels/ops.gossip_mix_tree``, as the cohort body does.  ``shard``:
    this rank's ``WorkerShard`` of the 1-D ``("workers",)`` mesh."""
    identity_delta = type(algo).delta_transform is Algorithm.delta_transform
    axes, M = ("workers",), shard.M
    lo, hi = shard.rows.start, shard.rows.stop

    def step(R, Mom, dx, dy, perm, w, valid, bidx):
        dev = dx.device
        b = torch.from_numpy(bidx[lo:hi].astype(np.int64)).to(dev)
        _, grads = _sim.value_and_grad(_stacked_loss, R, dx[b], dy[b])
        with torch.no_grad():
            new_m = tree_map(lambda m_, g: mu * m_ + g, Mom, grads)
            x_half = tree_map(lambda p, m_: p - lr * m_, R, new_m)
            if len(shard.ranks) == M and len(set(perm.tolist())) == M:
                # One worker a rank and a true permutation: point to point.
                pulled = gossip.pull_ppermute(R, tuple(int(p) for p in perm), mesh, axes)
            else:
                pulled = gossip.pull_gather(R, perm, mesh, axes)
            wd = torch.from_numpy(w[lo:hi]).to(dev)
            if use_mix_kernel and identity_delta:
                mixed = kops.gossip_mix_tree(x_half, pulled, wd)
            else:
                mixed = algo.mix_stacked_tree(x_half, pulled, wd)
            keep = torch.from_numpy(valid[lo:hi]).to(dev)
            tree_map(lambda l, v: l.copy_(v), R, _keep_valid(keep, mixed, R))
            tree_map(lambda l, v: l.copy_(v), Mom, _keep_valid(keep, new_m, Mom))
        return R, Mom

    return step


def _sharded_mesh(algo: Algorithm, M: int, device: torch.device):
    """The 1-D ``("workers",)`` mesh over every rank of the default process
    group; refuses what the sharded path cannot run."""
    if algo.batched_variant != "gossip":
        raise ValueError(
            "cfg.shard_workers supports async gossip-family strategies "
            f"only, not {algo.name!r} (variant {algo.batched_variant!r})"
        )
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError(
            "cfg.shard_workers splits the replicas over the ranks of the default "
            "process group; initialise it first (torch.distributed."
            "init_process_group, one rank a card)"
        )
    world = dist.get_world_size()
    if M % world != 0:
        raise ValueError(
            f"cfg.shard_workers needs n_workers ({M}) divisible by the "
            f"world size ({world})"
        )
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device.type, (world,), mesh_dim_names=("workers",))


def _steps_for(algo: Algorithm, lr: float, mu: float, use_mix_kernel: bool,
               sr: int | None):
    """(step, chain_step, burst_step) over host (numpy) operands."""
    if algo.batched_variant not in ("gossip", "ps-serial"):
        # A variant this engine doesn't implement must fail loudly — falling
        # through to the gossip body would silently compute wrong updates.
        raise NotImplementedError(
            f"batched_variant {algo.batched_variant!r} of {algo.name!r} is "
            "not implemented by the batched engine; use engine='reference'"
        )
    body = _make_cohort_body(algo, lr, mu, use_mix_kernel, sr)

    def step(R, Mom, dx, dy, ints, w):
        return body(R, Mom, dx, dy, ints, *_operands(ints, w, dx.device))

    def chain_step(R, Mom, dx, dy, ints_seq, w_seq):
        ints_d, w_d = _operands(ints_seq, w_seq, dx.device)
        for l in range(len(ints_seq)):
            if ints_seq[l, :, 2].any():  # all-pad levels are no-ops
                R, Mom = body(R, Mom, dx, dy, ints_seq[l], ints_d[l], w_d[l])
        return R, Mom

    return step, chain_step, _make_burst_body(algo, lr, mu, sr)


def run_batched(
    algo: Algorithm,
    cfg,
    state,
    rng: np.random.Generator,
    p0,
    link_model,
    data_x: np.ndarray,
    data_y: np.ndarray,
    part_idx,
    eval_x: np.ndarray,
    eval_y: np.ndarray,
    record_every: int,
    res,
    cohort_log: list | None = None,
):
    """Run the async event loop on stacked state; mutates and returns ``res``.

    ``p0`` is the initial parameter tree on the target device.
    ``cohort_log``, when a list, receives one entry per cohort (event
    number, actor, peer or None).  Chain fusion never changes the logical
    cohort structure; it only packs consecutive levels into fewer device
    dispatches (``res.dispatches``).
    """
    M = cfg.n_workers
    total = cfg.total_events
    sr = algo.serial_row(state) if algo.batched_variant == "ps-serial" else None
    step, chain_step, burst_step = _steps_for(algo, cfg.lr, cfg.momentum,
                                              cfg.use_mix_kernel, sr)
    fuse = getattr(cfg, "fuse_chains", True)
    dev = tree_leaves(p0)[0].device

    # Device-sharded path (SimConfig.shard_workers): this rank holds rows
    # lo..hi of the stacked state, and cohorts run as full-M masked steps.
    shard = None
    lo, hi = 0, M
    if getattr(cfg, "shard_workers", False):
        mesh = _sharded_mesh(algo, M, dev)
        shard = worker_shard(mesh, ("workers",), M)
        lo, hi = shard.rows.start, shard.rows.stop
        sharded_step = _sharded_step(algo, cfg.lr, cfg.momentum, cfg.use_mix_kernel,
                                     mesh, shard)

    # Stacked replicas: all workers start from the same p0, like the
    # reference engine's per-replica copies.
    R = tree_map(lambda l: l.unsqueeze(0).repeat((hi - lo,) + (1,) * l.ndim), p0)
    Mom = tree_map(lambda l: torch.zeros((hi - lo,) + tuple(l.shape), dtype=l.dtype,
                                         device=dev), p0)

    monitor = algo.make_monitor(cfg, M, d=state.d) if algo.wants_monitor(cfg) else None
    # Worker-side EMA matrices only ever feed Monitor.collect, so
    # monitor-less runs skip them (EMA updates consume no rng).
    emas = ([IterationTimeEMA(M, beta=cfg.ema_beta) for _ in range(M)]
            if monitor is not None else None)
    next_monitor = monitor.schedule_period if monitor else float("inf")
    prepare_monitor(monitor, link_model)

    # Scenario machinery: the cursor's boundaries are window breaks — no
    # fused cohort or chain ever spans a scenario boundary.
    scn = link_model.compiled_scenario
    cursor = ScenarioCursor(scn) if scn is not None else None
    active = set(range(M))

    def reseed(w, src):
        nonlocal R, Mom
        if shard is None:
            R, Mom = reseed_row(R, Mom, w, src)
            return
        # Row src may live on another rank: every rank takes part in the pull.
        perm = np.arange(M)
        perm[w] = src
        pulled = gossip.pull_gather(R, perm, mesh, ("workers",))
        if lo <= w < hi:
            with torch.no_grad():
                for leaf, p in zip(tree_leaves(R), tree_leaves(pulled)):
                    leaf[w - lo].copy_(p[w - lo])
                for leaf in tree_leaves(Mom):
                    leaf[w - lo].zero_()

    ex, ey = _sim.to_device(eval_x, dev), _sim.to_device(eval_y, dev)
    # Training set lives on the device; per-cohort batches are gathered
    # there from (K, B) index arrays.
    dx, dy = _sim.to_device(data_x, dev), _sim.to_device(data_y, dev)

    def eval_now(t, ev):
        with torch.no_grad():
            rows = R if shard is None else tree_map(shard.gather, R)  # every row
            mean_p = tree_map(lambda l: l.mean(dim=0), rows)
        loss, acc = _sim.evaluate(mean_p, ex, ey)
        res.times.append(t)
        res.losses.append(loss)
        res.accs.append(acc)
        res.events.append(ev)

    bsz = [min(cfg.batch_size, len(part_idx[i])) for i in range(M)]

    heap = EventHeap()
    for i in range(M):
        heap.push(rng.exponential(0.005), i)

    ev = 0
    t = 0.0
    window_cap = max(4 * M, 64)  # backstop when record_every is huge

    def draw_event():
        """Pop + fully draw the next event, consuming every host rng in
        reference order (peer, batch, link jitter, EMA, reschedule).  A
        pull over a scenario-dead link is priced as the timeout, notifies
        the Monitor, and executes as a plain local step (communicated
        False => the fused step self-pulls with w=0)."""
        nonlocal ev, t, next_monitor
        t_ev, i = heap.pop()
        ev += 1
        m = algo.select_peer(state, i, rng)
        bidx = rng.choice(part_idx[i], size=bsz[i])
        failed = scn is not None and attempt_fails(
            link_model, algo, state, i, m, t_ev
        )
        communicated = (not failed) and algo.would_communicate(state, i, m)
        w = algo.mix_weight(state, cfg, i, m) if communicated else 0.0
        timing = algo.event_timing(
            state, cfg, link_model, i, m, communicated or failed, t_ev
        )
        if cfg.trace:
            kind = "timeout" if failed else (
                "pull" if communicated else "local"
            )
            res.trace_events.append(
                (t_ev, timing.duration, i, m if m is not None else -1, kind,
                 timing.comm, timing.compute, timing.net)
            )
        res.comm_time += timing.comm
        res.compute_time += timing.compute
        if failed:
            res.failed_pulls.append((t_ev, i, m))
            next_monitor = notify_monitor(
                monitor, i, m, t_ev, next_monitor, link_model=link_model
            )
        if emas is not None and algo.reports_ema and m is not None:
            emas[i].update(m, timing.duration)
        heap.push(t_ev + timing.duration, i)
        t = t_ev
        return (t_ev, i, m, float(w), communicated, bidx, ev)

    def schedule_window(window):
        """Level-schedule a window into causally-independent cohorts.

        One O(1)-per-event pass in pop order; see the module docstring for
        the three hazard rules.  Returns cohorts ordered by level, each a
        pop-ordered event list with all-distinct actors; executing them in
        order with gather-before-scatter semantics reproduces the
        reference's strictly-sequential result exactly.
        """
        last_write: dict[int, int] = {}  # row -> level of its latest write
        max_read: dict[int, int] = {}  # row -> highest level that read it
        last_sw = 0  # level of the serialized row's latest write (ps-serial)
        groups: list[list] = []
        level_blen: list = []  # batch length per level (one dispatch each)
        for e in window:
            _, i, m, _, communicated, bidx, _ = e
            lvl = last_write.get(i, 0) + 1  # rules 1 (WAW/RAW on actor row)
            if communicated:
                if sr is not None and m == sr:
                    # Serialized push: may share the last writer's level —
                    # the fused step folds same-level pushes in pop order —
                    # but must never land in an earlier one.
                    lvl = max(lvl, last_sw)
                else:
                    lvl = max(lvl, last_write.get(m, 0) + 1)  # rule 2 (RAW peer)
                    # rule 3 bookkeeping happens below via max_read
            elif sr is not None and i == sr:
                # The PS node's own grad step reads the PS row *outside* the
                # chain (pre-level gather), so every prior push must have
                # scattered already.
                lvl = max(lvl, last_sw + 1)
            lvl = max(lvl, max_read.get(i, 0))  # rule 3 (WAR on actor row)
            # One fused call needs a uniform batch length, and rule 3's
            # same-level exemption is only sound if the whole level IS one
            # call (gather-before-scatter) — so batch length is part of a
            # level's identity.  Raising a level past a mismatched one is
            # always safe: every hazard above is a lower bound, and the
            # bookkeeping below records the *final* level.
            blen = len(bidx)
            while lvl <= len(level_blen) and level_blen[lvl - 1] != blen:
                lvl += 1
            last_write[i] = lvl
            if communicated:
                if sr is not None and m == sr:
                    last_sw = max(last_sw, lvl)
                else:
                    max_read[m] = max(max_read.get(m, 0), lvl)
            if sr is not None and i == sr:
                last_sw = max(last_sw, lvl)  # PS-local event rewrites the row
            while len(groups) < lvl:  # lvl <= len(groups)+1: no gaps
                groups.append([])
                level_blen.append(blen)
            groups[lvl - 1].append(e)
        return groups

    def pack(cohort, B):
        """Pack one cohort into (ints, w) operands padded to bucket B."""
        K = len(cohort)
        actors = {e[1] for e in cohort}
        blen = len(cohort[0][5])
        ints = np.zeros((B, 3 + blen), np.int32)
        w = np.zeros(B, np.float32)
        for k, e in enumerate(cohort):
            ints[k, 0] = e[1]
            if sr is not None:
                ints[k, 1] = 1 if e[4] else 0  # push flag
            else:
                # self-pull (w=0) for non-communicating events
                ints[k, 1] = e[2] if e[4] else e[1]
            ints[k, 2] = 1
            ints[k, 3:] = e[5]
            w[k] = e[3]
        if B > K:  # pad rows: distinct idle workers, written back unchanged
            # First B-K non-actor rows, ascending — an incremental walk, so
            # a fleet-sized M doesn't pay an O(M) scan per tiny cohort.
            free = np.empty(B - K, np.int32)
            n, r = 0, 0
            while n < B - K:
                if r not in actors:
                    free[n] = r
                    n += 1
                r += 1
            ints[K:, 0] = free
            if sr is None:
                ints[K:, 1] = free
        return ints, w

    def dispatch_sharded(cohort):
        """One cohort as a full-M masked step on every rank's rows."""
        nonlocal R, Mom
        blen = len(cohort[0][5])
        perm = np.arange(M, dtype=np.int64)
        wv = np.zeros(M, np.float32)
        valid = np.zeros(M, bool)
        bidx = np.zeros((M, blen), np.int64)
        for e in cohort:
            i = e[1]
            perm[i] = e[2] if e[4] else i
            wv[i] = e[3]
            valid[i] = True
            bidx[i] = e[5]
        R, Mom = sharded_step(R, Mom, dx, dy, perm, wv, valid, bidx)
        res.dispatches += 1

    chain_acc: list = []  # consecutive fusable cohorts awaiting one dispatch
    chain_lo = chain_hi = 0  # row-bucket band of the accumulating chain

    def flush_chain():
        nonlocal R, Mom
        if not chain_acc:
            return
        if len(chain_acc) == 1:
            ints, w = pack(chain_acc[0], _bucket(len(chain_acc[0]), M))
            R, Mom = step(R, Mom, dx, dy, ints, w)
        else:
            blen = len(chain_acc[0][0][5])
            B = chain_hi  # uniform bucket per chain (the band's max)
            L = _chain_bucket(len(chain_acc))
            ints_seq = np.zeros((L, B, 3 + blen), np.int32)  # pads: valid=0
            w_seq = np.zeros((L, B), np.float32)
            for l, c in enumerate(chain_acc):
                ints_seq[l], w_seq[l] = pack(c, B)
            R, Mom = chain_step(R, Mom, dx, dy, ints_seq, w_seq)
        res.dispatches += 1
        chain_acc.clear()

    def dispatch_burst(run):
        """One serial-chain dispatch over a pop-ordered event run (see
        ``_make_burst_body``)."""
        nonlocal R, Mom
        blen = len(run[0][5])
        L = _chain_bucket(len(run), _BURST_CAP)
        w = np.zeros(L, np.float32)
        if sr is not None:  # ps-serial: [actor, push, valid, batch...]
            ints = np.zeros((L, 3 + blen), np.int32)  # pads: valid=0 no-ops
            for l, e in enumerate(run):
                ints[l, 0] = e[1]
                ints[l, 1] = 1 if e[4] else 0
                ints[l, 2] = 1
                ints[l, 3:] = e[5]
                w[l] = e[3]
            R, Mom = burst_step(R, Mom, dx, dy, ints, w)
        else:  # gossip: one actor; [peer, valid, batch...]
            ints = np.zeros((L, 2 + blen), np.int32)
            for l, e in enumerate(run):
                ints[l, 0] = e[2] if e[4] else e[1]
                ints[l, 1] = 1
                ints[l, 2:] = e[5]
                w[l] = e[3]
            R, Mom = burst_step(R, Mom, dx, dy, run[0][1], ints, w)
        res.dispatches += 1

    def chain_in(cohort):
        """Feed one level into the band chain, flushing when it won't fit.

        A chain accepts a level while the row buckets stay within a 2x
        band (every level pads to the band's max, so the band bounds the
        wasted rows at ~1/2).
        """
        nonlocal chain_lo, chain_hi
        B = _bucket(len(cohort), M)
        blen = len(cohort[0][5])
        if chain_acc and not (
            len(chain_acc) < _CHAIN_CAP
            and len(chain_acc[0][0][5]) == blen
            and max(chain_hi, B) <= 2 * min(chain_lo, B)
        ):
            flush_chain()
        if not chain_acc:
            chain_lo = chain_hi = B
        else:
            chain_lo, chain_hi = min(chain_lo, B), max(chain_hi, B)
        chain_acc.append(cohort)

    def execute_window(levels, window):
        """Dispatch one window.

        Levels are always counted/logged (the logical cohort structure is
        execution-independent).  Execution is fused three ways:

        * ps-serial + fusion — the serialized row makes the whole stream
          sequential, so the window executes as pop-ordered bursts carrying
          the PS row and momentum, broken only where a non-PS actor repeats
          (its second grad must re-read its own written row), the batch
          length changes, or ``_BURST_CAP``;
        * gossip + fusion — runs of >= _BURST_MIN consecutive singleton
          levels of one worker go through the single-row burst; everything
          else accumulates into band chains (``chain_in``);
        * fusion off — one dispatch per level.
        """
        nonlocal R, Mom
        for cohort in levels:
            res.cohorts += 1
            if cohort_log is not None:
                cohort_log.append(
                    [(e[6], e[1], e[2] if e[4] else None) for e in cohort]
                )
        if shard is not None:
            # The sharded path has its own dispatch shape (full-M masked
            # rows); the fusion machinery stays on the dense path.
            for cohort in levels:
                dispatch_sharded(cohort)
            return
        if not fuse:
            for cohort in levels:
                ints, w = pack(cohort, _bucket(len(cohort), M))
                R, Mom = step(R, Mom, dx, dy, ints, w)
                res.dispatches += 1
            return
        if sr is not None:
            run: list = []
            actors: set[int] = set()
            for e in window:
                if run and (
                    len(run) >= _BURST_CAP
                    or len(e[5]) != len(run[0][5])
                    or (e[1] != sr and e[1] in actors)
                ):
                    dispatch_burst(run)
                    run, actors = [], set()
                run.append(e)
                if e[1] != sr:
                    actors.add(e[1])
            if run:
                dispatch_burst(run)
            return
        # Group levels into maximal single-actor singleton runs (the busiest
        # worker's sequential tail) vs the rest.  With use_mix_kernel the
        # cohort path mixes through kernels/ops while bursts use the leaf
        # rule — keep every dispatch on one rule by skipping bursts there
        # (band chains still fuse).
        burst_ok = not cfg.use_mix_kernel
        runs: list[list] = []
        for cohort in levels:
            if (
                len(cohort) == 1
                and runs
                and runs[-1][0] == "burst"
                and len(runs[-1][1]) < _BURST_CAP
                and runs[-1][1][-1][1] == cohort[0][1]
                and len(runs[-1][1][-1][5]) == len(cohort[0][5])
            ):
                runs[-1][1].append(cohort[0])
            elif len(cohort) == 1:
                runs.append(["burst", [cohort[0]]])
            else:
                runs.append(["normal", cohort])
        for kind, item in runs:
            if kind == "burst" and len(item) >= _BURST_MIN and burst_ok:
                flush_chain()  # preserve level order across dispatch paths
                dispatch_burst(item)
            elif kind == "burst":
                for e in item:  # short run: ride the band chain instead
                    chain_in([e])
            else:
                chain_in(item)
        flush_chain()

    while ev < total:
        # ---- scenario churn actions fire before the first event popping
        # at or after their time, between device dispatches ----
        if cursor is not None:
            for act in cursor.pop_due(heap.peek_time()):
                apply_action(act, active=active, reseed=reseed, rng=rng,
                             heap=heap, emas=emas, ema_beta=cfg.ema_beta)
        # ---- draw one window of events, stopping at the next boundary ----
        window = []
        while len(window) < window_cap and ev < total:
            if cursor is not None and heap.peek_time() >= cursor.next_time:
                break  # scenario boundary: flush before crossing it
            e = draw_event()
            window.append(e)
            if (monitor is not None and e[0] >= next_monitor) or e[6] % record_every == 0:
                break
        if not window:
            continue  # boundary was immediately due; actions now applied
        t_last, ev_last = window[-1][0], window[-1][6]

        # ---- execute the whole window, level by level (chains fused) ----
        execute_window(schedule_window(window), window)

        # ---- boundaries fire after the window, exactly as the reference
        # loop fires them after the boundary event (Monitor first, then the
        # periodic evaluation) ----
        if monitor is not None and t_last >= next_monitor:
            pol = monitor_boundary(
                monitor, algo, state, link_model, emas, active, t_last,
                chaos=cfg.chaos,
            )
            if pol is not None:
                res.policy_updates += 1
                res.policy_log.append((t_last, pol.rho, pol.P.copy()))
            next_monitor += monitor.schedule_period
        if ev_last % record_every == 0:
            eval_now(t_last, ev_last)

    eval_now(t, ev)
    if monitor is not None and monitor.failover is not None:
        res.leader_log = list(monitor.failover.leader_log)
        res.skipped_refreshes = monitor.failover.n_skipped_refreshes
    res.engine = "batched"
    return res


# --------------------------------------------------------------------------
# Synchronous families: stacked round executor
# --------------------------------------------------------------------------


def _make_sync_round_body(algo: Algorithm, lr: float, mu: float):
    """One synchronous round on stacked trees: masked grad steps for every
    worker, then the one-segment-mean group averaging
    (``reduce_groups_stacked``).

    Signature: (R, Mom, dx, dy, mask, gid, idx) -> (R, Mom) with R/Mom
    leaves (M, ...), ``idx`` (M, B) int64 per-worker batch indices, ``mask``
    (M, B) f32 marking real samples (per-worker batch sizes may differ when
    shards are smaller than cfg.batch_size), and ``gid`` (M,) int64
    reduction group ids.
    """

    def masked_loss(params, x, y, mask):
        # Sum over workers of each worker's masked mean cross entropy: its
        # gradient w.r.t. row k is row k's own loss gradient.
        per = _sim.ce_rows(_sim.mlp_apply(params, x), y)
        return ((per * mask).sum(-1) / mask.sum(-1)).sum()

    def body(R, Mom, dx, dy, mask, gid, idx):
        _, grads = _sim.value_and_grad(masked_loss, R, dx[idx], dy[idx], mask)
        with torch.no_grad():
            Mom = tree_map(lambda m_, g: mu * m_ + g, Mom, grads)
            x_half = tree_map(lambda p, m_: p - lr * m_, R, Mom)
            R = algo.reduce_groups_stacked(x_half, gid)
        return R, Mom

    return body


def run_batched_sync(
    algo: Algorithm,
    cfg,
    state,
    rng: np.random.Generator,
    p0,
    link_model,
    data_x: np.ndarray,
    data_y: np.ndarray,
    part_idx,
    eval_x: np.ndarray,
    eval_y: np.ndarray,
    record_every: int,
    res,
):
    """Round-based strategies on stacked trees; mutates and returns ``res``.

    Host-side machinery is drawn in exactly the reference sync loop's order
    (``select_groups`` -> ``round_timing`` -> per-worker batch draws), so
    ``times``/``comm_time``/``compute_time`` are bit-identical; only the
    device math is reassociated (stacked grads, segment means).  The rounds
    between record boundaries form one block, counted as one dispatch (a
    loop over its rounds here, one ``lax.scan`` in the JAX package) when
    ``cfg.fuse_chains`` is on, one dispatch a round otherwise.
    """
    M = cfg.n_workers
    rounds = cfg.total_events // M
    fuse = getattr(cfg, "fuse_chains", True)
    dev = tree_leaves(p0)[0].device

    R = tree_map(lambda l: l.unsqueeze(0).repeat((M,) + (1,) * l.ndim), p0)
    Mom = tree_map(lambda l: torch.zeros((M,) + tuple(l.shape), dtype=l.dtype,
                                         device=dev), p0)
    step = _make_sync_round_body(algo, cfg.lr, cfg.momentum)

    # Scenario machinery: boundaries break the round blocks so a rejoin
    # reseed lands between dispatches, at the same round as the reference
    # loop; link-state changes need no action (round_timing draws from the
    # link model at each round's start time on both engines).
    scn = link_model.compiled_scenario
    cursor = ScenarioCursor(scn) if scn is not None else None
    active = set(range(M))

    def reseed(w, src):
        nonlocal R, Mom
        R, Mom = reseed_row(R, Mom, w, src)

    bsz = [min(cfg.batch_size, len(part_idx[i])) for i in range(M)]
    Bmax = max(bsz)
    mask = np.zeros((M, Bmax), np.float32)
    for i in range(M):
        mask[i, : bsz[i]] = 1.0
    maskd = torch.from_numpy(mask).to(dev)

    # Block batch draw: ``rng.choice(part, size=k)`` is ``part[rng.integers(0,
    # len(part), k)]`` bit-for-bit, and one ``integers`` call fills its output
    # in C order drawing per element exactly as consecutive same-bound calls
    # do — so consecutive workers with equal (population, batch) sizes
    # collapse into one host rng call per round instead of M.
    pops = [len(part_idx[i]) for i in range(M)]
    runs = []
    i0 = 0
    for i in range(1, M + 1):
        if i == M or pops[i] != pops[i0] or bsz[i] != bsz[i0]:
            runs.append((i0, i, pops[i0], bsz[i0]))
            i0 = i
    run_parts = [
        np.stack([np.asarray(part_idx[i]) for i in range(a, b)])
        for a, b, _, _ in runs
    ]

    ex, ey = _sim.to_device(eval_x, dev), _sim.to_device(eval_y, dev)
    dx, dy = _sim.to_device(data_x, dev), _sim.to_device(data_y, dev)

    def eval_now(t, ev):
        with torch.no_grad():
            mean_p = tree_map(lambda l: l.mean(dim=0), R)
        loss, acc = _sim.evaluate(mean_p, ex, ey)
        res.times.append(t)
        res.losses.append(loss)
        res.accs.append(acc)
        res.events.append(ev)

    every = max(1, record_every // M)
    t = 0.0
    r = 0
    while r < rounds:
        if cursor is not None:
            for act in cursor.pop_due(t):
                apply_action(act, active=active, reseed=reseed)
        # ---- draw a block of rounds, ending at the next record boundary,
        # consuming every host rng in reference order ----
        gids, idxs = [], []
        fire = False
        while r < rounds:
            if cursor is not None and cursor.next_time <= t:
                break  # scenario boundary: flush the block before crossing
            groups = algo.select_groups(state, rng)
            timing = _sim.traced_round_timing(
                algo, state, cfg, link_model, groups, t, res
            )
            t += timing.duration
            res.comm_time += timing.comm
            res.compute_time += timing.compute
            gid = np.arange(M, dtype=np.int64)
            for grp in groups:
                if len(grp) >= 2:
                    gid[grp] = min(grp)
            idx = np.zeros((M, Bmax), np.int64)
            for (a, b_, pop, B), parts in zip(runs, run_parts):
                draws = rng.integers(0, pop, size=(b_ - a, B))
                idx[a:b_, :B] = parts[
                    np.arange(b_ - a)[:, None], draws
                ]
            gids.append(gid)
            idxs.append(idx)
            fire = r % every == 0
            r += 1
            if fire:
                break

        if not gids:
            continue  # boundary was immediately due; actions now applied
        # ---- execute the block: one dispatch per block, or per round with
        # fusion off ----
        gid_d = torch.from_numpy(np.stack(gids)).to(dev)
        idx_d = torch.from_numpy(np.stack(idxs)).to(dev)
        for k in range(len(gids)):
            R, Mom = step(R, Mom, dx, dy, maskd, gid_d[k], idx_d[k])
        res.dispatches += 1 if fuse else len(gids)
        res.cohorts += len(gids)

        if fire:
            eval_now(t, r * M)
    eval_now(t, rounds * M)
    res.engine = "batched"
    return res
