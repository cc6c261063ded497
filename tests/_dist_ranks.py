"""Rank-side cases of tests/test_torch_dist.py (torch and numpy only).

``run_rank`` is the target of each spawned process: it joins a gloo group
through a file store, runs every case of its world size in order, and
saves what it holds (its rows of each result, and the host results) for
the test process to hold against the JAX package.  The inputs come from
numpy seeds here and in the test module alike; the simulator's initial
parameters (the JAX ``mlp_init`` output) come from a file the test process
writes before it spawns the ranks.

A case that raises records its traceback and ends the rank's run: the
other ranks' collectives then time out (``TIMEOUT``) and record theirs.
"""

from __future__ import annotations

import datetime
import math
import traceback
from dataclasses import replace

import numpy as np
import torch

#: Gloo's wait for a peer that never comes (a failed rank); under the full
#: suite's load a rank may start tens of seconds after the others.
TIMEOUT = datetime.timedelta(seconds=240)

# ------------------------------------------------------------------ inputs


def pull_tree(M: int, seed: int = 0) -> dict:
    """A stacked tree of M rows as numpy f32: "a" stays f32, "b" is cast to
    bf16 by both packages."""
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((M, 3, 5)).astype(np.float32),
            "b": rng.standard_normal((M, 7)).astype(np.float32)}


def pull_draws(M: int) -> dict:
    """A permutation (each worker pulls its right neighbour) and a draw with
    repeated sources."""
    return {"perm": np.roll(np.arange(M), -1),
            "repeats": np.random.default_rng(M).integers(0, max(M // 2, 1), M)}


#: The trainer's case: qwen1.5-0.5b reduced with vocab 128, as
#: tests/test_spmd.py; M = 4 workers, 2 sequences of 32 tokens a worker
#: (the config's 2 micro-batches), 2 rounds, the clip on.
TRAIN_M = 4
TRAIN_ROUNDS = 2
TRAIN_LR = 0.05
TRAIN_CLIP = 0.5


def train_cfg(get_arch, arch="qwen1.5-0.5b", microbatches=None):
    """The arch's reduced config with vocab 128 (and ``microbatches`` where
    given: a cut of the config's)."""
    cfg = replace(get_arch(arch).reduced(), vocab_size=128)
    return cfg if microbatches is None else replace(cfg, microbatches=microbatches)


def train_inputs(r: int, permutation: bool, M: int = TRAIN_M, rows: int = 2):
    """Round r's batch (numpy int64, (M, rows, 32)) and gossip draw."""
    rng = np.random.default_rng(100 + r)
    batch = {k: rng.integers(0, 128, size=(M, rows, 32)) for k in ("tokens", "labels")}
    if permutation:
        neighbors = rng.permutation(M)
    else:
        neighbors = rng.integers(0, M, M)
    weights = rng.uniform(0.0, 0.5, M).astype(np.float32)
    return batch, {"neighbors": neighbors, "weights": weights, "lr": np.float32(TRAIN_LR)}


#: name -> (strategy, prague groups, gossip mode, permutation draws)
TRAIN_MODES = {
    "netmax-gather": ("netmax", 0, "gather", False),
    "netmax-masked_psum": ("netmax", 0, "masked_psum", False),
    "netmax-ppermute": ("netmax", 0, "ppermute", True),
    "allreduce": ("allreduce", 0, "gather", False),
    "prague": ("prague", 2, "gather", False),
}

#: The simulator's case: tests/test_fleet.py's sharded-engine shape at
#: 120 events, config defaults otherwise; "churn" is
#: tests/test_torch_engines.py's outage and leave/rejoin timeline.
SIM_M = 8


def sim_run(pkg, algo, shard, churn=False, use_mix_kernel=False, **run_kw):
    """One ``simulate`` of ``pkg`` (a dict of the package's data helpers,
    Topology, LinkTimeModel, simulator module and scenario classes);
    ``run_kw`` go to ``simulate``."""
    x, y, ex, ey = pkg["train_eval_split"](1600, 400, 32, 10, seed=0)
    parts = pkg["uniform_partition"](len(y), SIM_M, seed=0)
    if churn:
        topo = pkg["Topology"](n_workers=SIM_M, workers_per_host=2, hosts_per_pod=2,
                               pods_per_cluster=1)
        scenario = pkg["Timeline"]([pkg["ClusterOutage"](1, 1.0, 3.0),
                                    pkg["WorkerLeave"](3, 1.5), pkg["WorkerRejoin"](3, 3.5)])
        link = pkg["LinkTimeModel"](topo, jitter=0.02, seed=5, slow_interval=60.0,
                                    scenario=scenario, dead_link_timeout=2.0)
        kw, events, every = dict(lr=0.05, monitor_period=0.6), 450, 150
    else:
        topo = pkg["Topology"].multi_cluster(SIM_M, workers_per_host=2, hosts_per_pod=1,
                                             pods_per_cluster=2)
        link = pkg["LinkTimeModel"](topo, jitter=0.02, seed=5)
        kw, events, every = {}, 120, 40
    cfg = pkg["sim"].SimConfig(algorithm=algo, n_workers=SIM_M, total_events=events,
                               batch_size=16, seed=0, engine="batched", shard_workers=shard,
                               trace=True, use_mix_kernel=use_mix_kernel, **kw)
    log: list = []
    res = pkg["sim"].simulate(cfg, link, x, y, parts, ex, ey, record_every=every,
                              _cohort_log=log, **run_kw)
    return {"times": res.times, "events": res.events, "losses": res.losses,
            "trace_events": res.trace_events, "cohorts": res.cohorts,
            "dispatches": res.dispatches, "cohort_log": log,
            "policy_log": [(t, r, P.tolist()) for t, r, P in res.policy_log],
            "failed_pulls": res.failed_pulls}


#: name -> (strategy, churn, use_mix_kernel); every world runs all three.
#: (The JAX package's sharded step ignores use_mix_kernel; the port's mixes
#: through ``ops.gossip_mix_tree`` under it, the plain version on the CPU.)
SIM_CASES = {"adpsgd": ("adpsgd", False, False),
             "netmax": ("netmax", False, True),
             "netmax-churn": ("netmax", True, False)}


def sim_pkg(data, nettime, scenarios, simulator) -> dict:
    """The names ``sim_run`` takes from a package's modules."""
    return dict(train_eval_split=data[0].train_eval_split,
                uniform_partition=data[1].uniform_partition,
                Topology=nettime.Topology, LinkTimeModel=nettime.LinkTimeModel,
                sim=simulator, Timeline=scenarios.Timeline,
                ClusterOutage=scenarios.ClusterOutage, WorkerLeave=scenarios.WorkerLeave,
                WorkerRejoin=scenarios.WorkerRejoin)


def torch_pkg() -> dict:
    from repro_torch import scenarios
    from repro_torch.core import nettime
    from repro_torch.data import partition, synthetic
    from repro_torch.train import simulator

    return sim_pkg((synthetic, partition), nettime, scenarios, simulator)


# ------------------------------------------------------------------ cases


def _local(tree):
    return {k: v.clone() for k, v in tree.items()}


def case_pulls(world, mesh_shape, worker_axes, M):
    """All three pulls of a pull_tree(M) on a mesh: this rank's rows."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.dist import gossip
    from repro_torch.dist.sharding import worker_rows

    mesh = init_device_mesh("cpu", tuple(mesh_shape.values()),
                            mesh_dim_names=tuple(mesh_shape))
    rows = worker_rows(mesh, worker_axes, M)
    full = pull_tree(M)
    local = {"a": torch.from_numpy(full["a"][rows.start:rows.stop]),
             "b": torch.from_numpy(full["b"][rows.start:rows.stop]).to(torch.bfloat16)}
    out = {"rows": (rows.start, rows.stop)}
    n_blocks = M // len(rows)
    for name, nb in pull_draws(M).items():
        out[name] = {
            "gather": _local(gossip.pull_gather(local, nb, mesh, worker_axes)),
            "masked_psum": _local(gossip.pull_masked_psum(local, nb, M, mesh, worker_axes)),
        }
        if n_blocks == M:  # one row a block: the draw is a draw of blocks
            out[name]["ppermute"] = _local(gossip.pull_ppermute(local, nb, mesh, worker_axes))
    return out


def case_jax_ppermute():
    """The JAX package's test_spmd pull: make_debug_mesh(4, 2), perm
    (1, 2, 3, 0), on its tree of rng(0) normals."""
    from repro_torch.dist import gossip
    from repro_torch.dist.sharding import worker_rows
    from repro_torch.launch.mesh import make_debug_mesh

    mesh = make_debug_mesh(4, 2, device_type="cpu")
    rng = np.random.default_rng(0)
    full = {"w": rng.normal(size=(4, 16, 8)).astype(np.float32),
            "b": rng.normal(size=(4, 8)).astype(np.float32)}
    rows = worker_rows(mesh, ("data",), 4)
    local = {k: torch.from_numpy(v[rows.start:rows.stop]) for k, v in full.items()}
    return {"rows": (rows.start, rows.stop),
            "pulled": _local(gossip.pull_ppermute(local, (1, 2, 3, 0), mesh, ("data",)))}


def case_layout():
    """The (pod, data, model) = (2, 2, 2) mesh: this rank's rows of 8 for
    worker axes ("pod", "data") from the built mesh and from the planned
    one, the worker group's ranks, and a DTensor built from the rows."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    from repro_torch.dist.sharding import P, placements, worker_rows, worker_shard

    shape = {"pod": 2, "data": 2, "model": 2}
    axes = ("pod", "data")
    mesh = init_device_mesh("cpu", (2, 2, 2), mesh_dim_names=tuple(shape))
    rows = worker_rows(mesh, axes, 8)
    shard = worker_shard(mesh, axes, 8)
    full = torch.arange(24.0).reshape(8, 3)
    dt = DTensor.from_local(full[rows.start:rows.stop].clone(), mesh,
                            placements(P(axes, None), mesh))
    return {"rows": (rows.start, rows.stop),
            "planned_rows": worker_rows(shape, axes, 8, rank=dist.get_rank()),
            "group_ranks": dist.get_process_group_ranks(shard.group),
            "shard_ranks": shard.ranks,
            "dtensor_full": bool(torch.equal(dt.full_tensor(), full))}


def case_train(mode, mesh_shape):
    """TRAIN_ROUNDS of the port's sharded make_train_step on a (data,
    model) mesh: this rank's rows of the params, the losses, and whether
    init_stacked gave it its rows of the unsharded init."""
    from repro_torch.algos import get_algorithm
    from repro_torch.configs.base import get_arch
    from repro_torch.dist.sharding import worker_rows
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.optim import sgd
    from repro_torch.train.trainer import TrainStepConfig, init_stacked, make_train_step
    from repro_torch.tree import tree_leaves, tree_map

    algo, groups, gossip_mode, permutation = TRAIN_MODES[mode]
    cfg, opt, M = train_cfg(get_arch), sgd(momentum=0.9), TRAIN_M
    mesh = make_debug_mesh(*mesh_shape, device_type="cpu")
    axes = ("data",)
    params, opt_state = init_stacked(cfg, opt, M, device="cpu", mesh=mesh, worker_axes=axes)
    rows = worker_rows(mesh, axes, M)
    whole, _ = init_stacked(cfg, opt, M, device="cpu")
    init_ok = all(torch.equal(a, b[rows.start:rows.stop])
                  for a, b in zip(tree_leaves(params), tree_leaves(whole)))
    strategy = get_algorithm(algo, trainer_groups=groups) if groups else algo
    step = make_train_step(cfg, opt, M, strategy,
                           TrainStepConfig(gossip_mode=gossip_mode, grad_clip=TRAIN_CLIP),
                           mesh=mesh, worker_axes=axes)
    losses = []
    for r in range(TRAIN_ROUNDS):
        batch, gossip_in = train_inputs(r, permutation)
        local = {k: torch.from_numpy(v[rows.start:rows.stop]) for k, v in batch.items()}
        params, opt_state, m = step(params, opt_state, local, gossip_in)
        losses.append((m["loss_per_worker"].numpy().copy(), float(m["loss"])))
    return {"rows": (rows.start, rows.stop), "init_ok": init_ok, "losses": losses,
            "params": tree_map(lambda t: t.clone(), params)}


#: Tensor-parallel training cases: name -> (TRAIN_MODES key, M, arch,
#: (data, model) mesh of 4 ranks, worker axes, rows a worker, micro-batches
#: (None: the config's)).  On (1, 4), tinyllama's 4 query heads split 4
#: ways over 2 KV heads: each rank slices its KV head.  "train-tp-moe-rows"
#: is phi3.5-moe's plan on one pod: the one worker enumerates 'pod' alone,
#: so 'data' holds neither a worker nor a split, and each micro-batch's 2
#: rows are shared out over it (ROADMAP C22); 16 rows are the config's 8
#: micro-batches of 2.  "train-tp-moe-rows-data" is the same plan on (4, 1):
#: no leaf is split, and each micro-batch's 4 rows are shared out over 4
#: 'data' ranks.  "train-tp-jamba-rows" is jamba's plan on (2, 2), its
#: mamba layers and experts in Megatron's layout (ROADMAP C23), cut to 2
#: micro-batches of 4 rows, 2 a 'data' rank so that ``w_in`` is regrouped
#: (the config's 8 micro-batches cost ~105 s of mamba steps on DTensors).
TP_TRAIN = {"train-tp-netmax-gather": ("netmax-gather", 4, "qwen1.5-0.5b", (2, 2), ("data",), 2,
                                       None),
            "train-tp-netmax-ppermute": ("netmax-ppermute", 2, "qwen1.5-0.5b", (2, 2), ("data",),
                                         2, None),
            "train-tp-rwkv-gather": ("netmax-gather", 2, "rwkv6-7b", (2, 2), ("data",), 2, None),
            "train-tp-gqa-slice": ("netmax-gather", 1, "tinyllama-1.1b", (1, 4), ("data",), 2,
                                   None),
            "train-tp-moe-rows": ("netmax-gather", 1, "phi3.5-moe-42b-a6.6b", (2, 2), ("pod",),
                                  16, None),
            "train-tp-moe-rows-data": ("netmax-gather", 1, "phi3.5-moe-42b-a6.6b", (4, 1),
                                       ("pod",), 32, None),
            "train-tp-jamba-rows": ("netmax-gather", 1, "jamba-v0.1-52b", (2, 2), ("pod",), 8, 2)}
#: Tensor-parallel prefill cases: name -> arch.
TP_PREFILL = {"prefill-tp": "qwen1.5-0.5b", "prefill-tp-rwkv": "rwkv6-7b",
              "prefill-tp-jamba": "jamba-v0.1-52b"}
#: The tensor-parallel prefill's batch: (4, 32) token ids.
TP_PREFILL_SEED = 7


def tp_prefill_tokens():
    return np.random.default_rng(TP_PREFILL_SEED).integers(0, 128, size=(4, 32))


#: Tensor-parallel decode cases: name -> arch.  On (1, 4), reduced
#: tinyllama's 4 query heads split 4 ways over its 2 KV heads: each rank
#: slices its head's KV head from the replicated cache (ROADMAP C17).
#: Reduced jamba's attention layers do the same, and its mamba layers step
#: on their whole states (ROADMAP C23).
TP_DECODE = {"decode-tp": "tinyllama-1.1b", "decode-tp-jamba": "jamba-v0.1-52b"}
#: The decode step follows a prefill of TP_DECODE_PREFILL tokens into a
#: cache of TP_DECODE_SEQ positions, a batch of 4.
TP_DECODE_PREFILL, TP_DECODE_SEQ = 8, 16


def tp_decode_inputs():
    """The prefill's token ids (4, TP_DECODE_PREFILL) and the decoded
    token ids (4,), numpy int64."""
    rng = np.random.default_rng(TP_PREFILL_SEED + 1)
    return rng.integers(0, 128, size=(4, TP_DECODE_PREFILL)), rng.integers(0, 128, size=4)


def tp_decode_cache(cfg, params):
    """The port's cache after the prefill (plain tensors on the CPU)."""
    from repro_torch.serve.engine import capture_prefill

    tokens, _ = tp_decode_inputs()
    return capture_prefill(cfg, params, torch.from_numpy(tokens), TP_DECODE_SEQ)[1]


def case_train_tp(name):
    """TRAIN_ROUNDS of make_train_step with the plan's specs on a (data,
    model) mesh of 4 ranks: each leaf split on 'model' where its trailing dim
    divides.  This rank's shards of the params, their slices of the whole
    stacked leaves, the losses, and the ranks a micro-batch's rows were
    shared out over (1 where the worker axes leave no mesh dim free)."""
    from repro_torch.configs.base import get_arch
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.mesh import make_debug_mesh, mesh_shape
    from repro_torch.optim import sgd
    from repro_torch.train.trainer import (TrainStepConfig, abstract_stacked, init_stacked,
                                           make_train_step)
    from repro_torch.tree import tree_leaves, tree_map

    mode, M, arch, sizes, axes, n_rows, micro = TP_TRAIN[name]
    algo, _, gossip_mode, permutation = TRAIN_MODES[mode]
    cfg, opt = train_cfg(get_arch, arch, micro), sgd(momentum=0.9)
    mesh = make_debug_mesh(*sizes, device_type="cpu")
    specs = shd.param_specs(cfg, abstract_stacked(cfg, opt, M)[0], shd.plan_for(cfg, mesh))
    params, opt_state = init_stacked(cfg, opt, M, device="cpu", mesh=mesh, worker_axes=axes,
                                     param_specs=specs)
    rows = shd.worker_rows(mesh, axes, M)
    split = sum(any(e is not None for e in tuple(sp)[1:]) for sp in tree_leaves(specs))
    step = make_train_step(cfg, opt, M, algo,
                           TrainStepConfig(gossip_mode=gossip_mode, grad_clip=TRAIN_CLIP),
                           mesh=mesh, worker_axes=axes, param_specs=specs)
    losses = []
    for r in range(TRAIN_ROUNDS):
        batch, gossip_in = train_inputs(r, permutation, M, n_rows)
        local = {k: torch.from_numpy(v[rows.start:rows.stop]) for k, v in batch.items()}
        params, opt_state, m = step(params, opt_state, local, gossip_in)
        losses.append((m["loss_per_worker"].numpy().copy(), float(m["loss"])))
    whole = abstract_stacked(cfg, opt, M)[0]
    slices = [[(sl.start, sl.stop) for sl in shd.local_slices(a.shape, spec, mesh)]
              for a, spec in zip(tree_leaves(whole), tree_leaves(specs))]
    return {"losses": losses, "slices": slices, "split_leaves": split,
            "row_ranks": math.prod(mesh_shape(mesh)[a] for a in step.row_layout()[0]),
            "params": tree_map(lambda t: t.clone(), params)}


def case_prefill_tp(name):
    """``lm.prefill_logits`` on DTensors over the (2, 2) mesh with the
    serving plan's specs (params split on 'model', the batch on 'data'):
    the whole logits."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs.base import get_arch
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import lm

    cfg = train_cfg(get_arch, TP_PREFILL[name])
    mesh = make_debug_mesh(2, 2, device_type="cpu")
    plan = shd.plan_for(cfg, mesh, serve=True)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0))
    pspecs = shd.param_specs(cfg, params, plan, stacked=False)
    batch = {"tokens": torch.from_numpy(tp_prefill_tokens()).to(torch.int32)}
    bspecs = shd.prefill_batch_specs(cfg, plan, batch)
    dparams = shd.distribute(shd.local_part(params, pspecs, mesh), pspecs, mesh)
    dbatch = shd.distribute(shd.local_part(batch, bspecs, mesh), bspecs, mesh)
    with torch.no_grad(), implicit_replication():
        out = lm.prefill_logits(dparams, dbatch, cfg)
    return {"logits": out.full_tensor().clone(), "placements": [str(p) for p in out.placements]}


def case_decode_tp(name):
    """``lm.decode_step`` at position TP_DECODE_PREFILL on DTensors over a
    (1, 4) mesh with the serving plan's specs, from the prefill's params and
    cache: the whole logits, the whole cache after the step, and the layers
    whose attention ran split over 'model'."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs.base import get_arch
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import attention, lm
    from repro_torch.tree import tree_map

    cfg = train_cfg(get_arch, TP_DECODE[name])
    mesh = make_debug_mesh(1, 4, device_type="cpu")
    plan = shd.plan_for(cfg, mesh, serve=True)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0))
    cache = tp_decode_cache(cfg, params)
    token = torch.from_numpy(tp_decode_inputs()[1]).to(torch.int32)
    specs = (shd.param_specs(cfg, params, plan, stacked=False),
             shd.cache_specs(cfg, cache, plan, token.shape[0]),
             shd.serve_batch_spec(plan, token.shape[0]))
    dparams, dcache, dtoken = (shd.distribute(shd.local_part(tree, spec, mesh), spec, mesh)
                               for tree, spec in zip((params, cache, token), specs))
    local, split = attention._decode_attention_local, [0]

    def counted(*args):
        out = local(*args)
        split[0] += out is not None
        return out

    attention._decode_attention_local = counted
    try:
        with torch.no_grad(), implicit_replication():
            logits, dcache = lm.decode_step(dparams, dcache, dtoken, TP_DECODE_PREFILL, cfg)
    finally:
        attention._decode_attention_local = local
    return {"logits": logits.full_tensor().clone(), "split_layers": split[0],
            "cache": tree_map(lambda t: t.full_tensor().clone(), dcache)}


def case_sim(name, init):
    """The sharded engine's run, and how many cohorts it pulled point to
    point (only where every worker has a rank of its own)."""
    from repro_torch.dist import gossip

    algo, churn, mix = SIM_CASES[name]
    ppermute, calls = gossip.pull_ppermute, [0]

    def counted(*args, **kwargs):
        calls[0] += 1
        return ppermute(*args, **kwargs)

    gossip.pull_ppermute = counted
    try:
        out = sim_run(torch_pkg(), algo, True, churn=churn, use_mix_kernel=mix,
                      init_params=init, device="cpu")
    finally:
        gossip.pull_ppermute = ppermute
    return {**out, "ppermute_calls": calls[0]}


def case_refusals():
    """What the sharded engine refuses in a group: M not divisible by the
    world size, and a strategy outside the gossip family."""
    from repro_torch.core.nettime import LinkTimeModel, Topology
    from repro_torch.data.partition import uniform_partition
    from repro_torch.data.synthetic import train_eval_split
    from repro_torch.train.simulator import SimConfig, simulate

    out = {}
    x, y, ex, ey = train_eval_split(400, 100, 32, 10, seed=0)
    for name, algo, M in (("indivisible", "netmax", 3), ("ps-async", "ps-async", 4)):
        parts = uniform_partition(len(y), M, seed=0)
        link = LinkTimeModel(Topology(n_workers=M, workers_per_host=M, hosts_per_pod=1), seed=5)
        cfg = SimConfig(algorithm=algo, n_workers=M, total_events=20, seed=0,
                        engine="batched", shard_workers=True)
        try:
            simulate(cfg, link, x, y, parts, ex, ey, record_every=20, device="cpu")
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def cases(world: int, init) -> list:
    """(name, thunk) for every case of a world size, in the order every
    rank runs them."""
    out = [
        ("pulls-M=world", lambda: case_pulls(world, {"data": world}, ("data",), world)),
        ("pulls-M=2world", lambda: case_pulls(world, {"data": world}, ("data",), 2 * world)),
    ]
    out += [(f"sim-{name}", lambda name=name: case_sim(name, init)) for name in SIM_CASES]
    if world == 2:
        out += [(f"train-{m}", lambda m=m: case_train(m, (2, 1)))
                for m in ("netmax-gather", "netmax-masked_psum", "allreduce", "prague")]
        out.append(("refusals", case_refusals))
    if world == 4:
        out += [(f"train-{m}", lambda m=m: case_train(m, (4, 1)))
                for m in ("netmax-ppermute", "prague")]
        out += [(name, lambda name=name: case_train_tp(name)) for name in TP_TRAIN]
        out += [(name, lambda name=name: case_prefill_tp(name)) for name in TP_PREFILL]
        out += [(name, lambda name=name: case_decode_tp(name)) for name in TP_DECODE]
    if world == 8:
        out += [("jax-ppermute", case_jax_ppermute), ("layout", case_layout),
                ("pulls-pod-data", lambda: case_pulls(
                    world, {"pod": 2, "data": 2, "model": 2}, ("pod", "data"), 4)),
                ("train-netmax-gather-tp2", lambda: case_train("netmax-gather", (4, 2)))]
    return out


def run_rank(rank: int, world: int, tmp: str) -> None:
    """The spawned process: one rank of a gloo group of ``world``."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    init = torch.load(f"{tmp}/sim_init.pt")
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store-{world}", rank=rank,
                            world_size=world, timeout=TIMEOUT)
    out = {}
    try:
        for name, thunk in cases(world, init):
            try:
                out[name] = thunk()
            except Exception:  # noqa: BLE001 -- reported to the test process
                out[name] = {"error": traceback.format_exc()}
                break
    finally:
        torch.save(out, f"{tmp}/rank-{world}-{rank}.pt")
        dist.destroy_process_group()


# ------------------------------------------------- the embedding lookup (C19)

#: tests/test_torch_flash_f32_tc.py's lookup: a (VOCAB, D) table and (B, S)
#: ids from numpy seeds, on a (2, 2) ('data', 'model') mesh.
EMBED_VOCAB, EMBED_D, EMBED_B, EMBED_S = 32, 8, 4, 3


def embed_inputs():
    """The table (f32), the ids (int64) and a weight of the output's shape
    for the gradient, from numpy seeds."""
    rng = np.random.default_rng(19)
    table = rng.standard_normal((EMBED_VOCAB, EMBED_D)).astype(np.float32)
    ids = rng.integers(0, EMBED_VOCAB, size=(EMBED_B, EMBED_S))
    weight = rng.standard_normal((EMBED_B, EMBED_S, EMBED_D)).astype(np.float32)
    return table, ids, weight


def run_embedding_rank(rank: int, tmp: str) -> None:
    """One rank of a gloo group of 4 on a (2, 2) mesh: ``embedding_lookup``
    on DTensors, the ids split on 'data' and the table's D on 'model' (the
    serving plan's layout), then the table split on its vocab instead; each
    lookup's local and whole output, and the whole gradient of
    ``sum(out * weight)`` into the table."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import modules

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store-embed", rank=rank,
                            world_size=4, timeout=TIMEOUT)
    out = {}
    try:
        mesh = make_debug_mesh(2, 2, device_type="cpu")
        table, ids, weight = (torch.from_numpy(a) for a in embed_inputs())
        dids = DTensor.from_local(ids.chunk(2, 0)[mesh.get_local_rank(0)].contiguous(), mesh,
                                  [Shard(0), Replicate()], run_check=False)
        for name, placement in (("d_split", Shard(1)), ("vocab_split", Shard(0))):
            local = table.chunk(2, placement.dim)[mesh.get_local_rank(1)].contiguous()
            dtable = DTensor.from_local(local.requires_grad_(), mesh, [Replicate(), placement],
                                        run_check=False)
            y = modules.embedding_lookup({"table": dtable}, dids)
            (y.full_tensor() * weight).sum().backward()
            out[name] = {"local": y.to_local().detach().clone(),
                         "full": y.full_tensor().detach().clone(),
                         "placements": [(type(p).__name__, getattr(p, "dim", None))
                                        for p in y.placements],
                         "grad": local.grad.clone()}
    except Exception:  # noqa: BLE001 -- reported to the test process
        out["error"] = traceback.format_exc()
    finally:
        torch.save(out, f"{tmp}/embed-{rank}.pt")
        dist.destroy_process_group()
