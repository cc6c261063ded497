"""The port's multi-rank layer against the JAX package, on the CPU.

``launch/mesh.py``, ``dist/sharding.py``, the cross-rank pulls, the sharded
``make_train_step`` and ``SimConfig.shard_workers`` run in gloo groups of
2, 4 and 8 ranks, spawned once each for the module (``_dist_ranks.py``
holds what a rank runs) while this process computes the JAX side.  The
JAX package's own sharded code runs in one subprocess with 8 forced host
devices, as tests/test_fleet.py runs it.  Held to it:

* specs: ``param_specs``, ``batch_specs``, ``prefill_batch_specs``,
  ``cache_specs`` and ``serve_batch_spec`` equal the JAX package's entry by
  entry, for every arch on three planned meshes (no devices);
* pulls: gather, masked psum and point-to-point, on a bf16 + f32 tree, for
  a permutation and a draw with repeated sources, bit-equal to JAX's
  unsharded ``pull_gather``; ``pull_ppermute`` on ``make_debug_mesh(4, 2)``
  bit-equal to JAX's; the row map equal to ``NamedSharding``'s on a
  (pod, data, model) mesh;
* the sharded engine: host results (times, events, the trace stream,
  cohorts, dispatches, the cohort log, published policies, failed pulls)
  equal to JAX's sharded runs at every world size, losses within 5e-4
  (tests/test_fleet.py's tolerance: two frameworks sum f32 matmuls in
  different orders);
* the sharded trainer against JAX's unsharded ``make_train_step`` (its
  sharded step cannot run under this jax, ROADMAP C4): losses within 1e-4,
  params within 1e-4 x max |param| (tests/test_torch_trainer.py's);
* tensor parallelism on 2 workers x 2 'model' ranks: ``make_train_step``
  with the plan's 'model'-split specs (gather and ppermute pulls), each
  rank's shards against the same slices of JAX's unsharded step, to that
  tolerance; ``prefill_logits`` on DTensors against JAX's within 1e-4;
  ``decode_step`` on 1 x 4 'model' ranks, the cache attention split over
  them (ROADMAP C17), its logits and the cache it wrote against JAX's
  within 1e-4.
"""

import functools
import os
import pickle
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _dist_ranks as dr
from repro.algos import get_algorithm as jalgo
from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import get_arch as jget
from repro.configs.base import all_archs
from repro.dist import gossip as jgossip
from repro.dist import sharding as jshd
from repro.launch import specs as jspecs
from repro.optim import optimizers as jopt
from repro.train import simulator as jsim
from repro.train import trainer as jtr
from repro_torch.configs.base import SHAPES as TSHAPES
from repro_torch.configs.base import get_arch as tget
from repro_torch.convert import params_from_jax
from repro_torch.dist import gossip as tgossip
from repro_torch.dist import sharding as tshd
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import specs as tspecs
from repro_torch.launch import train as tlaunch
from repro_torch.optim import optimizers as topt
from repro_torch.train import trainer as ttr
from repro_torch.tree import tree_leaves

ROOT = Path(__file__).resolve().parents[1]
WORLDS = (2, 4, 8)
JOIN_S = 300
LOSS_TOL = 5e-4
TRAIN_TOL = 1e-4

_JAX_SCRIPT = textwrap.dedent("""
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    import _dist_ranks as dr
    from repro import scenarios
    from repro.core import nettime
    from repro.data import partition, synthetic
    from repro.dist import gossip
    from repro.launch.mesh import make_debug_mesh
    from repro.train import simulator

    out = {"devices": len(jax.devices())}
    mesh = make_debug_mesh(4, 2)
    rng = np.random.default_rng(0)
    tree = {"w": rng.normal(size=(4, 16, 8)).astype(np.float32),
            "b": rng.normal(size=(4, 8)).astype(np.float32)}
    sh = lambda x: NamedSharding(mesh, P(("data",), *([None] * (x.ndim - 1))))
    jt = {k: jax.device_put(jnp.asarray(v), sh(v)) for k, v in tree.items()}
    pulled = gossip.pull_ppermute(jt, (1, 2, 3, 0), mesh, ("data",))
    out["ppermute"] = {k: np.asarray(v) for k, v in pulled.items()}

    m3 = jax.make_mesh((2, 2, 2), ("pod", "data", "model"))
    where = {d.id: tuple(int(c) for c in np.argwhere(m3.devices == d)[0])
             for d in m3.devices.flat}
    index = NamedSharding(m3, P(("pod", "data"), None)).devices_indices_map((8, 3))
    out["layout"] = {where[d.id]: (s[0].start, s[0].stop) for d, s in index.items()}

    pkg = dr.sim_pkg((synthetic, partition), nettime, scenarios, simulator)
    out["sim"] = {name: dr.sim_run(pkg, algo, True, churn=churn, use_mix_kernel=mix)
                  for name, (algo, churn, mix) in dr.SIM_CASES.items()}
    with open(sys.argv[1], "wb") as f:
        pickle.dump(out, f)
""")


class Cluster:
    """The spawned gloo groups and the JAX subprocess, joined on first use."""

    def __init__(self, tmp: Path):
        self.tmp = tmp
        p0 = jsim.mlp_init(jax.random.PRNGKey(0), [32, 128, 64, 10])
        torch.save(params_from_jax(p0), tmp / "sim_init.pt")
        env = dict(os.environ)
        env.pop("XLA_FLAGS", None)
        env["PYTHONPATH"] = os.pathsep.join(
            [str(ROOT / "src"), str(ROOT / "tests"), env.get("PYTHONPATH", "")])
        self.jax_proc = subprocess.Popen(
            [sys.executable, "-c", _JAX_SCRIPT, str(tmp / "jax.pkl")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)
        ctx = torch.multiprocessing.get_context("spawn")
        self.procs = {w: [ctx.Process(target=dr.run_rank, args=(r, w, str(tmp)))
                          for r in range(w)] for w in WORLDS}
        for procs in self.procs.values():
            for p in procs:
                p.start()
        self._ranks, self._jax = {}, None

    def ranks(self, world: int) -> list:
        """Every rank's saved results for a world size."""
        if world not in self._ranks:
            for p in self.procs[world]:
                p.join(JOIN_S)
            alive = [r for r, p in enumerate(self.procs[world]) if p.is_alive()]
            for p in self.procs[world]:
                p.terminate()
            assert not alive, f"world {world}: ranks {alive} still running after {JOIN_S} s"
            self._ranks[world] = [torch.load(self.tmp / f"rank-{world}-{r}.pt",
                                             weights_only=False) for r in range(world)]
        return self._ranks[world]

    def case(self, world: int, name: str) -> list:
        """One case's results, rank by rank; a rank's traceback fails here."""
        out = []
        for r, res in enumerate(self.ranks(world)):
            assert name in res, f"world {world} rank {r} did not reach {name}: {res.keys()}"
            got = res[name]
            assert not (isinstance(got, dict) and "error" in got), got.get("error")
            out.append(got)
        return out

    def jax(self) -> dict:
        if self._jax is None:
            _, err = self.jax_proc.communicate(timeout=JOIN_S)
            assert self.jax_proc.returncode == 0, err[-3000:]
            with open(self.tmp / "jax.pkl", "rb") as f:
                self._jax = pickle.load(f)
            assert self._jax["devices"] == 8
        return self._jax

    def close(self):
        for procs in self.procs.values():
            for p in procs:
                p.join(JOIN_S if p.is_alive() else 0)
                p.terminate()
        if self.jax_proc.poll() is None:
            self.jax_proc.kill()
            self.jax_proc.communicate()


@pytest.fixture(scope="module", autouse=True)
def cluster(tmp_path_factory):
    """Spawn every group and the JAX subprocess before the first test, so
    they run while this process computes the JAX side."""
    c = Cluster(tmp_path_factory.mktemp("dist"))
    yield c
    c.close()


# ------------------------------------------------------------------ helpers


def _bits(a):
    """An array's bits: bf16 (torch or ml_dtypes) as uint16."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


# ------------------------------------------------------------------ (a) specs

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "4x2": {"data": 4, "model": 2}}


def _jax_specs(specs):
    P = jax.sharding.PartitionSpec
    return [tuple(s) for s in jax.tree_util.tree_leaves(specs, is_leaf=lambda x: isinstance(x, P))]


def _torch_specs(specs):
    return [tuple(s) for s in tree_leaves(specs)]


PACKAGES = {"jax": (jshd, jspecs, jget, JSHAPES, jopt.sgd(momentum=0.9)),
            "torch": (tshd, tspecs, tget, TSHAPES, topt.sgd(momentum=0.9))}


@functools.lru_cache(maxsize=None)
def _inputs(pkg, name, shape, n):
    """A package's input specs for one arch and shape (the serving ones are
    the same on every mesh)."""
    _, specs_mod, get_arch, _, sgd = PACKAGES[pkg]
    return specs_mod.input_specs(get_arch(name), shape, n, sgd)


def _all_specs(pkg, name, mesh, kind):
    """Every spec a package's sharding module gives for one arch on a
    planned mesh (a stand-in with a ``{name: size}`` shape)."""
    shd, _, get_arch, shapes, _ = PACKAGES[pkg]
    cfg = get_arch(name)
    stand_in = types.SimpleNamespace(shape=dict(mesh))
    if kind == "stacked":
        plan = shd.plan_for(cfg, stand_in)
        inputs = _inputs(pkg, name, "train_4k", plan.n_workers)
        return {"n_workers": plan.n_workers, "worker_axes": plan.worker_axes,
                "params": shd.param_specs(cfg, inputs["params"], plan, stacked=True),
                "batch": shd.batch_specs(cfg, plan, shapes["train_4k"], stacked=True)}
    plan = shd.plan_for(cfg, stand_in, serve=True)
    pre = _inputs(pkg, name, "prefill_32k", 1)
    dec = _inputs(pkg, name, "decode_32k", 1)
    B = shapes["decode_32k"].global_batch
    return {"params": shd.param_specs(cfg, pre["params"], plan, stacked=False),
            "prefill": shd.prefill_batch_specs(cfg, plan, pre["batch"]),
            "cache": shd.cache_specs(cfg, dec["cache"], plan, B),
            "serve": [shd.serve_batch_spec(plan, B),
                      shd.serve_batch_spec(plan, shapes["prefill_32k"].global_batch)]}


@pytest.mark.parametrize("kind", ["stacked", "serve"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", sorted(all_archs()))
def test_sharding_specs_match_jax(name, mesh, kind):
    want = _all_specs("jax", name, MESHES[mesh], kind)
    got = _all_specs("torch", name, MESHES[mesh], kind)
    assert got.keys() == want.keys()
    for key in want:
        if key in ("n_workers", "worker_axes"):
            assert got[key] == want[key], key
        else:
            w, g = _jax_specs(want[key]), _torch_specs(got[key])
            assert len(g) == len(w) and g == w, (key, [(a, b) for a, b in zip(g, w) if a != b][:3])
    if kind == "stacked" and MESHES[mesh]["model"] > 1:
        # The plan really splits trailing dims on 'model' (what the trainer
        # refuses, ROADMAP A7).
        assert any("model" in s for s in _torch_specs(got["params"]))


def test_mesh_helpers_read_plans_and_device_meshes():
    """``mesh_shape`` reads a mapping, a ``.shape`` mapping, and a
    DeviceMesh's tuple shape beside its dim names."""
    planned = {"pod": 2, "data": 16, "model": 16}
    device_mesh = types.SimpleNamespace(shape=(2, 16, 16), mesh_dim_names=tuple(planned))
    for m in (planned, types.SimpleNamespace(shape=planned), device_mesh):
        assert tmesh.mesh_shape(m) == planned
        assert tmesh.worker_count(m, ("pod", "data")) == 32
        assert tmesh.worker_axis_names(m, ("pod", "data")) == ("pod", "data")
    single = {"data": 16, "model": 16}
    assert tmesh.worker_axis_names(single, ("pod", "data")) == ("data",)
    assert tmesh.worker_count(single, ("pod", "data")) == 16
    with pytest.raises(ValueError, match="process group"):
        tmesh.make_debug_mesh(2, 1, device_type="cpu")
    with pytest.raises(ValueError, match="process group"):
        tmesh.make_production_mesh(device_type="cpu")


# ------------------------------------------------------------------ (b) pulls


def _want_pull(M, draw):
    full = dr.pull_tree(M)
    tree = {"a": jnp.asarray(full["a"]), "b": jnp.asarray(full["b"]).astype(jnp.bfloat16)}
    return jgossip.pull_gather(tree, jnp.asarray(dr.pull_draws(M)[draw], jnp.int32))


def _check_pulls(results, M, draw, modes):
    want = _want_pull(M, draw)
    for r, res in enumerate(results):
        lo, hi = res["rows"]
        assert set(res[draw]) == set(modes), (r, res[draw].keys())
        for mode, got in res[draw].items():
            assert got["b"].dtype == torch.bfloat16 and got["a"].dtype == torch.float32
            for k in ("a", "b"):
                assert np.array_equal(_bits(got[k]), _bits(want[k])[lo:hi]), (r, mode, k)


@pytest.mark.parametrize("draw", ["perm", "repeats"])
@pytest.mark.parametrize("rows", ["M=world", "M=2world"])
@pytest.mark.parametrize("world", WORLDS)
def test_pulls_bit_equal_to_jax_gather(cluster, world, rows, draw):
    """Each rank's rows of every pull equal JAX's unsharded gather; the
    point-to-point pull where a block is one row."""
    M = world if rows == "M=world" else 2 * world
    modes = {"gather", "masked_psum"} | ({"ppermute"} if rows == "M=world" else set())
    _check_pulls(cluster.case(world, f"pulls-{rows}"), M, draw, modes)


@pytest.mark.parametrize("draw", ["perm", "repeats"])
def test_pulls_over_flattened_worker_dims(cluster, draw):
    """Worker axes ("pod", "data") of a (2, 2, 2) mesh: each model slice
    pulls within its own flattened worker group."""
    _check_pulls(cluster.case(8, "pulls-pod-data"), 4, draw,
                 {"gather", "masked_psum", "ppermute"})


def test_pulls_without_a_mesh_are_unchanged():
    """No mesh, or a mesh with no worker axis: every rank holds all rows,
    and pull_ppermute is pull_gather (JAX :61-62)."""
    full = dr.pull_tree(4)
    tree = {"a": torch.from_numpy(full["a"]), "b": torch.from_numpy(full["b"])}
    nb = (1, 2, 3, 0)
    want = tgossip.pull_gather(tree, nb)
    for got in (tgossip.pull_ppermute(tree, nb, None, ("data",)),
                tgossip.pull_ppermute(tree, nb, {"model": 2}, ("data",)),
                tgossip.pull_masked_psum(tree, nb, 4)):
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got), tree_leaves(want)))


# ------------------------------------------------------------------ (c) JAX's sharded code


def test_ppermute_matches_jax_sharded_pull(cluster):
    """JAX's pull_ppermute on make_debug_mesh(4, 2), perm (1, 2, 3, 0),
    against the port's at world 8: each model slice's ranks get their rows
    bit for bit."""
    want = cluster.jax()["ppermute"]
    for r, res in enumerate(cluster.case(8, "jax-ppermute")):
        lo, hi = res["rows"]
        for k, v in want.items():
            assert np.array_equal(_bits(res["pulled"][k]), v[lo:hi]), (r, k)


def test_row_map_matches_named_sharding(cluster):
    """The rows a rank holds for worker axes ("pod", "data") on a (2, 2, 2)
    mesh, planned and built, are NamedSharding's; the worker group lists
    its ranks in worker order, and DTensor's placements reassemble them."""
    layout = cluster.jax()["layout"]
    grid = np.arange(8).reshape(2, 2, 2)
    shape = {"pod": 2, "data": 2, "model": 2}
    for coords, want in layout.items():
        got = tshd.worker_rows(shape, ("pod", "data"), 8, rank=int(grid[coords]))
        assert (got.start, got.stop) == want, coords
    for r, res in enumerate(cluster.case(8, "layout")):
        assert res["rows"] == (res["planned_rows"].start, res["planned_rows"].stop)
        assert res["rows"] == layout[tuple(int(c) for c in np.argwhere(grid == r)[0])]
        assert tuple(res["group_ranks"]) == tuple(res["shard_ranks"])
        assert res["dtensor_full"], r


def _permutation_cohorts(cohort_log) -> int:
    """Cohorts whose full-M peer map (each actor's peer, every other row
    itself) is a permutation."""
    n = 0
    for cohort in cohort_log:
        perm = list(range(dr.SIM_M))
        for _, actor, peer in cohort:
            perm[actor] = actor if peer is None else peer
        n += len(set(perm)) == dr.SIM_M
    return n


@pytest.mark.parametrize("case", list(dr.SIM_CASES))
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_engine_matches_jax(cluster, world, case):
    want = cluster.jax()["sim"][case]
    ranks = cluster.case(world, f"sim-{case}")
    for r, got in enumerate(ranks):
        for key in ("times", "events", "trace_events", "cohorts", "dispatches",
                    "cohort_log", "policy_log", "failed_pulls"):
            assert got[key] == want[key], (r, key)
        np.testing.assert_allclose(got["losses"], want["losses"], atol=LOSS_TOL, rtol=0)
        assert got["losses"] == ranks[0]["losses"], r  # the same on every rank
        # Point to point for each cohort whose peer map is a permutation,
        # where every worker has its own rank (JAX :713-722).
        want_p2p = _permutation_cohorts(want["cohort_log"]) if world == dr.SIM_M else 0
        assert got["ppermute_calls"] == want_p2p, (r, got["ppermute_calls"], want_p2p)
    if case == "netmax-churn":
        assert _permutation_cohorts(want["cohort_log"]) > 0  # the branch is exercised
    if case != "netmax-churn":
        assert want["dispatches"] == want["cohorts"] == 45
    else:
        assert want["failed_pulls"], "the outage timed no pull out"


# ------------------------------------------------------------------ (d) the trainer


@pytest.fixture(scope="module")
def jax_train():
    """JAX's unsharded make_train_step (gather pulls; the pull mode changes
    no value) from the port's unsharded init, one run per (strategy,
    groups, permutation draws)."""
    cache = {}

    def get(algo, groups, permutation, M=dr.TRAIN_M, arch="qwen1.5-0.5b", rows=2):
        key = (algo, groups, permutation, M, arch, rows)
        if key not in cache:
            tp, to = ttr.init_stacked(dr.train_cfg(tget, arch), topt.sgd(momentum=0.9), M,
                                      device="cpu")
            to_j = lambda t: jax.tree_util.tree_map(lambda x: jnp.asarray(x.numpy()), t)  # noqa: E731
            params, opt_state = to_j(tp), to_j(to)
            strategy = jalgo("prague", trainer_groups=groups) if groups else algo
            step = jax.jit(jtr.make_train_step(
                dr.train_cfg(jget, arch), jopt.sgd(momentum=0.9), M, strategy,
                step_cfg=jtr.TrainStepConfig(gossip_mode="gather", grad_clip=dr.TRAIN_CLIP)))
            losses = []
            for r in range(dr.TRAIN_ROUNDS):
                batch, gi = dr.train_inputs(r, permutation, M, rows)
                params, opt_state, m = step(
                    params, opt_state, {k: jnp.asarray(v, jnp.int32) for k, v in batch.items()},
                    {"neighbors": jnp.asarray(gi["neighbors"], jnp.int32),
                     "weights": jnp.asarray(gi["weights"]), "lr": jnp.float32(gi["lr"])})
                losses.append((np.asarray(m["loss_per_worker"]), float(m["loss"])))
            cache[key] = params, losses
        return cache[key]

    return get


TRAIN_RUNS = {  # test id -> (world, the rank-side case, TRAIN_MODES key)
    "w2-netmax-gather": (2, "train-netmax-gather", "netmax-gather"),
    "w2-netmax-masked_psum": (2, "train-netmax-masked_psum", "netmax-masked_psum"),
    "w2-allreduce": (2, "train-allreduce", "allreduce"),
    "w2-prague": (2, "train-prague", "prague"),
    "w4-netmax-ppermute": (4, "train-netmax-ppermute", "netmax-ppermute"),
    "w4-prague-groups-span-ranks": (4, "train-prague", "prague"),
    "w8-netmax-gather-model-2": (8, "train-netmax-gather-tp2", "netmax-gather"),
}


@pytest.mark.parametrize("run", list(TRAIN_RUNS))
def test_sharded_trainer_matches_jax(cluster, jax_train, run):
    """Every rank's rows after TRAIN_ROUNDS (the clip on, so its global
    norm spans the ranks) against JAX's unsharded step; each rank holds
    its rows of the same seeded init."""
    world, case, mode = TRAIN_RUNS[run]
    algo, groups, _, permutation = dr.TRAIN_MODES[mode]
    jparams, jlosses = jax_train(algo, groups, permutation)
    want = [_np(x) for x in jax.tree_util.tree_leaves(jparams)]
    scale = max(float(np.abs(x).max()) for x in want)
    for r, res in enumerate(cluster.case(world, case)):
        assert res["init_ok"], r
        lo, hi = res["rows"]
        for (got_w, got_mean), (want_w, want_mean) in zip(res["losses"], jlosses):
            np.testing.assert_allclose(got_w, want_w, atol=TRAIN_TOL, rtol=0)
            assert abs(got_mean - want_mean) <= TRAIN_TOL
        got = [_np(x) for x in tree_leaves(res["params"])]
        assert len(got) == len(want)
        err = max(float(np.abs(g - w[lo:hi]).max()) for g, w in zip(got, want))
        assert err <= TRAIN_TOL * scale, (r, err)


# ------------------------------------------------------------------ (e) refusals


def test_sharded_engine_refusals_in_a_group(cluster):
    for res in cluster.case(2, "refusals"):
        assert res["indivisible"] and "divisible" in res["indivisible"]
        assert res["ps-async"] and "gossip" in res["ps-async"]


def test_sharded_engine_needs_a_process_group():
    """No default group: no silent single-process run."""
    pkg = dr.torch_pkg()
    with pytest.raises(ValueError, match="process group"):
        dr.sim_run(pkg, "netmax", True, device="cpu")
    with pytest.raises(ValueError, match="gossip"):
        dr.sim_run(pkg, "allreduce", True, device="cpu")  # a round strategy, which JAX runs unsharded


def test_ppermute_needs_a_mesh():
    """gossip_mode="ppermute" without a mesh: the trainer and the launcher
    refuse it, where JAX's step asserts."""
    cfg = dr.train_cfg(tget)
    with pytest.raises(ValueError, match="mesh"):
        ttr.make_train_step(cfg, topt.sgd(), 4, "netmax",
                            ttr.TrainStepConfig(gossip_mode="ppermute"))
    with pytest.raises(ValueError, match="mesh"):
        tlaunch.main(["--arch", "tinyllama-1.1b", "--reduced", "--rounds", "1", "--workers",
                      "2", "--seq", "16", "--batch-per-worker", "2", "--gossip", "ppermute",
                      "--device", "cpu"])


@pytest.mark.parametrize("case", list(dr.TP_TRAIN))
def test_tensor_parallel_trainer_matches_jax(cluster, jax_train, case):
    """make_train_step with the plan's 'model'-split specs on 4 ranks (2
    workers x 2 'model', or 1 x 4 where each rank's query heads share a
    sliced KV head, or phi3.5-moe's one worker on 'pod' with each
    micro-batch's rows shared out over 2 'data' ranks, or over 4 where
    'model' has one rank, ROADMAP C22): each
    rank's shards of every leaf after TRAIN_ROUNDS (clip on: its norm spans
    both axes) against the same slices of JAX's unsharded step, losses
    likewise, to the worker-sharded step's tolerance."""
    mode, M, arch, sizes, axes, rows = dr.TP_TRAIN[case]
    algo, groups, _, permutation = dr.TRAIN_MODES[mode]
    jparams, jlosses = jax_train(algo, groups, permutation, M, arch, rows)
    want = [_np(x) for x in jax.tree_util.tree_leaves(jparams)]
    scale = max(float(np.abs(x).max()) for x in want)
    results = cluster.case(4, case)
    # The plan splits leaves where 'model' has more than one rank.
    assert (results[0]["split_leaves"] > 0) == (sizes[1] > 1)
    pieces = set()
    for r, res in enumerate(results):
        for (got_w, got_mean), (want_w, want_mean) in zip(res["losses"], jlosses):
            np.testing.assert_allclose(got_w, want_w, atol=TRAIN_TOL, rtol=0)
            assert abs(got_mean - want_mean) <= TRAIN_TOL
        got = [_np(x) for x in tree_leaves(res["params"])]
        assert len(got) == len(want)
        for g, w, sl in zip(got, want, res["slices"]):
            part = w[tuple(slice(a, b) for a, b in sl)]
            assert g.shape == part.shape, (r, g.shape, part.shape)
            assert float(np.abs(g - part).max()) <= TRAIN_TOL * scale, r
        pieces.add(tuple(tuple(map(tuple, sl)) for sl in res["slices"]))
    # Every rank holds its own shards, but where the rows are shared out
    # over 'data' its ranks hold the same ones.
    row_ranks = results[0]["row_ranks"]
    assert row_ranks == (1 if "data" in axes else sizes[0])
    assert len(pieces) == 4 // row_ranks


@pytest.mark.parametrize("case", list(dr.TP_PREFILL))
def test_tensor_parallel_prefill_matches_jax(cluster, case):
    """lm.prefill_logits on DTensors (params split on 'model', the batch on
    'data'; the dense family's attention and the ssm family's WKV scan over
    heads) against the JAX package's, from the same params, to 1e-4."""
    from repro.models import lm as jlm
    from repro_torch.models import lm as tlm

    arch = dr.TP_PREFILL[case]
    params = tlm.init_params(dr.train_cfg(tget, arch), torch.Generator().manual_seed(0))
    jparams = jax.tree_util.tree_map(lambda x: jnp.asarray(x.numpy()), params)
    tokens = dr.tp_prefill_tokens()
    want = np.asarray(jlm.prefill_logits(jparams, {"tokens": jnp.asarray(tokens, jnp.int32)},
                                         dr.train_cfg(jget, arch)))
    for res in cluster.case(4, case):
        np.testing.assert_allclose(res["logits"].numpy(), want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("case", list(dr.TP_DECODE))
def test_tensor_parallel_decode_matches_jax(cluster, case):
    """lm.decode_step on DTensors over 1 x 4 'model' ranks, each holding
    one query head and slicing its KV head from the replicated cache
    (ROADMAP C17), from a short prefill's params and cache, against the JAX
    package's decode_step from the same: the logits and the cache it wrote,
    to 1e-4, on every rank, every layer's attention split."""
    from repro.models import lm as jlm
    from repro_torch.models import lm as tlm

    arch = dr.TP_DECODE[case]
    cfg = dr.train_cfg(tget, arch)
    params = tlm.init_params(cfg, torch.Generator().manual_seed(0))
    cache = dr.tp_decode_cache(cfg, params)
    _, token = dr.tp_decode_inputs()
    to_j = lambda t: jax.tree_util.tree_map(lambda x: jnp.asarray(x.numpy()), t)  # noqa: E731
    logits, jcache = jlm.decode_step(to_j(params), to_j(cache), jnp.asarray(token, jnp.int32),
                                     dr.TP_DECODE_PREFILL, dr.train_cfg(jget, arch))
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(jcache)]
    for res in cluster.case(4, case):
        assert res["split_layers"] == cfg.n_layers
        np.testing.assert_allclose(res["logits"].numpy(), np.asarray(logits), atol=1e-4, rtol=0)
        got = [t.numpy() for t in tree_leaves(res["cache"])]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, atol=1e-4, rtol=0)


def test_placements_follow_mesh_order():
    from torch.distributed.tensor import Replicate, Shard

    shape = {"pod": 2, "data": 2, "model": 2}
    P = tshd.P
    assert tshd.placements(P(("pod", "data"), None, "model"), shape) == [
        Shard(0), Shard(0), Shard(2)]
    assert tshd.placements(P(None, None), shape) == [Replicate()] * 3
    with pytest.raises(ValueError, match="mesh order"):
        tshd.placements(P(("data", "pod")), shape)
