"""The parity matrix of the port's two engines against the JAX package's.

Every registered strategy runs on the reference loop and on the batched
engine, in both packages, with the same data, partition, link model, config
and initial parameters (the JAX ``mlp_init`` output, carried across with
``params_from_jax``), at the shape of tests/test_engines.py ``_sim`` (M = 8,
450 events, traced); then with shards so small that per-worker batch sizes
differ, and on a timeline with a cluster outage and a leave/rejoin (the
rejoin reseeds a replica between the sync engine's blocks).  Each port run
is held to the JAX package's run on the *same* engine.  Tolerances and why:

* host-side outputs — events, virtual times, comm/compute time, published
  policies, failed pulls, the trace stream, and for the batched engine the
  cohort/dispatch counts and the cohort log — come from the same numpy
  code drawing the same RNG streams in the same order: bit-equal;
* losses 5e-4 and accuracies 0.02: the model math runs in two frameworks,
  whose f32 matmuls and reductions sum in different orders; the tolerances
  of the JAX package's own engine-parity suite (tests/test_engines.py
  ``_assert_parity``).

The JAX runs are cached for the module, one per (case, engine).
"""

import functools

import jax
import numpy as np
import pytest

from repro.algos import list_algorithms
from repro.core.nettime import LinkTimeModel as JLink
from repro.core.nettime import Topology as JTopo
from repro.data.partition import size_skewed_partition, uniform_partition
from repro.data.synthetic import train_eval_split
from repro.scenarios import ClusterOutage as JOutage
from repro.scenarios import LinkDegrade as JDegrade
from repro.scenarios import Timeline as JTimeline
from repro.scenarios import WorkerLeave as JLeave
from repro.scenarios import WorkerRejoin as JRejoin
from repro.train import simulator as jsim
from repro_torch.convert import params_from_jax
from repro_torch.core.nettime import LinkTimeModel as TLink
from repro_torch.core.nettime import Topology as TTopo
from repro_torch.scenarios import ClusterOutage as TOutage
from repro_torch.scenarios import LinkDegrade as TDegrade
from repro_torch.scenarios import Timeline as TTimeline
from repro_torch.scenarios import WorkerLeave as TLeave
from repro_torch.scenarios import WorkerRejoin as TRejoin
from repro_torch.train import simulator as tsim

LOSS_TOL = 5e-4
ACC_TOL = 0.02
M = 8

JAX = dict(Topo=JTopo, Link=JLink, sim=jsim, Timeline=JTimeline, Outage=JOutage,
           Degrade=JDegrade, Leave=JLeave, Rejoin=JRejoin)
TORCH = dict(Topo=TTopo, Link=TLink, sim=tsim, Timeline=TTimeline, Outage=TOutage,
             Degrade=TDegrade, Leave=TLeave, Rejoin=TRejoin)


@functools.lru_cache(maxsize=None)
def _data():
    return train_eval_split(1600, 400, 32, 10, seed=0)


def _parts(case, y):
    if case == "skewed":
        return size_skewed_partition(len(y), M, segments=[1 + i % 3 for i in range(M)])
    return uniform_partition(len(y), M, seed=0)


def _run(pkg, case, algo, engine):
    """One simulate() of ``pkg`` (JAX or TORCH): case "sim" is
    tests/test_engines.py ``_sim``; "skewed" adds its skewed shards at
    batch 150; "churn" its scenario timeline (two clusters of 4, a cluster
    outage, a degraded link, worker 3 leaving and rejoining), ten times as
    long for a round strategy, whose rounds cross the clusters' WAN link
    and take seconds each, so that the outage spans round starts and the
    rejoin lands mid-run."""
    x, y, ex, ey = _data()
    topo_kw = dict(workers_per_host=4, hosts_per_pod=1)
    scenario = None
    if case == "churn":
        topo_kw = dict(workers_per_host=2, hosts_per_pod=2, pods_per_cluster=1)
        k = 10.0 if pkg["sim"].get_algorithm(algo).synchronous else 1.0
        scenario = pkg["Timeline"]([
            pkg["Outage"](1, 1.0 * k, 3.0 * k),
            pkg["Degrade"](0, 1, 0.5, 4.0 * k, 8.0 * k),
            pkg["Leave"](3, 1.5 * k),
            pkg["Rejoin"](3, 3.5 * k),
        ])
    link = pkg["Link"](pkg["Topo"](n_workers=M, **topo_kw), jitter=0.02, seed=5,
                       slow_interval=60.0, scenario=scenario, dead_link_timeout=2.0)
    cfg = pkg["sim"].SimConfig(algorithm=algo, n_workers=M, total_events=450, lr=0.05,
                               monitor_period=0.6, seed=0, engine=engine, trace=True,
                               batch_size=150 if case == "skewed" else 64)
    kw = {}
    if pkg is TORCH:
        p0 = jsim.mlp_init(jax.random.PRNGKey(cfg.seed), [x.shape[1], 128, 64, 10])
        kw = dict(init_params=params_from_jax(p0), device="cpu")
    log: list = []
    res = pkg["sim"].simulate(cfg, link, x, y, _parts(case, y), ex, ey,
                              record_every=150, _cohort_log=log, **kw)
    return res, log


@functools.lru_cache(maxsize=None)
def _jax_run(case, algo, engine):
    return _run(JAX, case, algo, engine)


CASES = (
    [("sim", a, e) for a in list_algorithms() for e in ("reference", "batched")]
    + [("skewed", a, e) for a in ("allreduce", "ps-async") for e in ("reference", "batched")]
    + [("churn", a, e) for a in ("allreduce", "ps-async") for e in ("reference", "batched")]
)


@pytest.mark.parametrize("case,algo,engine", CASES)
def test_engine_matches_jax(case, algo, engine):
    ref, ref_log = _jax_run(case, algo, engine)
    got, got_log = _run(TORCH, case, algo, engine)
    assert got.engine == ref.engine == engine
    assert got.events == ref.events
    assert got.times == ref.times
    assert got.comm_time == ref.comm_time
    assert got.compute_time == ref.compute_time
    assert got.policy_updates == ref.policy_updates
    assert len(got.policy_log) == len(ref.policy_log)
    for (ta, ra, Pa), (tb, rb, Pb) in zip(ref.policy_log, got.policy_log):
        assert ta == tb and ra == rb
        np.testing.assert_array_equal(Pa, Pb)
    assert got.failed_pulls == ref.failed_pulls
    assert got.trace_events == ref.trace_events and got.trace_events
    assert got.cohorts == ref.cohorts and got.dispatches == ref.dispatches
    assert got_log == ref_log
    np.testing.assert_allclose(got.losses, ref.losses, rtol=LOSS_TOL, atol=LOSS_TOL)
    np.testing.assert_allclose(got.accs, ref.accs, atol=ACC_TOL)
    # The case exercises what it names.
    assert got.losses[-1] < got.losses[0]
    if engine == "batched":
        assert 0 < got.dispatches <= got.cohorts
    if case == "skewed":
        x, y, _, _ = _data()
        assert len({min(150, len(p)) for p in _parts(case, y)}) > 1
    if case == "churn" and algo == "ps-async":
        assert got.failed_pulls
    if case == "churn" and algo == "allreduce":
        # The outage prices the rounds it spans at the dead links' timeout.
        kinds = {e[4] for e in got.trace_events}
        assert "timeout" in kinds and "round" in kinds


def test_sync_rejoin_reseeds_between_blocks(monkeypatch):
    """On the churn timeline the rejoin of worker 3 reseeds its row once,
    between two dispatches, and the scenario's boundaries split the batched
    sync engine's blocks: the run makes more dispatches than the same run
    with no scenario, while its cohorts (rounds) stay the same."""
    from repro_torch.train import engine

    reseeds = []
    real = engine.reseed_row

    def counted(R, Mom, w, src):
        reseeds.append((w, src))
        return real(R, Mom, w, src)

    monkeypatch.setattr(engine, "reseed_row", counted)
    churn, _ = _run(TORCH, "churn", "allreduce", "batched")
    assert len(reseeds) == 1 and reseeds[0][0] == 3
    x, y, ex, ey = _data()
    link = TLink(TTopo(n_workers=M, workers_per_host=2, hosts_per_pod=2,
                       pods_per_cluster=1), jitter=0.02, seed=5, slow_interval=60.0,
                 dead_link_timeout=2.0)
    cfg = tsim.SimConfig(algorithm="allreduce", n_workers=M, total_events=450, lr=0.05,
                         seed=0, engine="batched")
    calm = tsim.simulate(cfg, link, x, y, _parts("sim", y), ex, ey, record_every=150,
                         device="cpu")
    assert churn.cohorts == calm.cohorts == 450 // M
    assert churn.dispatches > calm.dispatches
