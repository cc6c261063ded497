"""The port's ``simulate`` against the JAX package's, on identical inputs.

Both packages get the same data, partition, link model, config and initial
parameters (the JAX ``mlp_init`` output, carried across with
``params_from_jax``).  Tolerances and why:

* host-side outputs — events, virtual times, comm/compute time, published
  policies, failed pulls, the trace stream, and for the batched engine the
  cohort/dispatch counts and the cohort log — come from the same numpy
  code drawing the same RNG streams in the same order: bit-equal;
* losses — the model math runs in two frameworks, whose f32 matmuls and
  reductions sum in different orders: 5e-4, the tolerance the JAX
  package's own engine-parity suite allows between its two engines
  (tests/test_engines.py ``_assert_parity``);
* accuracies — an argmax over near-tied logits may flip for a few of the
  evaluation rows: 0.02, as in ``_assert_parity``.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from repro.core.nettime import LinkTimeModel as JLink
from repro.core.nettime import Topology as JTopo
from repro.data.partition import uniform_partition
from repro.data.synthetic import train_eval_split
from repro.scenarios import ClusterOutage as JOutage
from repro.scenarios import Timeline as JTimeline
from repro.train import simulator as jsim
from repro_torch.convert import params_from_jax
from repro_torch.core.nettime import LinkTimeModel as TLink
from repro_torch.core.nettime import Topology as TTopo
from repro_torch.scenarios import ClusterOutage as TOutage
from repro_torch.scenarios import Timeline as TTimeline
from repro_torch.train import simulator as tsim

LOSS_TOL = 5e-4
ACC_TOL = 0.02

# name -> (M, topology kwargs, data split, link kwargs, outage, cfg kwargs,
#          record_every)
SHAPES = {
    # README quickstart, second block.
    "quickstart": (4, dict(workers_per_host=2, hosts_per_pod=1),
                   (600, 200, 16, 4), dict(jitter=0.02, seed=5), False,
                   dict(total_events=200), 100),
    # tests/test_engines.py::_sim.
    "sim": (8, dict(workers_per_host=4, hosts_per_pod=1),
            (1600, 400, 32, 10),
            dict(jitter=0.02, seed=5, slow_interval=60.0, dead_link_timeout=2.0),
            False, dict(total_events=450, lr=0.05, monitor_period=0.6, trace=True),
            150),
    # The same, two clusters, cluster 1 cut off during [1, 3).
    "outage": (8, dict(workers_per_host=2, hosts_per_pod=2, pods_per_cluster=1),
               (1600, 400, 32, 10),
               dict(jitter=0.02, seed=5, slow_interval=60.0, dead_link_timeout=2.0),
               True, dict(total_events=450, lr=0.05, monitor_period=0.6, trace=True),
               150),
}

ENGINES = {
    "reference": dict(engine="reference"),
    "batched": dict(engine="batched", use_mix_kernel=False),
    "batched-mix-kernel": dict(engine="batched", use_mix_kernel=True),
}


@functools.lru_cache(maxsize=None)
def _data(split):
    return train_eval_split(*split, seed=0)


def _run(pkg, shape, algo, engine):
    M, topo_kw, split, link_kw, outage, cfg_kw, record_every = SHAPES[shape]
    x, y, ex, ey = _data(split)
    parts = uniform_partition(len(y), M, seed=0)
    Topo, Link, Timeline, Outage, sim = (
        (JTopo, JLink, JTimeline, JOutage, jsim) if pkg == "jax"
        else (TTopo, TLink, TTimeline, TOutage, tsim)
    )
    scenario = Timeline([Outage(1, 1.0, 3.0)]) if outage else None
    link = Link(Topo(n_workers=M, **topo_kw), scenario=scenario, **link_kw)
    cfg = sim.SimConfig(algorithm=algo, n_workers=M, seed=0, **cfg_kw,
                        **ENGINES[engine])
    log: list = []
    kw = {}
    if pkg == "torch":
        dims = [x.shape[1], 128, 64, int(y.max()) + 1]
        p0 = jsim.mlp_init(jax.random.PRNGKey(cfg.seed), dims)
        kw = dict(init_params=params_from_jax(p0), device="cpu")
    res = sim.simulate(cfg, link, x, y, parts, ex, ey, record_every=record_every,
                       _cohort_log=log, **kw)
    return res, log


# Every ported strategy on every engine path at the _sim shape; netmax
# through the outage; the quickstart as the README runs it (engine "auto" is
# the batched engine there) and on the reference loop.  Each JAX batched
# shape costs seconds of XLA compilation, which bounds the matrix.
CASES = (
    [("sim", a, e) for a in ("netmax", "adpsgd", "adpsgd+mon") for e in ENGINES]
    + [("outage", "netmax", e) for e in ENGINES]
    + [("quickstart", "netmax", e) for e in ("reference", "batched")]
)


@pytest.mark.parametrize("shape,algo,engine", CASES)
def test_simulate_matches_jax(shape, algo, engine):
    (ref, ref_log), (got, got_log) = _run("jax", shape, algo, engine), _run(
        "torch", shape, algo, engine)
    assert got.engine == ref.engine
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
    assert got.trace_events == ref.trace_events
    assert got.cohorts == ref.cohorts and got.dispatches == ref.dispatches
    assert got_log == ref_log
    np.testing.assert_allclose(got.losses, ref.losses, rtol=LOSS_TOL, atol=LOSS_TOL)
    np.testing.assert_allclose(got.accs, ref.accs, atol=ACC_TOL)
    # The case exercises what it names.
    if shape == "outage":
        assert got.failed_pulls
    if engine != "reference":
        assert 0 < got.dispatches <= got.cohorts < got.events[-1]
    if shape != "quickstart" and algo != "adpsgd":
        assert got.policy_updates > 0


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    """simulate() runs on CUDA unless told otherwise; with no card it
    raises instead of quietly running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    M, topo_kw, split, link_kw, _, cfg_kw, rec = SHAPES["quickstart"]
    x, y, ex, ey = _data(split)
    link = TLink(TTopo(n_workers=M, **topo_kw), **link_kw)
    cfg = tsim.SimConfig(n_workers=M, **cfg_kw)
    parts = uniform_partition(len(y), M, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsim.simulate(cfg, link, x, y, parts, ex, ey, record_every=rec)


def test_seeded_init_is_device_independent_and_deterministic():
    """Without init_params the port draws p0 from a CPU torch.Generator
    seeded by cfg.seed, so every device starts from the same weights."""
    g = lambda: torch.Generator().manual_seed(3)
    a = tsim.mlp_init(g(), [16, 128, 64, 4])
    b = tsim.mlp_init(g(), [16, 128, 64, 4], device="cpu")
    for la, lb in zip(a, b):
        for k in la:
            assert torch.equal(la[k], lb[k])
    assert a[0]["w"].std().item() == pytest.approx(1 / 4, rel=0.1)
    assert not a[0]["b"].any()


def test_sync_and_unported_paths_raise():
    """A synchronous strategy runs on the default engine (it raised before
    the round engine was ported; tests/test_torch_engines.py holds it to the
    JAX package); an unknown strategy raises, and the device-sharded path
    refuses a strategy outside the gossip family, as the JAX package's
    ``test_shard_workers_rejects_unsupported_shapes`` pins (the sharded
    path itself: tests/test_torch_dist.py)."""
    M, topo_kw, split, link_kw, _, cfg_kw, rec = SHAPES["quickstart"]
    x, y, ex, ey = _data(split)
    parts = uniform_partition(len(y), M, seed=0)

    def run(**kw):
        link = TLink(TTopo(n_workers=M, **topo_kw), **link_kw)
        cfg = tsim.SimConfig(n_workers=M, **dict(cfg_kw, **kw))
        return tsim.simulate(cfg, link, x, y, parts, ex, ey, record_every=rec,
                             device="cpu")

    res = run(algorithm="allreduce")
    assert res.engine == "batched" and res.cohorts == cfg_kw["total_events"] // M
    with pytest.raises(KeyError, match="unknown algorithm"):
        run(algorithm="no-such-strategy")
    with pytest.raises(ValueError, match="gossip"):
        run(algorithm="ps-async", engine="batched", shard_workers=True)


def test_reseed_replica_clones_the_seed():
    from repro_torch.train.elastic import reseed_replica

    reps = [[{"w": torch.ones(2, 2), "b": torch.ones(2)}] for _ in range(2)]
    moms = [[{"w": torch.ones(2, 2), "b": torch.ones(2)}] for _ in range(2)]
    reseed_replica(reps, moms, 1, 0)
    reps[1][0]["w"].add_(1.0)  # an in-place update of the joiner...
    assert torch.equal(reps[0][0]["w"], torch.ones(2, 2))  # ...leaves the seed
    assert not moms[1][0]["w"].any()
