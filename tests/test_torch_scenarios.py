"""The port's network-dynamics layer against the JAX package's.

``scenarios/{presets,hazard,chaos}`` and ``core/matching`` are numpy-only
copies, so on the same seeds and topologies they must give the same
timelines, fault decisions, counters and matchings bit for bit.  Then the
whole layer in one run: ``simulate`` at M = 12 (3 clusters of 4, the
storms bench's shape) through a seeded hazard storm, with a home-pinned
Monitor that fails over and a ``ChaosInjector`` dropping reports and
publishes, on both engines of both packages from the same initial MLP:
host-side outputs bit-equal, losses within 5e-4 (two frameworks sum f32
matmuls in different orders; the engine-parity tolerance of
tests/test_engines.py).  Each JAX simulation runs once per module.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest

from repro.core import matching as jmatch
from repro.core.nettime import LinkTimeModel as JLink
from repro.core.nettime import Topology as JTopo
from repro.data.partition import uniform_partition
from repro.data.synthetic import train_eval_split
from repro.scenarios import ChaosInjector as JChaos
from repro.scenarios import hazard as jhazard
from repro.scenarios import presets as jpresets
from repro.train import simulator as jsim
from repro_torch.convert import params_from_jax
from repro_torch.core import matching as tmatch
from repro_torch.core.nettime import LinkTimeModel as TLink
from repro_torch.core.nettime import Topology as TTopo
from repro_torch.scenarios import ChaosInjector as TChaos
from repro_torch.scenarios import ChaosError as TChaosError
from repro_torch.scenarios import hazard as thazard
from repro_torch.scenarios import presets as tpresets
from repro_torch.train import simulator as tsim

LOSS_TOL = 5e-4


def _events(tl):
    """A timeline's events as (class name, fields) tuples."""
    return [(type(e).__name__, dataclasses.astuple(e)) for e in tl.events]


def _topos(M=12, **kw):
    kw = kw or dict(workers_per_host=2, hosts_per_pod=2, pods_per_cluster=1)
    return JTopo(n_workers=M, **kw), TTopo(n_workers=M, **kw)


def _segments(tl, topo):
    return [(s.start, s.dead.tobytes(), s.degrade.tobytes())
            for s in tl.compile(topo).segments]


PRESETS = {
    "cluster_outage": lambda p, topo: p.cluster_outage(1, 2.0, 9.5),
    "partition": lambda p, topo: p.partition(topo, 3.0, 7.0),
    "degrade_links": lambda p, topo: p.degrade_links([(0, 5), (7, 2)], 1.0, 4.0, 8.0),
    "worker_blip": lambda p, topo: p.worker_blip(3, 1.5, 6.0, seed_from=2),
    "federated_cohorts": lambda p, topo: p.federated_cohorts(topo, 4, 40.0, 5, 6),
    "random_timeline": lambda p, topo: p.random_timeline(topo, 11, 300.0, n_outages=2,
                                                         n_degrades=3, n_churn=2),
}


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_presets_equal_jax(name):
    jt, tt = _topos()
    a = PRESETS[name](jpresets, jt)
    b = PRESETS[name](tpresets, tt)
    assert _events(a) == _events(b) and a.events
    assert _segments(a, jt) == _segments(b, tt)


@pytest.mark.parametrize("seed", [0, 7, 31])
@pytest.mark.parametrize("kw", [
    dict(intensity=2.0, trigger_cluster=0, trigger_time=0.8),
    dict(intensity=0.5),
    dict(intensity=4.0, worker_blips=False, max_events=6),
], ids=["trigger", "mild", "capped"])
def test_storm_equals_jax(seed, kw):
    jt, tt = _topos()
    a = jhazard.storm(jt, seed=seed, horizon=40.0, **kw)
    b = thazard.storm(tt, seed=seed, horizon=40.0, **kw)
    assert _events(a) == _events(b)
    assert _segments(a, jt) == _segments(b, tt)


def test_hazard_timeline_equals_jax():
    jt, tt = _topos(16, workers_per_host=2, hosts_per_pod=2, pods_per_cluster=1)
    over = dict(decay=0.02, outage_len=(5.0, 30.0), degrade_factor=(2.0, 9.0))
    a = jhazard.hazard_timeline(jt, 5, 200.0, jhazard.HazardConfig(base_cluster_rate=0.01),
                                trigger_cluster=2, trigger_time=3.0, **over)
    b = thazard.hazard_timeline(tt, 5, 200.0, thazard.HazardConfig(base_cluster_rate=0.01),
                                trigger_cluster=2, trigger_time=3.0, **over)
    assert _events(a) == _events(b) and len(a.events) > 3
    assert dataclasses.astuple(jhazard.HazardConfig()) == dataclasses.astuple(
        thazard.HazardConfig())
    with pytest.raises(ValueError):
        thazard.storm(tt, 0, 10.0, intensity=0.0)


def _chaos_stream(cls, error):
    """Interleaved calls on every channel; the decisions and counters."""
    ch = cls(seed=3, solver_fail_rate=0.35, solver_delay_rate=0.2, solver_delay_ms=7.0,
             report_drop_rate=0.3, publish_delay_rate=0.4, publish_delay_periods=1.5,
             queue_delay_rate=0.25, queue_delay_ms=11.0)
    out = []
    for k in range(400):
        try:
            ch.maybe_fail_solver()
            out.append("ok")
        except error:
            out.append("fault")
        out.append(ch.injected_delay_ms())
        out.append(ch.injected_queue_delay_ms())
        out.append(ch.drop_report(k % 12, 0.1 * k))
        if k % 3 == 0:
            out.append(ch.publish_lost(0.1 * k, 0.5))
    counters = (ch.n_solver_faults, ch.n_injected_delays, ch.n_dropped_reports,
                ch.n_lost_publishes, ch.n_queue_delays)
    return out, counters


def test_chaos_streams_and_counters_equal_jax():
    from repro.scenarios import ChaosError as JChaosError

    a = _chaos_stream(JChaos, JChaosError)
    b = _chaos_stream(TChaos, TChaosError)
    assert a == b
    assert all(c > 0 for c in b[1])
    with pytest.raises(ValueError):
        TChaos(report_drop_rate=1.5)


def _policy(M, seed):
    rng = np.random.default_rng(seed)
    P = rng.uniform(0.05, 1.0, size=(M, M))
    P[rng.uniform(size=(M, M)) < 0.3] = 0.0
    np.fill_diagonal(P, 0.0)
    return P / np.maximum(P.sum(axis=1, keepdims=True), 1e-12)


@pytest.mark.parametrize("M,seed", [(3, 0), (5, 1), (8, 2), (12, 3)])
def test_matching_equals_jax(M, seed):
    P = _policy(M, seed)
    Qa, Qb = jmatch.sinkhorn(P), tmatch.sinkhorn(P)
    np.testing.assert_array_equal(Qa, Qb)
    da, db = jmatch.birkhoff_decompose(Qa), tmatch.birkhoff_decompose(Qb)
    np.testing.assert_array_equal(da.weights, db.weights)
    assert [p.tolist() for p in da.permutations] == [p.tolist() for p in db.permutations]
    assert da.residual == db.residual
    np.testing.assert_array_equal(jmatch.marginal_matrix(da), tmatch.marginal_matrix(db))
    sa, sb = jmatch.matched_sampler(P, 16), tmatch.matched_sampler(P, 16)
    ra, rb = np.random.default_rng(seed), np.random.default_rng(seed)
    assert ([sa.sample(ra).tolist() for _ in range(20)]
            == [sb.sample(rb).tolist() for _ in range(20)])


# -- simulate under a storm and chaos ----------------------------------------

JAX = dict(Topo=JTopo, Link=JLink, sim=jsim, storm=jhazard.storm, Chaos=JChaos)
TORCH = dict(Topo=TTopo, Link=TLink, sim=tsim, storm=thazard.storm, Chaos=TChaos)
M = 12
EVENTS = 360


@functools.lru_cache(maxsize=None)
def _data():
    x, y, ex, ey = train_eval_split(1200, 300, 32, 10, seed=0)
    return x, y, uniform_partition(len(y), M, seed=0), ex, ey


def _storm_run(pkg, engine):
    """The storms bench's netmax run (3 clusters of 4, storm seed 7, horizon
    40, intensity 2, trigger cluster 0 at 0.8, Monitor home cluster 0 with
    failover), shortened, with chaos on the Monitor's channels."""
    topo = pkg["Topo"](n_workers=M, workers_per_host=2, hosts_per_pod=2,
                       pods_per_cluster=1)
    tl = pkg["storm"](topo, seed=7, horizon=40.0, intensity=2.0, trigger_cluster=0,
                      trigger_time=0.8)
    link = pkg["Link"](topo, jitter=0.02, seed=5, scenario=tl, dead_link_timeout=0.5)
    chaos = pkg["Chaos"](seed=3, report_drop_rate=0.3, publish_delay_rate=0.3)
    cfg = pkg["sim"].SimConfig(algorithm="netmax", n_workers=M, total_events=EVENTS,
                               lr=0.05, seed=3, engine=engine, monitor_period=0.3,
                               monitor_home_cluster=0, monitor_failover=True,
                               chaos=chaos, trace=True)
    x, y, parts, ex, ey = _data()
    kw = {}
    if pkg is TORCH:
        p0 = jsim.mlp_init(jax.random.PRNGKey(cfg.seed), [x.shape[1], 128, 64, 10])
        kw = dict(init_params=params_from_jax(p0), device="cpu")
    res = pkg["sim"].simulate(cfg, link, x, y, parts, ex, ey, record_every=120, **kw)
    counters = (chaos.n_dropped_reports, chaos.n_lost_publishes)
    return res, counters


@functools.lru_cache(maxsize=None)
def _jax_storm_run(engine):
    return _storm_run(JAX, engine)


@pytest.mark.parametrize("engine", ["reference", "batched"])
def test_simulate_under_storm_and_chaos_equals_jax(engine):
    ref, ref_chaos = _jax_storm_run(engine)
    got, got_chaos = _storm_run(TORCH, engine)
    assert got.engine == ref.engine == engine
    assert got.events == ref.events and got.times == ref.times
    assert got.comm_time == ref.comm_time and got.compute_time == ref.compute_time
    assert got.failed_pulls == ref.failed_pulls and got.failed_pulls
    assert got.trace_events == ref.trace_events
    assert got.policy_updates == ref.policy_updates
    assert len(got.policy_log) == len(ref.policy_log)
    for (ta, ra, Pa), (tb, rb, Pb) in zip(ref.policy_log, got.policy_log):
        assert ta == tb and ra == rb
        np.testing.assert_array_equal(Pa, Pb)
    assert got.leader_log == ref.leader_log and got.leader_log  # a failover
    assert got.skipped_refreshes == ref.skipped_refreshes
    assert got_chaos == ref_chaos and min(got_chaos) > 0
    if engine == "batched":
        assert (got.cohorts, got.dispatches) == (ref.cohorts, ref.dispatches)
    np.testing.assert_allclose(got.losses, ref.losses, rtol=LOSS_TOL, atol=LOSS_TOL)
    assert got.losses[-1] < got.losses[0]
