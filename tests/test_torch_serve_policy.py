"""The port's policy serving (``serve/{policy,shard,admission,rpc}``)
against the JAX package's.

All four are numpy-only copies over ``core/policy``, so on one request
stream the answers are bit-equal, and so is every counter of
``ServeStats`` that does not read the wall clock (latency percentiles do;
no stream here sets a deadline a run could miss).  The degradation ladder
runs on a seeded ``ChaosInjector`` in both packages: retries, stale
answers, the circuit breaker and the uniform fallback fire on the same
requests.  Admission's hopeless-deadline sheds come from the chaos queue
delay, so they fall on the same requests too.  The wire format
``repro.serve/v1`` is shared: a JAX client talks to a port service and a
port client to a JAX service, each answer bit-equal to the in-process
one.
"""

import numpy as np
import pytest

import repro.serve as jserve
import repro_torch.serve as tserve
from repro.core.policy import connectivity_key as jkey
from repro.scenarios import ChaosInjector as JChaos
from repro.serve.shard import shard_index as jshard_index
from repro_torch.core.policy import connectivity_key as tkey
from repro_torch.scenarios import ChaosInjector as TChaos
from repro_torch.serve.policy import normalize_instance
from repro_torch.serve.shard import shard_index as tshard_index

JAX = dict(serve=jserve, Chaos=JChaos)
TORCH = dict(serve=tserve, Chaos=TChaos)
#: ServeStats counters that do not depend on the wall clock.
COUNTERS = ("n_requests", "n_hits", "n_coalesced", "n_solves", "n_invalidations",
            "n_evictions", "n_solve_errors", "n_retries", "n_deadline_misses",
            "n_stale_served", "n_uniform_fallbacks", "n_breaker_trips",
            "n_breaker_probes", "n_breaker_recoveries", "hit_rate")


def make_T(M, seed, lo=0.5, hi=3.0):
    rng = np.random.default_rng(seed)
    T = rng.uniform(lo, hi, (M, M))
    T = (T + T.T) / 2
    np.fill_diagonal(T, 0.0)
    return T


def ring_d(M, extra=()):
    d = np.zeros((M, M))
    for i in range(M):
        d[i, (i + 1) % M] = d[(i + 1) % M, i] = 1.0
    for i, j in extra:
        d[i, j] = d[j, i] = 1.0
    return d


def _answers_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.ok == y.ok
        np.testing.assert_array_equal(x.P, y.P)
        assert (x.rho, x.t_bar, x.lambda2) == (y.rho, y.t_bar, y.lambda2)
        assert x.T_convergence == y.T_convergence or not (
            np.isfinite(x.T_convergence) or np.isfinite(y.T_convergence))


def _stream(pkg, chaos_rate):
    """The storms bench's serving stream, shortened: EMA snapshots that
    drift between epochs (a miss each) and fp noise within one (hits), an
    edge-set change, 35% solver faults when ``chaos_rate`` is set."""
    chaos = pkg["Chaos"](seed=3, solver_fail_rate=chaos_rate) if chaos_rate else None
    srv = pkg["serve"].PolicyServer(alpha=0.1, K=4, R=4, quant=0.05, max_retries=2,
                                    backoff_ms=0.0, breaker_threshold=3,
                                    breaker_probe_every=4, chaos=chaos)
    rng = np.random.default_rng(11)
    bases = [make_T(10, s) for s in range(3)]
    out, rungs = [], []
    for epoch in range(6):
        B = bases[int(rng.integers(len(bases)))]
        snap = B + rng.uniform(-1e-4, 1e-4, B.shape)
        d = ring_d(10, extra=[(0, 5)]) if epoch == 3 else None
        for _ in range(5):
            res, meta = srv.request_meta(snap + rng.uniform(-1e-9, 1e-9, B.shape),
                                         d=d, tenant="stream")
            out.append(res)
            rungs.append(meta["rung"])
    out.extend(srv.request_many([(bases[0], None), (bases[1], ring_d(10))]))
    st = srv.stats.snapshot()
    faults = chaos.n_solver_faults if chaos else 0
    return out, rungs, {k: st[k] for k in COUNTERS}, faults


@pytest.mark.parametrize("chaos_rate", [0.0, 0.35], ids=["clean", "chaos"])
def test_policy_server_answers_and_stats_equal_jax(chaos_rate):
    a_out, a_rungs, a_st, a_faults = _stream(JAX, chaos_rate)
    b_out, b_rungs, b_st, b_faults = _stream(TORCH, chaos_rate)
    _answers_equal(a_out, b_out)
    assert a_rungs == b_rungs and a_st == b_st and a_faults == b_faults
    assert b_st["n_hits"] > 0 and b_st["n_invalidations"] > 0
    if chaos_rate:
        assert b_faults > 0 and b_st["n_retries"] > 0


def _blackout(pkg):
    """Total solver blackout: the breaker trips and every request gets the
    uniform fallback; then the fault clears and a probe closes it."""
    chaos = pkg["Chaos"](seed=4, solver_fail_rate=1.0)
    srv = pkg["serve"].PolicyServer(alpha=0.1, K=4, R=4, quant=0.05, max_retries=1,
                                    backoff_ms=0.0, breaker_threshold=2,
                                    breaker_probe_every=3, chaos=chaos)
    rng = np.random.default_rng(5)
    B = make_T(8, 9)
    dark = [srv.request(B + rng.uniform(-1e-4, 1e-4, B.shape)) for _ in range(8)]
    tripped = srv.breaker_open
    chaos.solver_fail_rate = 0.0
    light = [srv.request(B + rng.uniform(-1e-4, 1e-4, B.shape)) for _ in range(6)]
    st = srv.stats.snapshot()
    return dark + light, tripped, srv.breaker_open, {k: st[k] for k in COUNTERS}


def test_breaker_blackout_and_recovery_equal_jax():
    a, b = _blackout(JAX), _blackout(TORCH)
    _answers_equal(a[0], b[0])
    assert a[1:] == b[1:]
    out, tripped, still_open, st = b
    assert tripped and not still_open
    assert not any(r.ok for r in out[:8]) and any(r.ok for r in out[8:])
    assert st["n_breaker_trips"] == 1 and st["n_breaker_recoveries"] == 1


def test_shard_routing_equals_jax():
    for M, extra in [(8, ()), (8, [(0, 4)]), (12, [(1, 5), (2, 9)]), (16, [(3, 11)])]:
        d = ring_d(M, extra)
        assert tkey(d) == jkey(d)
        for n in (1, 2, 3, 4, 7):
            assert tshard_index(tkey(d), n) == jshard_index(jkey(d), n)
    T = make_T(8, 6)
    T[0, 3] = T[3, 0] = np.inf
    ja = jserve.ShardRouter.build(4, 0.9, K=4, R=4)
    ta = tserve.ShardRouter.build(4, 0.9, K=4, R=4)
    reqs = [(make_T(8, i % 2), ring_d(8, extra=[(0, 2 + i % 3)])) for i in range(6)]
    reqs.append((T, None))
    assert [ja.shard_of(*r) for r in reqs] == [ta.shard_of(*r) for r in reqs]
    _answers_equal(ja.request_many(reqs), ta.request_many(reqs))
    assert _router_counters(ja) == _router_counters(ta)
    Tn, dn = normalize_instance(T, None)
    assert dn[0, 3] == 0.0 and Tn[0, 3] == 0.0


def _router_counters(router):
    """A router's stats without the wall-clock latency percentiles."""
    def strip(st):
        return {k: v for k, v in st.items() if k not in ("p50_ms", "p99_ms")}

    st = router.stats()
    return {**strip(st), "per_shard": [strip(s) for s in st.get("per_shard", [])]}


def _admission(pkg):
    """One dispatcher, requests submitted one at a time: the chaos queue
    delay (half the requests, far past the deadline) decides which are
    shed as hopeless, in dequeue order."""
    chaos = pkg["Chaos"](seed=11, queue_delay_rate=0.5, queue_delay_ms=1e7)
    srv = pkg["serve"].PolicyServer(alpha=0.9, K=4, R=4)
    rungs, answers = [], []
    with pkg["serve"].AdmissionController(srv, workers=1, chaos=chaos) as adm:
        for k in range(16):
            res, meta = adm.submit(make_T(8, k % 5), deadline_ms=1e6, tenant=f"t{k % 5}")
            rungs.append(meta["rung"])
            answers.append(res)
    counts = (adm.stats.n_submitted, adm.stats.n_served, adm.stats.n_shed_hopeless,
              chaos.n_queue_delays)
    return rungs, answers, counts


def test_admission_shed_decisions_equal_jax():
    a_rungs, a_ans, a_counts = _admission(JAX)
    b_rungs, b_ans, b_counts = _admission(TORCH)
    assert a_rungs == b_rungs and a_counts == b_counts
    _answers_equal(a_ans, b_ans)
    assert "shed" in b_rungs and "fresh" in b_rungs
    assert b_counts[2] == b_counts[3] == b_rungs.count("shed")


@pytest.mark.parametrize("service_pkg,client_pkg", [(TORCH, JAX), (JAX, TORCH)],
                         ids=["jax-client-port-service", "port-client-jax-service"])
def test_rpc_across_packages(service_pkg, client_pkg):
    srv = service_pkg["serve"].PolicyServer(alpha=0.9, K=4, R=4)
    direct = client_pkg["serve"].PolicyServer(alpha=0.9, K=4, R=4)
    svc = service_pkg["serve"].PolicyService(srv).start()
    try:
        with client_pkg["serve"].PolicyClient(svc.address) as cli:
            assert cli.ping()
            for k, d in enumerate([None, ring_d(8), ring_d(8, extra=[(0, 4)])]):
                T = make_T(8, k)
                res, meta = cli.request(T, d=d, tenant=f"w{k}", want_meta=True)
                _answers_equal([res], [direct.request(T, d=d)])
                assert meta["rung"] == "fresh"
            dead = make_T(6, 1)
            dead[:] = np.inf
            np.fill_diagonal(dead, 0.0)
            assert not cli.request(dead).ok  # a non-finite answer crosses
            assert cli.stats()["serving"]["n_requests"] == 4
            cli.invalidate(np.ones((8, 8)) - np.eye(8))
    finally:
        svc.stop()
    assert srv.stats.n_invalidations == 1
