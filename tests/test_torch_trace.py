"""The port's ``trace`` package against the JAX package's.

``trace/*`` is numpy-only, copied; ``whatif`` drives the port's
``simulate`` (``device="cpu"`` here, with the JAX package's initial MLP as
``init_params``).  Held bit for bit: the JSONL bytes of a run at the
committed fixture's configuration (``scripts/make_trace_fixture.py``)
against the JAX package's *current* output -- the committed fixture
predates the optional ``net`` field of async records, so it is only read
here, by both packages, to equal records -- calibration on the fixture,
the Chrome-trace export, a CSV ingest, a replay's event stream and
virtual times, and a what-if answer's virtual times; a what-if's losses
within 5e-4 (two frameworks' f32 matmuls).  ``python -m repro_torch.trace``
prints what ``python -m repro.trace`` prints.  Each JAX simulation runs
once per module.
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np

import repro.trace as jtrace
import repro_torch.trace as ttrace
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

REPO = Path(__file__).resolve().parents[1]
FIXTURE = REPO / "tests" / "fixtures" / "trace_hetero_M8.jsonl"
LOSS_TOL = 5e-4
M = 8

JAX = dict(Topo=JTopo, Link=JLink, sim=jsim, Timeline=JTimeline, Outage=JOutage,
           trace=jtrace)
TORCH = dict(Topo=TTopo, Link=TLink, sim=tsim, Timeline=TTimeline, Outage=TOutage,
             trace=ttrace)


@functools.lru_cache(maxsize=None)
def _data():
    x, y, ex, ey = train_eval_split(1600, 400, 32, 10, seed=0)
    return x, y, uniform_partition(len(y), M, seed=0), ex, ey


def _init_kw(pkg, cfg):
    if pkg is JAX:
        return {}
    x = _data()[0]
    p0 = jsim.mlp_init(jax.random.PRNGKey(cfg.seed), [x.shape[1], 128, 64, 10])
    return dict(init_params=params_from_jax(p0), device="cpu")


def _topo(pkg):
    return pkg["Topo"].multi_cluster(M, workers_per_host=2, hosts_per_pod=1,
                                     pods_per_cluster=2)  # 2 clusters of 4


def _fixture_run(pkg):
    """scripts/make_trace_fixture.py's configuration in ``pkg``."""
    link = pkg["Link"](_topo(pkg), jitter=0.05, seed=5,
                       scenario=pkg["Timeline"]([pkg["Outage"](1, 2.0, 4.0)]),
                       dead_link_timeout=2.0)
    cfg = pkg["sim"].SimConfig(algorithm="netmax", n_workers=M, total_events=600,
                               lr=0.05, monitor_period=1.5, seed=0, trace=True)
    res = pkg["sim"].simulate(cfg, link, *_data(), record_every=200, **_init_kw(pkg, cfg))
    return res, pkg["trace"].from_sim_result(res, cfg=cfg, link_model=link)


@functools.lru_cache(maxsize=None)
def _jax_fixture_run():
    return _fixture_run(JAX)


@functools.lru_cache(maxsize=None)
def _torch_fixture_run():
    return _fixture_run(TORCH)


def test_fixture_configuration_trace_bytes_equal_jax(tmp_path):
    jres, jtr = _jax_fixture_run()
    tres, ttr = _torch_fixture_run()
    assert tres.failed_pulls == jres.failed_pulls and tres.failed_pulls
    jtrace.write_jsonl(jtr, tmp_path / "jax.jsonl")
    ttrace.write_jsonl(ttr, tmp_path / "torch.jsonl")
    a = (tmp_path / "jax.jsonl").read_bytes()
    b = (tmp_path / "torch.jsonl").read_bytes()
    assert a == b
    # The current output carries the async records' ``net`` field, which
    # the committed fixture predates.
    assert any(r.net is not None for r in ttr.records)
    assert a != FIXTURE.read_bytes()
    back = ttrace.read_jsonl(tmp_path / "torch.jsonl")
    assert back.records == ttr.records and back.meta == ttr.meta


def _record_tuples(tr):
    return [dataclasses.astuple(r) for r in tr.records]


def test_committed_fixture_loads_to_equal_records():
    a, b = jtrace.load_trace(FIXTURE), ttrace.load_trace(FIXTURE)
    assert _record_tuples(a) == _record_tuples(b) and b.records
    assert a.meta == b.meta and a.horizon == b.horizon
    assert a.counts() == b.counts() and b.counts()["timeout"] > 0
    assert all(r.net is None for r in b.records)
    assert dataclasses.astuple(a.topology()) == dataclasses.astuple(b.topology())


def test_calibration_on_fixture_equals_jax():
    a = jtrace.calibrate(jtrace.load_trace(FIXTURE))
    b = ttrace.calibrate(ttrace.load_trace(FIXTURE))
    assert a.compute_time == b.compute_time and a.base_times == b.base_times
    assert a.jitter == b.jitter and a.residual == b.residual
    assert a.n_pulls == b.n_pulls and a.censored_tiers == b.censored_tiers
    assert a.per_link_median == b.per_link_median
    np.testing.assert_array_equal(a.link_scale, b.link_scale)
    assert a.summary() == b.summary()


def test_chrome_trace_and_csv_equal_jax(tmp_path):
    _, jtr = _jax_fixture_run()
    _, ttr = _torch_fixture_run()
    assert (json.dumps(jtrace.chrome_trace(jtr), sort_keys=True)
            == json.dumps(ttrace.chrome_trace(ttr), sort_keys=True))
    p = tmp_path / "measured.csv"
    p.write_text("t_start,duration,src,dst,kind\n0.0,0.5,0,1,pull\n"
                 "0.2,0.012,1,-1,local\n1.0,2.0,1,0,timeout\n")
    assert _record_tuples(jtrace.read_csv(p)) == _record_tuples(ttrace.read_csv(p))


def _session(pkg):
    """tests/test_trace.py's what-if session: a traced adpsgd run, its
    calibration and the replayed baseline."""
    link = pkg["Link"](_topo(pkg), jitter=0.05, seed=5)
    cfg = pkg["sim"].SimConfig(algorithm="adpsgd", n_workers=M, total_events=500,
                               lr=0.05, monitor_period=4.0, seed=0, trace=True)
    kw = _init_kw(pkg, cfg)
    res = pkg["sim"].simulate(cfg, link, *_data(), record_every=125, **kw)
    tr = pkg["trace"].from_sim_result(res, cfg=cfg, link_model=link)
    session = pkg["trace"].WhatIf(tr, pkg["trace"].calibrate(tr), cfg, _data(),
                                  record_every=125, **kw)
    return res, session, session.query(pkg["trace"].UpgradeLink(0, 4, speedup=4.0))


@functools.lru_cache(maxsize=None)
def _jax_session():
    return _session(JAX)


def test_replay_and_whatif_equal_jax():
    jres, jses, jrep = _jax_session()
    tres, tses, trep = _session(TORCH)
    assert tres.trace_events == jres.trace_events
    # The replayed baseline: the same event stream as the measured run, in
    # both packages.
    assert tses.baseline.times == jses.baseline.times
    assert tses.baseline.trace_events == tres.trace_events
    assert trep.mutation == jrep.mutation
    for f in ("baseline_wall_clock", "mutated_wall_clock", "baseline_time_to_loss",
              "mutated_time_to_loss"):
        assert getattr(trep, f) == getattr(jrep, f), f
    assert trep.wall_clock_speedup > 1.0
    np.testing.assert_allclose(
        [trep.target_loss, trep.baseline_final_loss, trep.mutated_final_loss],
        [jrep.target_loss, jrep.baseline_final_loss, jrep.mutated_final_loss],
        rtol=LOSS_TOL, atol=LOSS_TOL)


def test_replay_model_falls_back_like_jax():
    """Past the trace's horizon the replay prices links with the calibrated
    model; both packages draw the same times."""
    tr_j, tr_t = jtrace.load_trace(FIXTURE), ttrace.load_trace(FIXTURE)
    mj = jtrace.replay_model(tr_j, jtrace.calibrate(tr_j))
    mt = ttrace.replay_model(tr_t, ttrace.calibrate(tr_t))
    rng = np.random.default_rng(0)
    pairs = [tuple(rng.choice(M, 2, replace=False)) for _ in range(300)]
    ta = [mj.network_time(int(i), int(m), 0.01 * k) for k, (i, m) in enumerate(pairs)]
    tb = [mt.network_time(int(i), int(m), 0.01 * k) for k, (i, m) in enumerate(pairs)]
    assert ta == tb


def test_cli_prints_what_the_jax_cli_prints():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    out = {}
    for mod in ("repro.trace", "repro_torch.trace"):
        p = subprocess.run([sys.executable, "-m", mod, str(FIXTURE), "--top", "3"],
                           env=env, cwd=REPO, capture_output=True, text=True,
                           timeout=120)
        assert p.returncode == 0, p.stderr
        out[mod] = p.stdout
    assert out["repro.trace"] == out["repro_torch.trace"]
    assert "timeouts" in out["repro_torch.trace"]
