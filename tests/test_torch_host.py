"""The port's host layer against the JAX package, and the port's isolation.

The host layer (link-time model, scenario timelines, Algorithm-3 policy
generation) was carried over as numpy copies, so on the same inputs it must
agree with the JAX package bit for bit: every comparison here is exact.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.core import policy as jpolicy
from repro.core.nettime import LinkTimeModel as JLink
from repro.core.nettime import Topology as JTopo
from repro.scenarios import timeline as jtl
from repro_torch.core import policy as tpolicy
from repro_torch.core.nettime import LinkTimeModel as TLink
from repro_torch.core.nettime import Topology as TTopo
from repro_torch.scenarios import timeline as ttl

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"


def _times(M, seed, dead=None):
    rng = np.random.default_rng(seed)
    base = rng.uniform(1.0, 3.0, size=(M, M))
    T = (base + base.T) / 2.0
    np.fill_diagonal(T, 1.0)
    if dead is not None:
        i, m = dead
        T[i, m] = T[m, i] = np.inf
    return T


def _assert_policy_equal(a, b):
    assert a.ok == b.ok
    np.testing.assert_array_equal(a.P, b.P)
    assert a.rho == b.rho and a.t_bar == b.t_bar
    assert a.n_pivots == b.n_pivots
    assert a.n_lp_solved == b.n_lp_solved and a.n_lp_feasible == b.n_lp_feasible


@pytest.mark.parametrize("M,dead", [(4, None), (8, None), (8, (0, 5)), (16, None)])
def test_policy_bit_equal_cold_and_warm(M, dead):
    K = R = 4 if M == 16 else 6
    T = _times(M, seed=M, dead=dead)
    cold_j = jpolicy.generate_policy_matrix(0.1, K, R, T)
    cold_t = tpolicy.generate_policy_matrix(0.1, K, R, T)
    _assert_policy_equal(cold_j, cold_t)
    assert cold_t.ok
    if dead is not None:
        assert cold_t.P[dead] == 0.0  # the dead link is never pulled
    # Warm start from each package's own previous basis, on drifted times.
    T2 = T * np.random.default_rng(M + 1).uniform(0.9, 1.1, size=T.shape)
    warm_j = jpolicy.generate_policy_matrix(0.1, K, R, T2, warm=cold_j.basis)
    warm_t = tpolicy.generate_policy_matrix(0.1, K, R, T2, warm=cold_t.basis)
    _assert_policy_equal(warm_j, warm_t)
    assert warm_t.n_warm_used == warm_j.n_warm_used > 0


def test_batched_policy_backend_jax_raises():
    T = _times(4, seed=0)
    with pytest.raises(ValueError, match="torch device backend"):
        tpolicy.generate_policy_matrix_batched(0.1, 2, 2, T, backend="jax")
    a = jpolicy.generate_policy_matrix_batched(0.1, 3, 3, T)
    b = tpolicy.generate_policy_matrix_batched(0.1, 3, 3, T)
    _assert_policy_equal(a, b)


def test_link_time_draws_equal():
    def run(Topo, Link):
        topo = Topo.multi_cluster(8, workers_per_host=2, hosts_per_pod=2,
                                  pods_per_cluster=1)
        link = Link(topo, jitter=0.05, seed=3, slow_interval=1.0,
                    wan_jitter=0.3, wan_asymmetry=0.2)
        rng = np.random.default_rng(7)
        out = []
        for k in range(300):
            i, m = (int(v) for v in rng.integers(0, 8, size=2))
            out.append(link.iteration_time(i, m, now=0.05 * k))
        out.append(link.matrix(now=20.0))
        return out

    a, b = run(JTopo, JLink), run(TTopo, TLink)
    for x, y in zip(a[:-1], b[:-1]):
        assert x == y
    np.testing.assert_array_equal(a[-1], b[-1])


def test_rescale_policy_bit_equal():
    """Elastic re-solve for a new membership, cold then warm from the old
    basis on a shrunk worker set (the solver rejects the stale shape)."""
    from repro.train import elastic as jel
    from repro_torch.train import elastic as tel

    T = _times(8, seed=11)
    a, b = jel.rescale_policy(0.1, T, K=4, R=4), tel.rescale_policy(0.1, T, K=4, R=4)
    _assert_policy_equal(a, b)
    T6 = T[:6, :6]
    _assert_policy_equal(jel.rescale_policy(0.1, T6, K=4, R=4, warm=a.basis),
                         tel.rescale_policy(0.1, T6, K=4, R=4, warm=b.basis))


@pytest.mark.parametrize("trace", [False, True])
def test_traced_round_timing_matches_jax(trace):
    """The round-timing pass-through and its trace capture (every link the
    round queries, dead links as "timeout", then the round record)."""
    from repro.algos.base import Timing as JTiming
    from repro.scenarios import ClusterOutage as JOutage
    from repro.scenarios import Timeline as JTimeline
    from repro.train import simulator as jsim
    from repro_torch.algos.base import Timing as TTiming
    from repro_torch.scenarios import ClusterOutage as TOutage
    from repro_torch.scenarios import Timeline as TTimeline
    from repro_torch.train import simulator as tsim

    def run(Topo, Link, Timeline, Outage, Timing, sim):
        class Round:
            def round_timing(self, state, cfg, link, groups, t):
                net = max(link.network_time(i, m, now=t) for g in groups
                          for i in g for m in g if i != m)
                return Timing(duration=net + 0.1, comm=net, compute=0.1)

        topo = Topo(8, workers_per_host=2, hosts_per_pod=2, pods_per_cluster=1)
        link = Link(topo, jitter=0.05, seed=3, dead_link_timeout=2.0,
                    scenario=Timeline([Outage(1, 1.0, 3.0)]))
        res = sim.SimResult()
        cfg = sim.SimConfig(trace=trace)
        out = [sim.traced_round_timing(Round(), None, cfg, link, [[0, 1, 4], [2, 6]],
                                       t, res) for t in (0.5, 1.5)]
        assert link.query_tap is None
        return [(x.duration, x.comm, x.compute) for x in out], res.trace_events

    got = run(TTopo, TLink, TTimeline, TOutage, TTiming, tsim)
    want = run(JTopo, JLink, JTimeline, JOutage, JTiming, jsim)
    assert got == want
    if trace:
        kinds = [e[4] for e in got[1]]
        assert kinds.count("round") == 2 and "timeout" in kinds
    else:
        assert got[1] == []


def _timeline(mod):
    return mod.Timeline([
        mod.ClusterOutage(1, 1.0, 3.0),
        mod.ClusterOutage(0, 4.0, 5.0, direction="out"),
        mod.LinkDegrade(0, 5, 0.5, 4.0, 8.0),
        mod.WorkerLeave(3, 1.5),
        mod.WorkerRejoin(3, 3.5),
    ])


def test_compiled_timelines_identical():
    a = _timeline(jtl).compile(JTopo(8, workers_per_host=2, hosts_per_pod=2,
                                     pods_per_cluster=1))
    b = _timeline(ttl).compile(TTopo(8, workers_per_host=2, hosts_per_pod=2,
                                     pods_per_cluster=1))
    assert a.n_workers == b.n_workers and a.boundaries == b.boundaries
    assert [(type(x).__name__, x.worker, x.time) for x in a.actions] == [
        (type(x).__name__, x.worker, x.time) for x in b.actions
    ]
    assert len(a.segments) == len(b.segments)
    for sa, sb in zip(a.segments, b.segments):
        assert sa.start == sb.start
        for f in ("dead_out", "dead_in", "wan_out", "wan_in", "cluster", "dead",
                  "degrade"):
            np.testing.assert_array_equal(getattr(sa, f), getattr(sb, f))
        assert sa.degrade_map == sb.degrade_map


def test_imports_without_jax():
    """The port runs with jax and the JAX package unimportable."""
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['repro'] = None\n"
        "import repro_torch, repro_torch.train.simulator, repro_torch.train.engine\n"
        "import repro_torch.kernels.ops, repro_torch.convert, repro_torch.algos\n"
        "import repro_torch.configs, repro_torch.models.lm, repro_torch.serve.engine\n"
        "import repro_torch.launch.serve, repro_torch.kernels.flash_attention\n"
        "import repro_torch.train.trainer, repro_torch.train.checkpoint, repro_torch.optim\n"
        "import repro_torch.launch.train, repro_torch.dist.gossip, repro_torch.data.loader\n"
        "import repro_torch.scenarios, repro_torch.core.matching, repro_torch.trace\n"
        "import repro_torch.serve.policy, repro_torch.serve.shard\n"
        "import repro_torch.serve.admission, repro_torch.serve.rpc\n"
        "import repro_torch.solver.batch_torch\n"
        "from repro_torch.configs.base import all_archs; assert len(all_archs()) == 10\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_never_imports_jax_or_repro(path):
    bad = [m for m in _imports(path)
           if m == "jax" or m.startswith("jax.") or m == "repro"
           or m.startswith("repro.")]
    assert not bad, f"{path}: imports {bad}"
