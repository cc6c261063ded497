"""The port's strategies and compression against the JAX package, on the CPU.

Inputs are drawn with numpy from a seed and handed to both packages.
Tolerances and why:

* host-side decisions — registry, reduction groups, peers, round and event
  timings — are the same numpy code drawing the same RNG streams: bit-equal;
* ``segment_mean_rows`` / ``reduce_groups_stacked``: a row alone in its
  segment passes through bit-exactly in both (0 + x, divided by 1.0); a
  group mean sums in each framework's order, so 1e-6;
* grad reductions (``global_mean_grads``, ``transform_grads``): 1e-6 (a mean
  over rows);
* ``topk_mask`` and the deterministic ``quantize_int8``: bit-equal, ties
  and zeros included (the kept set is the lower index on ties in both);
* ``randk_mask`` and stochastic rounding draw from a ``torch.Generator``,
  not a JAX key, so they are held to their laws: exactly k kept, the n / k
  rescale, the expectation, the clipping range.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.algos import get_algorithm as jget
from repro.algos import list_algorithms as jlist
from repro.algos.base import global_mean_grads as j_global_mean
from repro.core import compression as jcomp
from repro.core.nettime import LinkTimeModel as JLink
from repro.core.nettime import Topology as JTopo
from repro.kernels import ops as jops
from repro.train.simulator import SimConfig as JCfg
from repro_torch.algos import get_algorithm as tget
from repro_torch.algos import list_algorithms as tlist
from repro_torch.algos.base import global_mean_grads as t_global_mean
from repro_torch.core import compression as tcomp
from repro_torch.core.nettime import LinkTimeModel as TLink
from repro_torch.core.nettime import Topology as TTopo
from repro_torch.kernels import ops as tops
from repro_torch.train.simulator import SimConfig as TCfg
from repro_torch.tree import tree_leaves

NAMES = jlist()
SYNC = [n for n in NAMES if jget(n).synchronous]
ASYNC = [n for n in NAMES if not jget(n).synchronous]


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _bits(a):
    return np.asarray(_np(a), np.float32).view(np.uint32)


def test_registry_equals_jax():
    assert tlist() == jlist()
    assert len(tlist()) == 8
    for name in NAMES:
        j, t = jget(name), tget(name)
        assert (t.family, t.synchronous, t.reports_ema) == (j.family, j.synchronous,
                                                            j.reports_ema)
        assert t.supports_batched and j.supports_batched
        assert t.batched_variant == j.batched_variant
        assert t.supports_trainer == j.supports_trainer
        assert t.communicates_in_trainer == j.communicates_in_trainer
        assert t.wire_ratio() == j.wire_ratio()


def _links(M=8, seed=5):
    topo = dict(workers_per_host=4, hosts_per_pod=1)
    kw = dict(jitter=0.02, seed=seed, slow_interval=60.0)
    return (JLink(JTopo(n_workers=M, **topo), **kw),
            TLink(TTopo(n_workers=M, **topo), **kw))


@pytest.mark.parametrize("name", SYNC)
def test_select_groups_and_round_timing_bit_equal(name):
    M = 8
    j, t = jget(name), tget(name)
    jcfg, tcfg = JCfg(n_workers=M, prague_group=3), TCfg(n_workers=M, prague_group=3)
    js, ts = j.init_state(jcfg, M), t.init_state(tcfg, M)
    assert js.extras == ts.extras and js.rho == ts.rho
    jrng, trng = np.random.default_rng(3), np.random.default_rng(3)
    jl, tl = _links(M)
    now = 0.0
    for _ in range(20):
        jg, tg = j.select_groups(js, jrng), t.select_groups(ts, trng)
        assert jg == tg
        jt, tt = j.round_timing(js, jcfg, jl, jg, now), t.round_timing(ts, tcfg, tl, tg, now)
        assert (jt.duration, jt.comm, jt.compute, jt.net) == (
            tt.duration, tt.comm, tt.compute, tt.net)
        now += jt.duration


@pytest.mark.parametrize("name", ASYNC)
def test_select_peer_and_event_timing_bit_equal(name):
    M = 8
    j, t = jget(name), tget(name)
    jcfg, tcfg = JCfg(n_workers=M), TCfg(n_workers=M)
    js, ts = j.init_state(jcfg, M), t.init_state(tcfg, M)
    jrng, trng = np.random.default_rng(4), np.random.default_rng(4)
    jl, tl = _links(M)
    now = 0.0
    for ev in range(40):
        i = ev % M
        jm, tm = j.select_peer(js, i, jrng), t.select_peer(ts, i, trng)
        assert jm == tm
        comm = j.would_communicate(js, i, jm)
        assert comm == t.would_communicate(ts, i, tm)
        if jm is not None:
            assert j.mix_weight(js, jcfg, i, jm) == t.mix_weight(ts, tcfg, i, tm)
        jt = j.event_timing(js, jcfg, jl, i, jm, comm, now)
        tt = t.event_timing(ts, tcfg, tl, i, tm, comm, now)
        assert (jt.duration, jt.comm, jt.compute, jt.net) == (
            tt.duration, tt.comm, tt.compute, tt.net)
        now += 0.01
    if name == "ps-async":
        assert t.serial_row(ts) == j.serial_row(js) == 0


# ------------------------------------------------------- group averaging

GID_CASES = {
    "singletons": [0, 1, 2, 3, 4, 5, 6, 7],
    "one_group": [0] * 8,
    "prague": [0, 0, 2, 3, 0, 2, 6, 2],
}


@pytest.mark.parametrize("gid", list(GID_CASES), ids=list(GID_CASES))
def test_segment_mean_rows_matches_jax(gid):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 5, 3)).astype(np.float32)
    x[1, 0, :2] = -0.0  # 0 + (-0.0) is +0.0 in both
    g = np.asarray(GID_CASES[gid])
    want = np.asarray(jops.segment_mean_rows(jnp.asarray(x), jnp.asarray(g, jnp.int32), 8))
    got = tops.segment_mean_rows(torch.from_numpy(x), torch.from_numpy(g), 8).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    single = np.bincount(g, minlength=8)[g] == 1
    np.testing.assert_array_equal(_bits(got[single]), _bits(want[single]))
    np.testing.assert_array_equal(_bits(got[single]), _bits(x[single] + 0.0))


def _stacked_tree(rng, M=8):
    """A nested tree of stacked leaves, as numpy f32."""
    return {"embed": rng.standard_normal((M, 6)).astype(np.float32),
            "blocks": [{"w": rng.standard_normal((M, 3, 4)).astype(np.float32),
                        "b": rng.standard_normal((M, 4)).astype(np.float32)}]}


def _to(tree, fn):
    if isinstance(tree, dict):
        return {k: _to(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, fn) for v in tree]
    return fn(tree)


@pytest.mark.parametrize("name", SYNC)
def test_reduce_groups_stacked_and_per_replica_match_jax(name):
    rng = np.random.default_rng(1)
    x = _stacked_tree(rng)
    j, t = jget(name), tget(name)
    st = t.init_state(TCfg(n_workers=8), 8)
    groups = t.select_groups(st, np.random.default_rng(2))
    gid = np.arange(8)
    for grp in groups:
        if len(grp) >= 2:
            gid[grp] = min(grp)
    want = j.reduce_groups_stacked(_to(x, jnp.asarray), jnp.asarray(gid, jnp.int32))
    got = t.reduce_groups_stacked(_to(x, torch.from_numpy), torch.from_numpy(gid))
    for a, b in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-6, atol=1e-6)
    # The reference engine's per-replica form agrees with the stacked one.
    reps = [_to(x, lambda a, i=i: torch.from_numpy(a[i].copy())) for i in range(8)]
    t.reduce_groups(reps, groups)
    for i in range(8):
        for a, b in zip(tree_leaves(reps[i]), tree_leaves(got)):
            np.testing.assert_allclose(_np(a), _np(b)[i], rtol=1e-6, atol=1e-6)


def test_transform_grads_and_global_mean_match_jax():
    rng = np.random.default_rng(2)
    g = _stacked_tree(rng)
    jg, tg = _to(g, jnp.asarray), _to(g, torch.from_numpy)
    cases = [(j_global_mean(jg), t_global_mean(tg))]
    for name, kw in (("allreduce", {}), ("ps-sync", {}), ("prague", {"trainer_groups": 2}),
                     ("prague", {"trainer_groups": 1}), ("netmax", {})):
        cases.append((jget(name, **kw).transform_grads(jg, 8),
                      tget(name, **kw).transform_grads(tg, 8)))
    for want, got in cases:
        for a, b in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
            assert tuple(a.shape) == b.shape
            np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-6, atol=1e-6)
    # Identity for the gossip family, as in the JAX package.
    assert tget("netmax").transform_grads(tg, 8) is tg
    with pytest.raises(ValueError, match="not divisible"):
        tget("prague", trainer_groups=3).transform_grads(tg, 8)


# ------------------------------------------------------------ compression

def _tied(n=64, seed=0):
    """Magnitudes with ties (equal |x|, both signs) and exact zeros."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-4, 5, size=n).astype(np.float32) * 0.25
    x[::7] = 0.0
    x[3] = -0.0
    return x


@pytest.mark.parametrize("k", [1, 5, 17, 40, 63, 64, 100])
def test_topk_mask_bit_equal_with_ties_and_zeros(k):
    x = _tied()
    want = np.asarray(jcomp.topk_mask(jnp.asarray(x), k))
    got = tcomp.topk_mask(torch.from_numpy(x), k).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert (got != 0).sum() <= k


def test_topk_mask_under_vmap_bit_equal():
    rows = np.stack([_tied(48, s) for s in range(5)])
    rows[2] = 0.0  # all tied at zero
    want = np.asarray(jax.vmap(lambda r: jcomp.topk_mask(r, 9))(jnp.asarray(rows)))
    got = torch.func.vmap(lambda r: tcomp.topk_mask(r, 9))(torch.from_numpy(rows)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_netmax_topk_delta_transform_matches_jax_stacked():
    """The strategy's leaf rule on stacked rows (vmap of delta_transform)."""
    rng = np.random.default_rng(3)
    h = {"w": rng.standard_normal((4, 8, 5)).astype(np.float32),
         "b": rng.standard_normal((4, 5)).astype(np.float32)}
    p = {"w": np.round(rng.standard_normal((4, 8, 5)) * 2).astype(np.float32) / 2,
         "b": rng.standard_normal((4, 5)).astype(np.float32)}
    w = np.array([0.1, 0.5, 0.0, 0.9], np.float32)
    j, t = jget("netmax-topk", ratio=0.1), tget("netmax-topk", ratio=0.1)
    want = j.mix_stacked_tree(_to(h, jnp.asarray), _to(p, jnp.asarray), jnp.asarray(w))
    got = t.mix_stacked_tree(_to(h, torch.from_numpy), _to(p, torch.from_numpy),
                             torch.from_numpy(w))
    for a, b, h0 in zip(tree_leaves(got), jax.tree_util.tree_leaves(want), tree_leaves(h)):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-6, atol=1e-6)
        moved = (_np(a) != h0).reshape(4, -1).sum(-1)
        assert (moved <= max(1, int(0.1 * h0[0].size))).all()


def test_quantize_int8_deterministic_bit_equal():
    rng = np.random.default_rng(4)
    x = (rng.standard_normal(257) * 3).astype(np.float32)
    x[:4] = [0.0, -0.0, 127.5, -127.5]
    jq, js = jcomp.quantize_int8(jnp.asarray(x))
    tq, ts = tcomp.quantize_int8(torch.from_numpy(x))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_bits(ts), _bits(js))
    np.testing.assert_array_equal(_bits(tcomp.dequantize_int8(tq, ts)),
                                  _bits(jcomp.dequantize_int8(jq, js)))


def test_quantize_int8_stochastic_rounding_laws():
    x = torch.full((20000,), 0.3) * torch.linspace(-1, 1, 20000)
    x[0] = 1.0  # scale = 1 / 127
    q, scale = tcomp.quantize_int8(x, torch.Generator().manual_seed(0))
    assert q.dtype == torch.int8 and int(q.abs().max()) <= 127
    y = x / scale
    # Each code is floor(y) or floor(y) + 1, and unbiased on average.
    assert bool(((q.float() == torch.floor(y)) | (q.float() == torch.floor(y) + 1)).all())
    assert abs(float((q.float() - y).mean())) < 0.01


def test_randk_mask_laws():
    n, k = 1000, 37
    x = torch.arange(1, n + 1, dtype=torch.float32)
    g = torch.Generator().manual_seed(0)
    hits = torch.zeros(n)
    total = 0.0
    trials = 400
    for _ in range(trials):
        out = tcomp.randk_mask(x, k, g)
        nz = out != 0
        assert int(nz.sum()) == k
        torch.testing.assert_close(out[nz], x[nz] * (n / k))
        hits += nz
        total += float(out.sum())
    # Unbiased: E[sum(out)] = sum(x) (the mean of 400 sums is within ~0.5%
    # of it, one standard deviation), and every index is as likely as any.
    assert abs(total / trials / float(x.sum()) - 1) < 0.03
    assert abs(float(hits[: n // 2].sum() / hits[n // 2:].sum()) - 1) < 0.1
    assert torch.equal(tcomp.randk_mask(x, n, g), x)


@pytest.mark.parametrize("mode", ["topk", "randk"])
def test_error_feedback_round_trip_on_a_nested_tree(mode):
    rng = np.random.default_rng(5)
    tree = {"embed": torch.from_numpy(rng.standard_normal((4, 3)).astype(np.float32)),
            "blocks": [{"w": torch.from_numpy(rng.standard_normal((2, 5)).astype(np.float32))},
                       None, (torch.from_numpy(rng.standard_normal(7).astype(np.float32)),)]}
    ef = tcomp.ErrorFeedback(ratio=0.2, mode=mode)
    state = ef.init_state(tree)
    g = torch.Generator().manual_seed(1) if mode == "randk" else None
    sent, new_state = ef.compress(tree, state, g)
    for a, b, c in zip(tree_leaves(sent), tree_leaves(new_state), tree_leaves(tree)):
        assert a.shape == c.shape
        torch.testing.assert_close(a + b, c, rtol=0, atol=1e-6)
    n = sum(x.numel() for x in tree_leaves(tree))
    assert sum(int((x != 0).sum()) for x in tree_leaves(sent)) == max(1, int(0.2 * n))
    assert sent["blocks"][1] is None and isinstance(sent["blocks"][2], tuple)
    if mode == "topk":  # the same split as the JAX package's
        jtree = jax.tree_util.tree_map(lambda a: jnp.asarray(a.numpy()), tree)
        jef = jcomp.ErrorFeedback(ratio=0.2)
        jsent, jstate = jef.compress(jtree, jef.init_state(jtree))
        for a, b in zip(tree_leaves(sent), jax.tree_util.tree_leaves(jsent)):
            np.testing.assert_array_equal(_bits(a), _bits(b))
        for a, b in zip(tree_leaves(new_state), jax.tree_util.tree_leaves(jstate)):
            np.testing.assert_array_equal(_bits(a), _bits(b))
