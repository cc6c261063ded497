"""The port's training slice against the JAX package, on the CPU.

Inputs are drawn with numpy from a seed (or taken from the JAX package's
initialisers and carried across with ``convert``) and handed to both
packages.  Tolerances: the optimizers 1e-6 (the same f32 elementwise steps;
XLA's and torch's ``pow`` and ``sqrt`` may differ by an ulp), the attention
gradient 1e-5, the loss and its grads 1e-4, the trainer's per-round losses
1e-4 and its final params 1e-4 x max |param| (reduced f32 configs: the two
packages sum matmuls in different orders); pulls, the mix, the
consensus rounds on identical inputs, checkpoints and elastic membership
changes exactly.  JAX steps are jitted once per module (module-scoped
fixtures).
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.algos import get_algorithm as jalgo
from repro.configs.base import get_arch as jget
from repro.core import consensus as jcons
from repro.data.synthetic import TokenStream
from repro.dist import gossip as jgossip
from repro.models import attention as jattn
from repro.models import lm as jlm
from repro.models.scan_utils import microbatch_scan as jmicro
from repro.optim import optimizers as jopt
from repro.train import checkpoint as jckpt
from repro.train import elastic as jel
from repro.train import trainer as jtr
from repro_torch.algos import get_algorithm as talgo
from repro_torch.configs.base import get_arch as tget
from repro_torch.convert import lm_params_from_jax, opt_state_from_jax
from repro_torch.core import consensus as tcons
from repro_torch.data.loader import StackedLoader
from repro_torch.dist import gossip as tgossip
from repro_torch.launch import train as tlaunch
from repro_torch.models import attention as tattn
from repro_torch.models import lm as tlm
from repro_torch.models.scan_utils import microbatch_scan as tmicro
from repro_torch.optim import optimizers as topt
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import elastic as tel
from repro_torch.train import trainer as ttr
from repro_torch.tree import tree_leaves, tree_map

M = 4
ROUNDS = 5
LR = 0.05


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's steps here run at tiny widths on the CPU, where torch's
    intra-op threads gain nothing and contend with the other test workers'
    (the file ran ~8x slower under the full suite's workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    """A tensor or JAX array -> numpy (bf16 as its f32 value)."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy() if x.dtype == torch.bfloat16 else x.detach().numpy()
    return np.asarray(x, dtype=np.float32) if x.dtype == jnp.bfloat16 else np.asarray(x)


def _tree_np(tree):
    """Leaves of a JAX or a port tree (tensors are leaves to JAX, and both
    packages order dict keys sorted), as numpy."""
    return [_np(x) for x in jax.tree_util.tree_leaves(tree)]


def _max_err(a, b):
    return max((float(np.abs(x.astype(np.float64) - y).max()) for x, y in
                zip(_tree_np(a), _tree_np(b))), default=0.0)


def _tiny(get_arch, **kw):
    return replace(get_arch("tinyllama-1.1b").reduced(), vocab_size=256, n_layers=2,
                   d_model=64, **kw)


def _random_tree(seed, shapes=((4, 3, 5), (4, 7), (4,))):
    rng = np.random.default_rng(seed)
    return {f"l{i}": rng.standard_normal(s).astype(np.float32) for i, s in enumerate(shapes)}


# ------------------------------------------------------------------ optimizers

OPTIMIZERS = {
    "sgd-plain": dict(kind="sgd", momentum=0.0),
    "sgd-momentum": dict(kind="sgd", momentum=0.9),
    "sgd-nesterov": dict(kind="sgd", momentum=0.9, nesterov=True),
    "sgd-wd": dict(kind="sgd", momentum=0.9, weight_decay=1e-4),
    "sgd-plain-wd": dict(kind="sgd", momentum=0.0, weight_decay=0.01),
    "adamw": dict(kind="adamw"),
    "adamw-no-wd": dict(kind="adamw", weight_decay=0.0),
}


def _make_opts(spec):
    kw = {k: v for k, v in spec.items() if k != "kind"}
    return getattr(jopt, spec["kind"])(**kw), getattr(topt, spec["kind"])(**kw)


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_matches_jax(name):
    jo, to = _make_opts(OPTIMIZERS[name])
    params = _random_tree(0)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    js, ts = jo.init(jp), to.init(tp)
    assert _max_err(js, ts) == 0.0
    for step in range(3):
        g = _random_tree(10 + step)
        ju, js = jo.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp, jnp.float32(0.1))
        tu, ts = to.update({k: torch.from_numpy(v) for k, v in g.items()}, ts, tp,
                           np.float32(0.1))
        jp, tp = jo.apply(jp, ju), to.apply(tp, tu)
        assert _max_err(ju, tu) <= 1e-6
        assert _max_err(js, ts) <= 1e-6
        assert _max_err(jp, tp) <= 1e-6
    if "t" in js:
        assert int(ts["t"]) == int(js["t"]) == 3 and ts["t"].dtype == torch.int32


def test_optimizer_apply_casts_back_to_bf16():
    _, to = _make_opts(OPTIMIZERS["sgd-momentum"])
    p = {"w": torch.ones(3, dtype=torch.bfloat16)}
    out = to.apply(p, {"w": torch.full((3,), 1e-3)})
    assert out["w"].dtype == torch.bfloat16
    jout = jopt.Optimizer(None, None).apply({"w": jnp.ones(3, jnp.bfloat16)},
                                            {"w": jnp.full((3,), 1e-3)})
    np.testing.assert_array_equal(_np(out["w"]), _np(jout["w"]))


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_jax(max_norm):
    g = _random_tree(3)
    jg, jn = jopt.clip_by_global_norm({k: jnp.asarray(v) for k, v in g.items()}, max_norm)
    tg, tn = topt.clip_by_global_norm({k: torch.from_numpy(v) for k, v in g.items()},
                                      max_norm)
    assert abs(float(jn) - float(tn)) <= 1e-6 * float(jn)
    assert _max_err(jg, tg) <= 1e-6


# ------------------------------------------------------------------ loss


@pytest.mark.parametrize("masked", [False, True])
def test_chunked_ce_loss_matches_jax(masked):
    rng = np.random.default_rng(1)
    B, S, D, V = 2, 24, 16, 50
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    w = rng.standard_normal((D, V)).astype(np.float32)
    labels = rng.integers(0, V, size=(B, S)).astype(np.int32)
    mask = (rng.random((B, S)) < 0.7).astype(np.float32) if masked else None
    want = jlm.chunked_ce_loss(jnp.asarray(x), jnp.asarray(w), jnp.asarray(labels),
                               None if mask is None else jnp.asarray(mask), chunk=8)
    got = tlm.chunked_ce_loss(torch.from_numpy(x), torch.from_numpy(w),
                              torch.from_numpy(labels),
                              None if mask is None else torch.from_numpy(mask), chunk=8)
    assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))


ATTN_GRAD_CASES = [
    # (B, S, Sk, H, Hk, hd, causal, q_chunk, kv_chunk)
    (1, 32, 32, 4, 2, 16, True, 8, 16),
    (2, 16, 32, 8, 2, 16, True, 16, 8),
    (1, 24, 16, 4, 1, 8, False, 8, 8),
]


@pytest.mark.parametrize("case", ATTN_GRAD_CASES, ids=lambda c: "-".join(map(str, c)))
def test_attention_gradient_matches_jax(case):
    """The port's CPU attention under autograd against jax.grad of the JAX
    scan (the same function; the card's backward kernel is held to the
    port's plain version in tests/test_torch_cuda.py)."""
    B, S, Sk, H, Hk, hd, causal, qc, kc = case
    rng = np.random.default_rng(2)
    q, dout = (rng.standard_normal((B, S, H, hd)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((B, Sk, Hk, hd)).astype(np.float32) for _ in range(2))

    def jloss(q, k, v):
        o = jattn.chunked_attention(q, k, v, causal=causal, q_chunk=qc, kv_chunk=kc)
        return jnp.sum(o * dout)

    want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tattn.chunked_attention(tq, tk, tv, causal=causal, q_chunk=qc, kv_chunk=kc)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(dout))
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def lm_setup():
    jcfg = _tiny(jget)
    params = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    stream = TokenStream(vocab_size=256, seq_len=32, batch_size=2, seed=0)
    batch = stream.batch(0, 0)
    return jcfg, params, batch


@pytest.mark.parametrize("remat", [False, True])
def test_loss_fn_value_and_grads_match_jax(lm_setup, remat):
    jcfg, jparams, batch = lm_setup
    jcfg = replace(jcfg, remat=remat)
    tcfg = _tiny(tget, remat=remat)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jl, jg = jax.jit(jax.value_and_grad(jlm.loss_fn), static_argnums=2)(jparams, jb, jcfg)
    tp = tree_map(lambda t: t.requires_grad_(), lm_params_from_jax(jparams))
    tl = tlm.loss_fn(tp, {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg)
    tg = torch.autograd.grad(tl, tree_leaves(tp))
    assert abs(float(tl.detach()) - float(jl)) <= 1e-4
    scale = max(float(np.abs(g).max()) for g in _tree_np(jg))
    assert _max_err(jg, tg) <= 1e-4 * max(scale, 1.0)


def test_microbatch_scan_matches_jax():
    rng = np.random.default_rng(4)
    w = rng.standard_normal((M, 3)).astype(np.float32)
    x = rng.standard_normal((M, 6, 3)).astype(np.float32)

    def jgrad(p, b):
        def one(wi, xi):
            return jnp.mean((xi @ wi) ** 2)
        return jax.vmap(jax.value_and_grad(one))(p["w"], b["x"]), None

    def jfn(p, b):
        (l, g), _ = jgrad(p, b)
        return l, {"w": g}

    def tfn(p, b):
        wt = p["w"].clone().requires_grad_()
        losses = ((b["x"] @ wt[..., None])[..., 0] ** 2).mean(dim=1)
        (g,) = torch.autograd.grad(losses.sum(), wt)
        return losses.detach(), {"w": g}

    for n_micro in (1, 2, 3, 8):
        if 6 % min(n_micro, 6):
            with pytest.raises(ValueError):
                tmicro(tfn, {"w": torch.from_numpy(w)}, {"x": torch.from_numpy(x)}, n_micro)
            continue
        jl, jg = jmicro(jfn, {"w": jnp.asarray(w)}, {"x": jnp.asarray(x)}, n_micro)
        tl, tg = tmicro(tfn, {"w": torch.from_numpy(w)}, {"x": torch.from_numpy(x)}, n_micro)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(tg["w"].numpy(), np.asarray(jg["w"]), rtol=1e-6, atol=1e-6)
        if min(n_micro, 6) > 1:
            assert tg["w"].dtype == torch.float32


# ------------------------------------------------------------------ gossip and consensus


#: Against the JAX package's jitted strategy methods (``mix_stacked``,
#: ``stacked_round``), where XLA may fuse h + w (p - h) into a multiply-add
#: (f32: an ulp) and round a fused bf16 chain once (bf16: one bf16 ulp of
#: values below 2).
JIT_TOL = {"float32": 1e-6, "bfloat16": 1e-2}


def _stacked(seed):
    return _random_tree(seed, shapes=((M, 3, 5), (M, 7), (M,)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pulls_and_mix_bit_equal_to_jax(dtype):
    tree = _stacked(5)
    jt = {k: jnp.asarray(v).astype(dtype) for k, v in tree.items()}
    tt = {k: torch.from_numpy(v).to(getattr(torch, dtype)) for k, v in tree.items()}
    nb = np.array([2, 0, 3, 3], np.int32)
    for jpull, tpull in ((jgossip.pull_gather(jt, jnp.asarray(nb)),
                          tgossip.pull_gather(tt, nb)),
                         (jgossip.pull_masked_psum(jt, jnp.asarray(nb), M),
                          tgossip.pull_masked_psum(tt, nb, M))):
        assert all(b.dtype == getattr(torch, dtype) for b in tree_leaves(tpull))
        assert _max_err(jpull, tpull) == 0.0
    w = np.array([0.1, 0.4, 0.0, 0.25], np.float32)
    half = _stacked(6)
    jh = {k: jnp.asarray(v).astype(dtype) for k, v in half.items()}
    th = {k: torch.from_numpy(v).to(getattr(torch, dtype)) for k, v in half.items()}
    jm = jgossip.mix(jh, jt, jnp.asarray(w))
    tm = tgossip.mix(th, tt, torch.from_numpy(w))
    assert _max_err(jm, tm) == 0.0
    # The strategy's leaf rule h + w (p - h): jitted in the JAX package, where
    # XLA may contract it into a fused multiply-add (one rounding fewer).
    ja = jalgo("netmax").mix_stacked(jh, jt, jnp.asarray(w))
    ta = talgo("netmax").mix_stacked(th, tt, torch.from_numpy(w))
    assert _max_err(ja, ta) <= JIT_TOL[dtype]


def test_pull_ppermute_raises():
    """With no worker axes pull_ppermute is pull_gather (the JAX package's
    ``:61-62``); across ranks it is held to the JAX package in
    tests/test_torch_dist.py."""
    tree = {k: torch.from_numpy(v) for k, v in _stacked(3).items()}
    nb = (2, 0, 3, 1)
    want = tgossip.pull_gather(tree, nb)
    for got in (tgossip.pull_ppermute(tree, nb, None, ()),
                tgossip.pull_ppermute(tree, nb, {"data": 1}, ())):
        assert _max_err(want, got) == 0.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_consensus_rounds_match_jax(dtype):
    p, g, pulled = _stacked(7), _stacked(8), _stacked(9)
    to_j = lambda t: {k: jnp.asarray(v).astype(dtype) for k, v in t.items()}  # noqa: E731
    to_t = lambda t: {k: torch.from_numpy(v).to(getattr(torch, dtype))  # noqa: E731
                      for k, v in t.items()}
    nb = np.array([1, 1, 3, 0], np.int32)
    w = np.array([0.3, 0.0, 0.2, 0.5], np.float32)
    alpha = 0.05
    assert _max_err(jcons.two_step_update(to_j(p), to_j(g), to_j(pulled), alpha, 0.3),
                    tcons.two_step_update(to_t(p), to_t(g), to_t(pulled), alpha, 0.3)) == 0.0
    jr = jcons.stacked_round(to_j(p), to_j(g), jnp.asarray(nb), jnp.asarray(w), alpha)
    tr = tcons.stacked_round(to_t(p), to_t(g), nb, torch.from_numpy(w), alpha)
    assert [a.dtype for a in tree_leaves(tr)] == [torch.float32] * 3  # f32 weights promote
    assert _max_err(jr, tr) == 0.0
    ja = jalgo("netmax").stacked_round(to_j(p), to_j(g), jnp.asarray(nb), jnp.asarray(w), alpha)
    ta = talgo("netmax").stacked_round(to_t(p), to_t(g), nb, torch.from_numpy(w), alpha)
    assert [a.dtype for a in tree_leaves(ta)] == [getattr(torch, dtype)] * 3
    assert _max_err(ja, ta) <= JIT_TOL[dtype]


# ------------------------------------------------------------------ the trainer

MODES = {
    "netmax-gather": dict(step=dict(gossip_mode="gather")),
    "netmax-masked_psum": dict(step=dict(gossip_mode="masked_psum")),
    "netmax-mix-kernel": dict(step=dict(gossip_mode="gather", use_gossip_mix_kernel=True)),
    "allreduce": dict(algo="allreduce"),
    "prague": dict(algo="prague"),
    "microbatches-1-remat": dict(cfg=dict(microbatches=1, remat=True)),
    "grad-clip": dict(step=dict(grad_clip=0.5)),
    # AdamW at an AdamW learning rate, with eps above the grads' f32 noise:
    # its step g / (|g| + eps) turns a 1e-10 difference in a grad near eps
    # (this tiny model has grads of 1e-8) into a difference of order lr,
    # and at lr 0.05 every param moves by ~lr a round, which amplifies it.
    # The update itself is held at 1e-6 with the default eps above.
    "adamw": dict(opt="adamw", lr=1e-3, eps=1e-6),
}


def _algos(name):
    if name == "prague":
        return jalgo("prague", trainer_groups=2), talgo("prague", trainer_groups=2)
    return name, name


def _stream():
    return TokenStream(vocab_size=256, seq_len=32, batch_size=4, seed=0)


def _round_inputs(stream, rng, r, lr=LR):
    d = np.ones((M, M)) - np.eye(M)
    P = np.where(d > 0, 1.0 / (M - 1), 0.0)
    rho = 0.5 / (2 * lr * (M - 1))
    batch = {k: np.stack([stream.batch(w, r)[k] for w in range(M)])
             for k in ("tokens", "labels")}
    nb, wts = jcons.sample_round(rng, P, lr, rho, d)
    return batch, nb, wts


def _opt(pkg, spec):
    if spec.get("opt") == "adamw":
        return pkg.adamw(eps=spec["eps"])
    return pkg.sgd(momentum=0.9)


def _jax_run(mode, rounds=ROUNDS):
    """(params, opt_state, losses, initial params, initial opt state) of the
    JAX trainer."""
    spec = MODES[mode]
    cfg = _tiny(jget, **spec.get("cfg", {}))
    opt, lr = _opt(jopt, spec), spec.get("lr", LR)
    algo = _algos(spec.get("algo", "netmax"))[0]
    step = jax.jit(jtr.make_train_step(cfg, opt, M, algo,
                                       step_cfg=jtr.TrainStepConfig(**spec.get("step", {}))))
    params, opt_state = jtr.init_stacked(cfg, opt, M, jax.random.PRNGKey(0))
    init = (params, opt_state)
    stream, rng = _stream(), np.random.default_rng(0)
    losses = []
    for r in range(rounds):
        batch, nb, wts = _round_inputs(stream, rng, r, lr)
        params, opt_state, m = step(params, opt_state,
                                    {k: jnp.asarray(v) for k, v in batch.items()},
                                    {"neighbors": jnp.asarray(nb), "weights": jnp.asarray(wts),
                                     "lr": jnp.float32(lr)})
        losses.append(np.asarray(m["loss_per_worker"]))
    return params, opt_state, losses, init


def _torch_run(mode, init, rounds=ROUNDS, start=0, state=None):
    spec = MODES[mode]
    cfg = _tiny(tget, **spec.get("cfg", {}))
    opt, lr = _opt(topt, spec), spec.get("lr", LR)
    algo = _algos(spec.get("algo", "netmax"))[1]
    step = ttr.make_train_step(cfg, opt, M, algo,
                               step_cfg=ttr.TrainStepConfig(**spec.get("step", {})))
    if state is None:
        params, opt_state = lm_params_from_jax(init[0]), opt_state_from_jax(init[1])
    else:
        params, opt_state = state
    stream, rng = _stream(), np.random.default_rng(0)
    losses = []
    for r in range(rounds):
        batch, nb, wts = _round_inputs(stream, rng, r, lr)
        if r < start:
            continue
        params, opt_state, m = step(params, opt_state,
                                    {k: torch.from_numpy(v).long() for k, v in batch.items()},
                                    {"neighbors": nb, "weights": wts, "lr": np.float32(lr)})
        assert m["loss_per_worker"].shape == (M,)
        assert float(m["loss"]) == pytest.approx(float(m["loss_per_worker"].mean()))
        losses.append(m["loss_per_worker"].numpy())
    return params, opt_state, losses


@pytest.fixture(scope="module")
def jax_runs():
    cache = {}

    def get(mode):
        if mode not in cache:
            cache[mode] = _jax_run(mode)
        return cache[mode]

    return get


@pytest.mark.parametrize("mode", list(MODES))
def test_train_step_matches_jax(jax_runs, mode):
    jp, jo, jlosses, init = jax_runs(mode)
    tp, to, tlosses = _torch_run(mode, init)
    for r, (a, b) in enumerate(zip(jlosses, tlosses)):
        np.testing.assert_allclose(b, a, atol=1e-4, rtol=0, err_msg=f"round {r}")
    scale = max(float(np.abs(x).max()) for x in _tree_np(jp))
    assert _max_err(jp, tp) <= 1e-4 * scale
    assert _max_err(jo, to) <= 1e-4 * max(float(np.abs(x).max()) for x in _tree_np(jo))
    assert np.mean(tlosses[-1]) < np.mean(tlosses[0]) + 0.1  # sane, not diverging


def test_fused_mix_only_for_the_identity_delta(monkeypatch):
    """use_gossip_mix_kernel takes the tree mix for netmax and the strategy's
    own mix for a compressing one, as the JAX trainer decides."""
    from repro_torch.kernels import ops

    calls = []
    real = ops.gossip_mix_tree
    monkeypatch.setattr(ops, "gossip_mix_tree", lambda *a: calls.append(1) or real(*a))
    cfg = _tiny(tget)
    opt = topt.sgd(momentum=0.9)
    params, opt_state = ttr.init_stacked(cfg, opt, M, torch.Generator().manual_seed(0))
    batch, nb, wts = _round_inputs(_stream(), np.random.default_rng(0), 0)
    b = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    gi = {"neighbors": nb, "weights": wts, "lr": LR}
    for algo, want in (("netmax", 1), ("netmax-topk", 0)):
        calls.clear()
        step = ttr.make_train_step(cfg, opt, M, algo,
                                   ttr.TrainStepConfig(use_gossip_mix_kernel=True))
        step(params, opt_state, b, gi)
        assert len(calls) == want, algo


def test_legacy_shim_warnings_and_conflict():
    cfg = _tiny(tget)
    opt = topt.sgd()
    with pytest.warns(DeprecationWarning, match="allreduce"):
        assert ttr.resolve_algorithm(None, ttr.TrainStepConfig(allreduce=True)).name == "allreduce"
    with pytest.warns(DeprecationWarning, match="prague_groups"):
        a = ttr.resolve_algorithm(None, ttr.TrainStepConfig(prague_groups=2))
    assert a.name == "prague" and a.trainer_groups == 2
    with pytest.raises(ValueError, match="conflicting"):
        ttr.make_train_step(cfg, opt, M, "netmax", ttr.TrainStepConfig(allreduce=True))
    with pytest.warns(DeprecationWarning):
        ttr.make_train_step(cfg, opt, M, ttr.TrainStepConfig(allreduce=True))
    with pytest.raises(NotImplementedError, match="ps-async"):
        ttr.make_train_step(cfg, opt, M, "ps-async")
    assert ttr.resolve_algorithm(None, ttr.TrainStepConfig()).name == "netmax"


def test_init_and_abstract_stacked_match_jax():
    jcfg, tcfg = _tiny(jget), _tiny(tget)
    for jo, to in (_make_opts(OPTIMIZERS["sgd-momentum"]), _make_opts(OPTIMIZERS["adamw"])):
        jp, jst = jtr.abstract_stacked(jcfg, jo, M)
        tp, tst = ttr.abstract_stacked(tcfg, to, M)
        assert all(t.device.type == "meta" for t in tree_leaves(tp))
        for jt, tt in ((jp, tp), (jst, tst)):
            assert [tuple(x.shape) for x in jax.tree_util.tree_leaves(jt)] == \
                [tuple(x.shape) for x in tree_leaves(tt)]
        params, state = ttr.init_stacked(tcfg, to, M, torch.Generator().manual_seed(0))
        for leaf in tree_leaves(params):
            assert torch.equal(leaf[0], leaf[-1])
            assert leaf.is_contiguous()
    if not torch.cuda.is_available():  # CUDA by default, and no card here
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ttr.init_stacked(tcfg, topt.sgd(), M)


def test_ssm_round_matches_jax():
    """One round of the ssm family (rwkv6-7b reduced) on the CPU."""
    jcfg = jget("rwkv6-7b").reduced()
    tcfg = tget("rwkv6-7b").reduced()
    jopt_, topt_ = jopt.sgd(momentum=0.9), topt.sgd(momentum=0.9)
    jp, jo = jtr.init_stacked(jcfg, jopt_, 2, jax.random.PRNGKey(0))
    tp, to = lm_params_from_jax(jp), opt_state_from_jax(jo)
    stream = TokenStream(vocab_size=jcfg.vocab_size, seq_len=16, batch_size=2, seed=0)
    batch = {k: np.stack([stream.batch(w, 0)[k] for w in range(2)]) for k in ("tokens", "labels")}
    nb, wts = np.array([1, 0], np.int32), np.array([0.25, 0.5], np.float32)
    jstep = jax.jit(jtr.make_train_step(jcfg, jopt_, 2, "netmax"))
    tstep = ttr.make_train_step(tcfg, topt_, 2, "netmax")
    jp, jo, jm = jstep(jp, jo, {k: jnp.asarray(v) for k, v in batch.items()},
                       {"neighbors": jnp.asarray(nb), "weights": jnp.asarray(wts),
                        "lr": jnp.float32(LR)})
    tp, to, tm = tstep(tp, to, {k: torch.from_numpy(v).long() for k, v in batch.items()},
                       {"neighbors": nb, "weights": wts, "lr": LR})
    np.testing.assert_allclose(tm["loss_per_worker"].numpy(), np.asarray(jm["loss_per_worker"]),
                               atol=1e-4, rtol=0)
    scale = max(float(np.abs(x).max()) for x in _tree_np(jp))
    assert _max_err(jp, tp) <= 1e-4 * scale


def test_ssm_rounds_with_remat_match_jax():
    """Two rounds of the ssm family (rwkv6-7b reduced, remat on, its 4
    micro-batches of one sequence, the fused mix) on the CPU against the JAX
    trainer: the path the card trains through the WKV kernels."""
    jcfg = replace(jget("rwkv6-7b").reduced(), remat=True)
    tcfg = replace(tget("rwkv6-7b").reduced(), remat=True)
    assert tcfg.microbatches == 4 and tcfg.remat
    jopt_, topt_ = jopt.sgd(momentum=0.9), topt.sgd(momentum=0.9)
    scfg = dict(use_gossip_mix_kernel=True)
    jstep = jax.jit(jtr.make_train_step(jcfg, jopt_, M, "netmax", jtr.TrainStepConfig(**scfg)))
    tstep = ttr.make_train_step(tcfg, topt_, M, "netmax", ttr.TrainStepConfig(**scfg))
    jp, jo = jtr.init_stacked(jcfg, jopt_, M, jax.random.PRNGKey(1))
    tp, to = lm_params_from_jax(jp), opt_state_from_jax(jo)
    stream, rng = _stream(), np.random.default_rng(1)
    for r in range(2):
        batch, nb, wts = _round_inputs(stream, rng, r)
        jp, jo, jm = jstep(jp, jo, {k: jnp.asarray(v) for k, v in batch.items()},
                           {"neighbors": jnp.asarray(nb), "weights": jnp.asarray(wts),
                            "lr": jnp.float32(LR)})
        tp, to, tm = tstep(tp, to, {k: torch.from_numpy(v).long() for k, v in batch.items()},
                           {"neighbors": nb, "weights": wts, "lr": LR})
        np.testing.assert_allclose(tm["loss_per_worker"].numpy(),
                                   np.asarray(jm["loss_per_worker"]), atol=1e-4, rtol=0,
                                   err_msg=f"round {r}")
    scale = max(float(np.abs(x).max()) for x in _tree_np(jp))
    assert _max_err(jp, tp) <= 1e-4 * scale


# ------------------------------------------------------------------ checkpoints


@pytest.fixture(scope="module")
def trained(jax_runs):
    """The JAX package's AdamW run (int32 step count beside f32 moments)."""
    jp, jo, _, _ = jax_runs("adamw")
    return jp, jo


def _assert_bits_equal(a_leaves, b_leaves):
    assert len(a_leaves) == len(b_leaves)
    for a, b in zip(a_leaves, b_leaves):
        a = np.asarray(a)
        b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype
        assert a.tobytes() == b.tobytes()


def test_checkpoint_port_save_jax_restore(tmp_path, trained):
    jp, jo = trained
    tp, to = lm_params_from_jax(jp), opt_state_from_jax(jo)
    tckpt.save(tmp_path, 5, tp, to, monitor_state={"rho": 1.5, "P": [[0.0]]},
               data_cursor={"round": 5})
    p2, o2, man, mon = jckpt.restore(tmp_path, jp, jo)
    _assert_bits_equal(jax.tree_util.tree_leaves(p2), tree_leaves(tp))
    _assert_bits_equal(jax.tree_util.tree_leaves(o2), tree_leaves(to))
    assert man["tree_hash"] == jckpt._tree_hash(jp)
    assert man["data_cursor"] == {"round": 5} and mon["rho"] == 1.5


def test_checkpoint_jax_save_port_restore(tmp_path, trained):
    jp, jo = trained
    jckpt.save(tmp_path, 3, jp, jo, data_cursor={"round": 3})
    like_p, like_o = ttr.abstract_stacked(_tiny(tget), topt.adamw(eps=1e-6), M)
    p2, o2, man, mon = tckpt.restore(tmp_path, like_p, like_o, device="cpu")
    assert tckpt.latest_step(tmp_path) == 3 and mon is None
    _assert_bits_equal(jax.tree_util.tree_leaves(jp), tree_leaves(p2))
    _assert_bits_equal(jax.tree_util.tree_leaves(jo), tree_leaves(o2))
    assert man["tree_hash"] == tckpt._tree_hash(p2)


def test_checkpoint_bf16_leaf_round_trips_without_ml_dtypes(tmp_path):
    """bf16 leaves are written as 2-byte void elements and read back as
    bf16 from the bytes alone (as the card's machine, without ml_dtypes,
    reads them); a JAX bf16 checkpoint reads the same way."""
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.standard_normal((M, 3, 5)).astype(np.float32)).bfloat16()
    params = {"w": w, "b": torch.arange(M, dtype=torch.float32)}
    tckpt.save(tmp_path / "port", 1, params, {})
    blob = np.load(tmp_path / "port" / "step_1" / "worker_0.npz")
    assert blob["p/w"].dtype == np.dtype("V2")
    p2, _, _, _ = tckpt.restore(tmp_path / "port", params, {}, device="cpu")
    assert p2["w"].dtype == torch.bfloat16 and torch.equal(p2["w"].view(torch.int16),
                                                         w.view(torch.int16))
    jckpt.save(tmp_path / "jax", 1, {"w": jnp.asarray(w.float().numpy()).astype(jnp.bfloat16)},
               {})
    p3, _, _, _ = tckpt.restore(tmp_path / "jax", {"w": w}, {}, device="cpu")
    assert torch.equal(p3["w"].view(torch.int16), w.view(torch.int16))


def test_checkpoint_resume_equals_uninterrupted(tmp_path, jax_runs):
    init = jax_runs("netmax-gather")[3]
    full_p, full_o, full_l = _torch_run("netmax-gather", init, rounds=4)
    p, o, _ = _torch_run("netmax-gather", init, rounds=2)
    tckpt.save(tmp_path, 2, p, o, data_cursor={"round": 2})
    p, o, man, _ = tckpt.restore(tmp_path, p, o, device="cpu")
    p, o, losses = _torch_run("netmax-gather", init, rounds=4,
                              start=man["data_cursor"]["round"], state=(p, o))
    _assert_bits_equal(tree_leaves(full_p), tree_leaves(p))
    _assert_bits_equal(tree_leaves(full_o), tree_leaves(o))
    np.testing.assert_array_equal(full_l[-1], losses[-1])


# ------------------------------------------------------------------ elastic, loader, launcher


def test_remove_and_add_workers_match_jax(trained):
    jp, jo = trained
    tp, to = lm_params_from_jax(jp), opt_state_from_jax(jo)
    keep = np.array([0, 2, 3])
    jr = jel.remove_workers(jp, jo, keep)
    tr = tel.remove_workers(tp, to, keep)
    for a, b in zip(jr, tr):
        _assert_bits_equal(jax.tree_util.tree_leaves(a), tree_leaves(b))
    ja = jel.add_workers(*jr, n_new=2, seed_from=1)
    ta = tel.add_workers(*tr, n_new=2, seed_from=1)
    for a, b in zip(ja, ta):
        _assert_bits_equal(jax.tree_util.tree_leaves(a), tree_leaves(b))
    # Copies, never aliases: no output shares storage with an input or another row.
    for leaf in tree_leaves(ta[0]):
        leaf[-1].add_(1.0)
        assert not torch.equal(leaf[-1], leaf[-2])
    assert all(a.data_ptr() != b.data_ptr()
               for a, b in zip(tree_leaves(ta[1]), tree_leaves(tr[1])))


def test_stacked_loader_yields_the_stream():
    stream = TokenStream(vocab_size=64, seq_len=8, batch_size=2, seed=3)
    loader = StackedLoader(stream, n_workers=3, start_step=5, device="cpu")
    try:
        for want_step in (5, 6):
            step, batch = next(loader)
            assert step == want_step
            for k in ("tokens", "labels"):
                assert batch[k].dtype == torch.int64 and batch[k].shape == (3, 2, 8)
                np.testing.assert_array_equal(
                    batch[k].numpy(), np.stack([stream.batch(w, step)[k] for w in range(3)]))
    finally:
        loader.close()


def test_launch_train_runs_and_resumes_on_cpu(tmp_path, capsys):
    args = ["--arch", "tinyllama-1.1b", "--device", "cpu", "--rounds", "4", "--seq", "16",
            "--batch-per-worker", "2", "--monitor-every", "2", "--log-every", "1",
            "--ckpt", str(tmp_path), "--ckpt-every", "2"]
    tlaunch.main(args)
    out = capsys.readouterr().out
    assert "arch=tinyllama-1.1b" in out and "done." in out
    losses = [float(line.split("loss=")[1].split()[0]) for line in out.splitlines()
              if line.startswith("round")]
    assert len(losses) == 4 and np.isfinite(losses).all()
    assert tckpt.latest_step(tmp_path) == 4
    tlaunch.main(args[:5] + ["6"] + args[6:])
    out = capsys.readouterr().out
    assert "[resume] round 4" in out
    assert [line.split()[1] for line in out.splitlines() if line.startswith("round")] == [
        "5", "6"]


def test_tree_functions_and_train_step_leave_no_reference_cycles():
    """Nothing a round allocates waits for Python's cycle collector: the
    tree functions once recursed through closures over themselves, a cycle
    that kept every leaf they touched alive until a collection (38.7 GB of
    a round's grads, updates and replicas at the card's training phase)."""
    import gc

    from repro_torch.tree import tree_flatten, tree_unflatten

    tree = {"a": [torch.zeros(3), (torch.ones(2), None)], "b": torch.zeros(1)}
    cfg = _tiny(tget)
    opt = topt.sgd(momentum=0.9)
    step = ttr.make_train_step(cfg, opt, M, "netmax",
                               ttr.TrainStepConfig(use_gossip_mix_kernel=True))
    params, state = ttr.init_stacked(cfg, opt, M, torch.Generator().manual_seed(0))
    batch, nb, wts = _round_inputs(_stream(), np.random.default_rng(0), 0)
    b = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    gc.collect()
    gc.disable()
    try:
        leaves, treedef = tree_flatten(tree)
        tree_unflatten(treedef, leaves)
        tree_map(torch.neg, tree)
        assert gc.collect() == 0
        params, state, _ = step(params, state, b, {"neighbors": nb, "weights": wts, "lr": LR})
        assert gc.collect() == 0
    finally:
        gc.enable()
