"""Training the moe, every_2 MoE, hybrid, audio and vlm families: the port
against the JAX package, on the CPU.

Reduced configs (``ArchConfig.reduced()``, f32), seq 16; the JAX
parameters, drawn from ``PRNGKey(0)``, carried across with
``convert.lm_params_from_jax``; batches (tokens, labels, and the family's
f32 frames or vision tokens) drawn with numpy from a seed.  Tolerances: the
gradients of ``lm.loss_fn`` 1e-5 of each leaf's max |grad|; one round of
``make_train_step`` (M = 2, remat on, the fused mix, the config's
micro-batches) losses within 1e-4 and params within 1e-4 of max |param|, as
``tests/test_torch_trainer.py``'s ssm rounds.  Input specs, the launchers'
refusal of audio and vlm (ROADMAP C10), whisper's remat and its per-layer
gradient leaves exactly.
"""

import sys
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import all_archs as jax_archs
from repro.launch import specs as jspecs
from repro.launch import train as jlaunch
from repro.models import lm as jlm
from repro.optim import optimizers as jopt
from repro.train import trainer as jtr
from repro_torch.configs.base import SHAPES as TSHAPES
from repro_torch.configs.base import all_archs as torch_archs
from repro_torch.convert import lm_params_from_jax, opt_state_from_jax
from repro_torch.launch import specs as tspecs
from repro_torch.launch import train as tlaunch
from repro_torch.models import lm as tlm
from repro_torch.models import whisper as twh
from repro_torch.optim import optimizers as topt
from repro_torch.train import trainer as ttr
from repro_torch.tree import tree_leaves, tree_map

MOE, EVERY2, HYBRID = "phi3.5-moe-42b-a6.6b", "llama4-maverick-400b-a17b", "jamba-v0.1-52b"
AUDIO, VLM = "whisper-small", "internvl2-1b"
FAMILIES = [MOE, EVERY2, HYBRID, AUDIO, VLM]
M, SEQ, LR = 2, 16, 0.05


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny widths on the CPU: torch's intra-op threads gain nothing and
    contend with the other test workers'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(name, **kw):
    """(JAX cfg, port cfg): the arch's reduced config, remat on."""
    return (replace(jax_archs()[name].reduced(), remat=True, **kw),
            replace(torch_archs()[name].reduced(), remat=True, **kw))


def _batch(cfg, lead, seed):
    """tokens, labels and the family's f32 frames or vision tokens (numpy),
    leaves of shape ``lead + (...)``."""
    rng = np.random.default_rng(seed)
    b = {k: rng.integers(0, cfg.vocab_size, size=lead + (SEQ,)).astype(np.int32)
         for k in ("tokens", "labels")}
    if cfg.n_vis_tokens:
        b["vis_embeds"] = rng.normal(size=lead + (cfg.n_vis_tokens, cfg.d_model)).astype(
            np.float32)
    if cfg.family == "audio":
        b["frames"] = rng.normal(size=lead + (cfg.enc_seq_len, cfg.d_model)).astype(
            np.float32)
    return b


def _flat(tree):
    """(key path, numpy) of a JAX or a port tree, in the JAX package's
    order (tensors are leaves to JAX)."""
    return [(jax.tree_util.keystr(p), np.asarray(v.detach() if isinstance(v, torch.Tensor)
                                                 else v, np.float32))
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]]


# ------------------------------------------------------------------ gradients


@pytest.mark.parametrize("name", FAMILIES)
def test_loss_gradients_match_jax(name):
    """The port's autograd gradients of ``lm.loss_fn`` (remat on: whisper's
    blocks under checkpoint too) against ``jax.value_and_grad`` of the JAX
    loss on the same batch, leaf by leaf."""
    jc, tc = _cfgs(name)
    jp = jlm.init_params(jc, jax.random.PRNGKey(0))
    tp = lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    b = _batch(jc, (2,), seed=1)
    jloss, jg = jax.jit(jax.value_and_grad(
        lambda p, bb: jlm.loss_fn(p, bb, jc)))(jp, {k: jnp.asarray(v) for k, v in b.items()})
    leaves = [t.requires_grad_() for t in tree_leaves(tp)]
    loss = tlm.loss_fn(tp, {k: torch.from_numpy(v) for k, v in b.items()}, tc)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    tg = _unflatten(tp, grads)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), atol=1e-5, rtol=0)
    want, got = _flat(jg), _flat(tg)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (key, g), (_, w) in zip(got, want):
        assert g.shape == w.shape, key
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g - w).max()) <= 1e-5 * scale, key


# ------------------------------------------------------------------ rounds


@pytest.mark.parametrize("name", FAMILIES)
def test_round_matches_jax(name):
    """One round of ``make_train_step`` (M = 2, remat, the fused mix, the
    config's micro-batches: phi3.5 and jamba 8, llama4 16, one sequence
    each; whisper and internvl2 one of two sequences) against the JAX
    trainer, jitted, from the same params, batch and gossip draws."""
    jc, tc = _cfgs(name)
    b_per = max(tc.microbatches, 2)
    jopt_, topt_ = jopt.sgd(momentum=0.9, weight_decay=1e-4), topt.sgd(momentum=0.9,
                                                                         weight_decay=1e-4)
    jstep = jax.jit(jtr.make_train_step(jc, jopt_, M, "netmax",
                                        jtr.TrainStepConfig(use_gossip_mix_kernel=True)))
    tstep = ttr.make_train_step(tc, topt_, M, "netmax",
                                ttr.TrainStepConfig(use_gossip_mix_kernel=True))
    jp, jo = jtr.init_stacked(jc, jopt_, M, jax.random.PRNGKey(0))
    tp, to = lm_params_from_jax(jp), opt_state_from_jax(jo)
    b = _batch(jc, (M, b_per), seed=2)
    nb, wts = np.array([1, 0], np.int32), np.array([0.25, 0.5], np.float32)
    jp, jo, jm = jstep(jp, jo, {k: jnp.asarray(v) for k, v in b.items()},
                       {"neighbors": jnp.asarray(nb), "weights": jnp.asarray(wts),
                        "lr": jnp.float32(LR)})
    tp, to, tm = tstep(tp, to, {k: torch.from_numpy(v) for k, v in b.items()},
                       {"neighbors": nb, "weights": wts, "lr": LR})
    np.testing.assert_allclose(tm["loss_per_worker"].numpy(),
                               np.asarray(jm["loss_per_worker"]), atol=1e-4, rtol=0)
    want, got = _flat(jp), _flat(tp)
    assert [k for k, _ in got] == [k for k, _ in want]
    scale = max(float(np.abs(w).max()) for _, w in want)
    assert max(float(np.abs(g - w).max()) for (_, g), (_, w) in zip(got, want)) <= 1e-4 * scale
    for (key, t), (_, j) in zip(_flat(to), _flat(jo)):
        assert t.shape == j.shape, key


# ------------------------------------------------------------------ specs


def _spec_leaves(tree):
    return [(jax.tree_util.keystr(p), tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]]


@pytest.mark.parametrize("name", sorted(jax_archs()))
def test_input_specs_match_jax(name):
    """Every program's inputs for every arch and shape: the same leaves,
    shapes and dtypes as the JAX package's ShapeDtypeStructs, on the meta
    device (nothing allocated)."""
    assert list(TSHAPES) == list(JSHAPES)
    jc, tc = jax_archs()[name], torch_archs()[name]
    for shape in JSHAPES:
        n = 4 if JSHAPES[shape].kind == "train" else 1
        want = jspecs.input_specs(jc, shape, n, jopt.sgd(momentum=0.9))
        got = tspecs.input_specs(tc, shape, n, topt.sgd(momentum=0.9))
        assert all(t.device.type == "meta" for t in tree_leaves(got)), shape
        assert _spec_leaves(got) == _spec_leaves(want), (name, shape)


def test_batch_and_gossip_specs_match_jax():
    jc, tc = jax_archs()[VLM], torch_archs()[VLM]
    shape = replace(JSHAPES["train_4k"], global_batch=8)
    assert (_spec_leaves(tspecs.train_batch_specs(tc, shape, 2))
            == _spec_leaves(jspecs.train_batch_specs(jc, shape, 2)))
    assert _spec_leaves(tspecs.gossip_specs(3)) == _spec_leaves(jspecs.gossip_specs(3))
    with pytest.raises(ValueError, match="not divisible"):
        tspecs.train_batch_specs(tc, shape, 3)


# ------------------------------------------------------------------ launchers (C10)


@pytest.mark.parametrize("name", [AUDIO, VLM])
def test_launchers_refuse_audio_and_vlm(name, monkeypatch):
    """ROADMAP C10: both launchers build batches of tokens and labels only.
    The JAX launcher fails inside the step (``KeyError: 'frames'`` for
    whisper, an ``AssertionError`` for the VLM); the port's ``TrainLoop``
    refuses the family by name before it allocates anything."""
    argv = ["--arch", name, "--reduced", "--rounds", "1", "--workers", "2", "--seq", "16",
            "--batch-per-worker", "2"]
    monkeypatch.setattr(sys, "argv", ["train", *argv])
    with pytest.raises((KeyError, AssertionError)):
        jlaunch.main()
    with pytest.raises(ValueError, match="C10"):
        tlaunch.main(argv + ["--device", "cpu"])
    with pytest.raises(ValueError, match="train_batch_specs"):
        tlaunch.TrainLoop(torch_archs()[name].reduced(), workers=2, device="cpu")


# ------------------------------------------------------------------ whisper


def test_whisper_blocks_rematerialise_under_autograd_only(monkeypatch):
    """Under autograd with ``cfg.remat`` each encoder and decoder block runs
    under ``torch.utils.checkpoint``, as the JAX package's ``jax.checkpoint``;
    serving (grad disabled) and remat off call it never; the loss is the
    same either way."""
    _, tc = _cfgs(AUDIO)
    calls = []
    real = twh.checkpoint
    monkeypatch.setattr(twh, "checkpoint", lambda *a, **k: calls.append(1) or real(*a, **k))
    tp = tlm.init_params(tc, torch.Generator().manual_seed(0))
    b = {k: torch.from_numpy(v) for k, v in _batch(tc, (2,), seed=3).items()}
    for t in tree_leaves(tp):
        t.requires_grad_()
    with_remat = tlm.loss_fn(tp, b, tc)
    assert len(calls) == tc.n_enc_layers + tc.n_layers
    calls.clear()
    with torch.no_grad():
        served = tlm.loss_fn(tp, b, tc)
        tlm.prefill_logits(tp, b, tc)
    without = tlm.loss_fn(tp, b, replace(tc, remat=False))
    assert not calls
    assert float(with_remat.detach()) == float(served) == float(without.detach())


class _SelectBackwards(TorchDispatchMode):
    """Records the sizes of every ``select_backward`` (the op that writes a
    one-layer gradient into a zero-filled tensor of the whole stack)."""

    def __init__(self):
        super().__init__()
        self.sizes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.select_backward.default:
            self.sizes.append(tuple(args[1]))
        return func(*args, **(kwargs or {}))


def test_whisper_worker_gradients_are_allocated_once_per_layer():
    """``worker_leaves`` splits whisper's ``enc_blocks`` and ``dec_blocks`` as
    it splits ``blocks``: each layer is a leaf of its own, so no backward op
    fills a tensor of all layers (as one view of a stacked leaf would, once
    per layer); the grads are the stacked form's, layer by layer."""
    cfg = replace(torch_archs()[AUDIO].reduced(), n_layers=3, n_enc_layers=3)
    params, _ = ttr.init_stacked(cfg, topt.sgd(), M, torch.Generator().manual_seed(0))
    b = {k: torch.from_numpy(v[1]) for k, v in _batch(cfg, (M, 2), seed=4).items()}
    stacked = {tuple(leaf.shape[1:]) for k in ttr.STACKED_BLOCKS if k in params
               for leaf in tree_leaves(params[k])}
    split = ttr.worker_leaves(params, 1, lambda leaf: leaf.detach().requires_grad_())
    for key, n in (("enc_blocks", 3), ("dec_blocks", 3)):
        assert isinstance(split[key], list) and len(split[key]) == n
        assert split[key][2]["mlp"]["w_up"].data_ptr() == params[key]["mlp"]["w_up"][1, 2].data_ptr()
    whole = tree_map(lambda leaf: leaf[1].detach().requires_grad_(), params)
    grads = {}
    for form, p in (("split", split), ("whole", whole)):
        loss = tlm.loss_fn(p, b, cfg)
        with _SelectBackwards() as seen:
            grads[form] = _unflatten(p, torch.autograd.grad(loss, tree_leaves(p)))
        fills = [s for s in seen.sizes if s in stacked]
        if form == "split":
            assert not fills, fills
        else:  # the check sees what it guards against
            assert len(fills) >= 3, seen.sizes
    for key, g in grads["whole"].items():
        if key in ttr.STACKED_BLOCKS:
            for layer, got in enumerate(grads["split"][key]):
                for a, c in zip(tree_leaves(got), tree_leaves(g)):
                    assert torch.equal(a, c[layer]), (key, layer)
        else:
            for a, c in zip(tree_leaves(grads["split"][key]), tree_leaves(g)):
                assert torch.equal(a, c), key


def _unflatten(like, leaves):
    """``leaves`` in the tree structure of ``like``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


# ------------------------------------------------------------------ chip_smoke.py's phases 30-33


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", [AUDIO, VLM])
def test_chip_smoke_specs_loop_feeds_audio_and_vlm(name):
    """Phases 31-32's loop on the CPU at the reduced config: its batch has
    the leaves, shapes and dtypes of ``train_batch_specs`` (frames or vision
    tokens f32, token ids int32 within the vocab), and a round runs the
    trainer to finite losses."""
    cs = _chip_smoke()
    cfg = replace(torch_archs()[name].reduced(), remat=True)
    loop = cs.SpecsLoop(torch, cfg, M, SEQ, 2, device="cpu")
    b = loop.batch(0)
    assert {k: (tuple(v.shape), v.dtype) for k, v in b.items()} == \
        {k: (tuple(v.shape), v.dtype) for k, v in loop.specs.items()}
    assert 0 <= int(b["tokens"].min()) and int(b["tokens"].max()) < cfg.vocab_size
    assert b["tokens"].shape == (M, 2, SEQ)
    m = loop.round(0)
    assert m["loss_per_worker"].shape == (M,) and bool(torch.isfinite(m["loss_per_worker"]).all())


def test_chip_smoke_family_round_pins_every_route_call():
    """Phase 33's card-against-CPU round, run CPU against CPU at phi3.5's bf16
    cut: the pinned run replays exactly the recorded expert choices of every
    MoE call (the remat recomputation's too, so two per layer, worker and
    micro-batch) and so equals the unpinned run; the launch counts it expects
    follow the config; llama4's and jamba's one period exceeds a card."""
    cs = _chip_smoke()
    cfg = replace(cs.family_cut(torch_archs()[MOE], "bfloat16"), remat=True)
    res = cs.family_train_parity(torch, cfg, "bfloat16", M, 8, SEQ, devices=("cpu", "cpu"))
    assert res["routing_pinned"] and res["route_calls"] == M * 8 * cfg.n_layers * 2
    assert res["loss_rel_err"] == res["param_rel_err"] == res["unpinned_param_rel_err"] == 0
    assert res["routing_flips"] == 0 and res["mix_groups"] == 2  # bf16 leaves, f32 router
    assert cs.train_launches_expected(cfg, M, 8) == {"flash_attention": 2 * M * 8 * 2,
                                                     "flash_attention_bwd": M * 8 * 2}
    rows = cs.cut_only_arithmetic("cpu")
    assert round(rows[EVERY2]["params"] / 1e9, 2) == 18.43
    assert round(rows[HYBRID]["params"] / 1e9, 2) == 13.30
