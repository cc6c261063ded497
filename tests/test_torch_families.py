"""The port's MoE, every_2, hybrid, audio and VLM families against the JAX
package, on the CPU.

Reduced configs (``ArchConfig.reduced()``: 2-4 layers, d_model 64); the
JAX parameters are carried across with ``convert.lm_params_from_jax`` and
inputs drawn with numpy from a seed.  Tolerances: whole-model hidden states,
logits, caches and losses 1e-4 (f32: the two packages sum matmuls in
different orders); the MoE aux loss 1e-6; the modules (MoE, mamba, cross
attention) 1e-5; attention 2e-5 as ``tests/test_kernels.py``; bf16 models
against f32 frames or vision tokens 2e-2 of max |logit|; token ids, counts
and layouts exactly.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import all_archs as jax_archs
from repro.models import attention as jattn
from repro.models import frontends as jfront
from repro.models import lm as jlm
from repro.models import mamba as jmam
from repro.models import modules as jmod
from repro.models import moe as jmoe
from repro.models import transformer as jtr
from repro.models import whisper as jwh
from repro.serve import engine as jeng
from repro_torch.configs.base import all_archs as torch_archs
from repro_torch.convert import lm_params_from_jax
from repro_torch.models import attention as tattn
from repro_torch.models import frontends as tfront
from repro_torch.models import lm as tlm
from repro_torch.models import mamba as tmam
from repro_torch.models import modules as tmod
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttr
from repro_torch.models import whisper as twh
from repro_torch.serve import engine as teng

MOE, EVERY2, HYBRID = "phi3.5-moe-42b-a6.6b", "llama4-maverick-400b-a17b", "jamba-v0.1-52b"
AUDIO, VLM = "whisper-small", "internvl2-1b"
FAMILIES = [MOE, EVERY2, HYBRID, AUDIO, VLM]
#: The archs whose serving prefill captures a cache (the others raise, C8).
CAPTURED = [MOE, EVERY2, HYBRID]


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), atol=tol, rtol=tol)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _to_torch(tree):
    return jax.tree_util.tree_map(torch.from_numpy, tree)


@functools.lru_cache(maxsize=None)
def _model(name, dtype="float32"):
    """(JAX cfg, JAX params, port cfg, port params) of the reduced arch."""
    jc = dataclasses.replace(jax_archs()[name].reduced(), dtype=dtype)
    tc = dataclasses.replace(torch_archs()[name].reduced(), dtype=dtype)
    jp = jlm.init_params(jc, jax.random.PRNGKey(0))
    tp = lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    return jc, jp, tc, tp


def _batch(cfg, B=2, S=16, seed=0):
    """tokens, labels and the family's f32 frames or vision tokens (numpy)."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)}
    if cfg.n_vis_tokens:
        b["vis_embeds"] = rng.normal(size=(B, cfg.n_vis_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        b["frames"] = rng.normal(size=(B, cfg.enc_seq_len, cfg.d_model)).astype(np.float32)
    return b


def _flat(tree):
    return [(jax.tree_util.keystr(p), v) for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]]


# ------------------------------------------------------------- whole model


@pytest.mark.parametrize("name", FAMILIES)
def test_forward_and_prefill_logits_match_jax(name):
    jc, jp, tc, tp = _model(name)
    b = _batch(jc)
    jb, tb = _to_jax(b), _to_torch(b)
    if jc.family == "audio":
        jx = jwh.decode_train(jp, jb["tokens"], jwh.encode(jp, jb["frames"], jc), jc)
        tx = twh.decode_train(tp, tb["tokens"], twh.encode(tp, tb["frames"], tc), tc)
    else:
        jx, jaux = jtr.forward(jp, jb["tokens"], jc, vis_embeds=jb.get("vis_embeds"))
        tx, taux = ttr.forward(tp, tb["tokens"], tc, vis_embeds=tb.get("vis_embeds"))
        assert taux.dtype == torch.float32 and taux.shape == ()
        _close(taux, jaux, 1e-6)
        assert (float(jaux) > 0) == (jc.moe is not None)
    assert tuple(tx.shape) == jx.shape
    _close(tx, jx, 1e-4)
    want = jlm.prefill_logits(jp, jb, jc)
    got = tlm.prefill_logits(tp, tb, tc)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, jc.vocab_size)
    _close(got, want, 1e-4)


@pytest.mark.parametrize("name", FAMILIES)
def test_loss_fn_matches_jax(name):
    jc, jp, tc, tp = _model(name)
    b = _batch(jc, seed=1)
    want = jlm.loss_fn(jp, _to_jax(b), jc)
    got = tlm.loss_fn(tp, _to_torch(b), tc)
    assert got.dtype == torch.float32 and got.shape == ()
    _close(got, want, 1e-4)


@pytest.mark.parametrize("name", FAMILIES)
def test_decode_steps_and_cache_match_jax(name):
    jc, jp, tc, tp = _model(name)
    toks = _batch(jc, S=5, seed=2)["tokens"]
    jstep = jax.jit(lambda p, c, t, pos: jlm.decode_step(p, c, t, pos, jc))
    jcache = jlm.init_cache(jc, 2, 12)
    tcache = tlm.init_cache(tc, 2, 12, device="cpu")
    for pos in range(toks.shape[1]):
        jlog, jcache = jstep(jp, jcache, jnp.asarray(toks[:, pos]), pos)
        tlog, tcache = tlm.decode_step(tp, tcache, torch.from_numpy(toks[:, pos]), pos, tc)
        assert tlog.dtype == torch.float32
        _close(tlog, jlog, 1e-4)
    jleaves, tleaves = _flat(jcache), _flat(tcache)
    assert [(k, v.shape) for k, v in jleaves] == [(k, tuple(v.shape)) for k, v in tleaves]
    for (key, j), (_, t) in zip(jleaves, tleaves):
        assert t.dtype == getattr(torch, str(j.dtype)), key
        _close(t, j, 1e-4)


@pytest.mark.parametrize("name", CAPTURED)
def test_capture_prefill_matches_jax(name):
    jc, jp, tc, tp = _model(name)
    toks = _batch(jc, S=6, seed=3)["tokens"]  # the JAX side replays each step eagerly
    jlog, jcache = jeng.capture_prefill(jc, jp, jnp.asarray(toks), 12)
    tlog, tcache = teng.capture_prefill(tc, tp, torch.from_numpy(toks), 12)
    _close(tlog, jlog, 1e-4)
    for (key, j), (_, t) in zip(_flat(jcache), _flat(tcache)):
        _close(t, j, 1e-4)
    # reduced()'s capacity factor 2.0 drops no token, so the decode of the
    # last token after capturing the others is the prefill's last row.
    _, part = teng.capture_prefill(tc, tp, torch.from_numpy(toks[:, :-1]), 12)
    dlog, _ = tlm.decode_step(tp, part, torch.from_numpy(toks[:, -1]), 5, tc)
    _close(dlog, _np(tlog[:, 0]), 1e-4)


@pytest.mark.parametrize("name", [AUDIO, VLM])
def test_capture_prefill_raises_for_audio_and_vlm(name):
    """ROADMAP C8: the JAX package's capture_prefill prefills tokens alone and
    fails for these families (whisper's tree has no 'blocks'; the VLM asserts
    vision tokens); the port refuses them by name."""
    jc, jp, tc, tp = _model(name)
    toks = _batch(jc, S=4)["tokens"]
    with pytest.raises((KeyError, AssertionError)):
        jeng.capture_prefill(jc, jp, jnp.asarray(toks), 8)
    with pytest.raises(ValueError, match="C8"):
        teng.capture_prefill(tc, tp, torch.from_numpy(toks), 8)


@pytest.mark.parametrize("name", FAMILIES)
def test_serve_engine_token_ids_equal_jax(name):
    """The requests of tests/test_torch_lm.py::test_serve_engine_token_ids_equal_jax
    (whisper's decode cross-attends to the zero cache K/V, C8, on both sides)."""
    jc, jp, tc, tp = _model(name)

    def requests(Request):
        return [Request(rid=0, prompt=np.array([1, 2, 3], np.int32), max_new=4),
                Request(rid=1, prompt=np.array([4, 5], np.int32), max_new=4)]

    want = jeng.ServeEngine(jc, jp, batch_capacity=2, max_seq=32).run(requests(jeng.Request))
    got = teng.ServeEngine(tc, tp, batch_capacity=2, max_seq=32).run(requests(teng.Request))
    assert [(r.rid, r.out) for r in got] == [(r.rid, r.out) for r in want]
    assert all(len(r.out) == 4 and all(0 <= t < tc.vocab_size for t in r.out) for r in got)


@pytest.mark.parametrize("name", sorted(jax_archs()))
def test_active_param_count_matches_jax(name):
    tc, jc = torch_archs()[name], jax_archs()[name]
    assert tlm.active_param_count(tc) == jlm.active_param_count(jc)
    assert tlm.active_param_count(tc) <= tlm.param_count(tc)


@pytest.mark.parametrize("name", FAMILIES)
def test_random_init_has_the_jax_layout(name):
    tc, jc = torch_archs()[name].reduced(), jax_archs()[name].reduced()
    tp = tlm.init_params(tc, torch.Generator().manual_seed(0))
    jp = jlm.init_params(jc, jax.random.PRNGKey(0))
    assert [(k, tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in _flat(tp)] == [
        (k, v.shape, str(v.dtype)) for k, v in _flat(jp)]
    tcache = tlm.init_cache(tc, 2, 8, device="cpu")
    assert [(k, tuple(v.shape)) for k, v in _flat(tcache)] == [
        (k, v.shape) for k, v in _flat(jlm.init_cache(jc, 2, 8))]


@pytest.mark.parametrize("name", [AUDIO, HYBRID, MOE])
def test_params_convert_the_new_trees_with_dtypes_kept(name):
    """whisper's enc_blocks/dec_blocks, the hybrid pos{j} sub-dicts and the
    f32 router inside a bf16 model carry across bit for bit."""
    jc, jp, _, tp = _model(name, "bfloat16")
    jl, tl = _flat(jp), _flat(tp)
    assert [k for k, _ in jl] == [k for k, _ in tl]
    for (key, a), (_, b) in zip(jl, tl):
        assert b.dtype == getattr(torch, str(a.dtype)) and tuple(b.shape) == a.shape, key
        np.testing.assert_array_equal(b.float().numpy(), np.asarray(a, np.float32))
    keys = {k for k, _ in tl}
    if name == AUDIO:
        assert "['enc_blocks']['attn']['wq']" in keys and "['dec_blocks']['cross_attn']['wq']" in keys
    if name == HYBRID:
        assert "['blocks']['pos0']['mamba']['A_log']" in keys
        assert tp["blocks"]["pos0"]["mamba"]["A_log"].dtype == torch.float32
    if jc.moe is not None:
        router = tp["blocks"]["pos0" if name == HYBRID else "moe"]
        router = router["moe"]["w_router"] if name == HYBRID else router["w_router"]
        assert router.dtype == torch.float32 and tp["embed"]["table"].dtype == torch.bfloat16


#: Attention calls (flash-attention launches on the card) per prefill of a
#: reduced cut, by arch: one per attention mixer; whisper's encoder, its
#: decoder's self- and cross-attention.  chip_smoke.py holds the card to the
#: same counts at full depth (phases 21-25) and on these cuts (phase 26).
def _attention_calls(cfg):
    if cfg.family == "audio":
        return cfg.n_enc_layers + 2 * cfg.n_layers
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_period
    return cfg.n_layers


@pytest.mark.parametrize("name", FAMILIES)
def test_attention_calls_and_dtypes_per_prefill(name, monkeypatch):
    """In bf16: every attention call's operand dtypes, and how many there
    are: whisper's encoder is f32 (f32 frames), its cross-attention a bf16
    query against f32 keys/values; everything else bf16."""
    _, _, tc, tp = _model(name, "bfloat16")
    calls = []
    inner = tattn.chunked_attention

    def counted(q, k, v, **kw):
        calls.append((q.dtype, k.dtype, v.dtype, kw["causal"]))
        return inner(q, k, v, **kw)

    monkeypatch.setattr(tattn, "chunked_attention", counted)
    tlm.prefill_logits(tp, _to_torch(_batch(tc, S=8)), tc)
    assert len(calls) == _attention_calls(tc)
    f32, bf16 = torch.float32, torch.bfloat16
    if tc.family == "audio":
        L = tc.n_layers
        assert calls[:tc.n_enc_layers] == [(f32, f32, f32, False)] * tc.n_enc_layers
        assert calls[tc.n_enc_layers:] == [(bf16, bf16, bf16, True),
                                           (bf16, f32, f32, False)] * L
    else:
        assert calls == [(bf16, bf16, bf16, True)] * len(calls)


@pytest.mark.parametrize("name", [AUDIO, VLM])
def test_f32_inputs_against_bf16_weights_match_jax(name):
    """JAX's promotion: f32 frames / vision tokens against bf16 weights give
    f32 products (``modules.promote``); logits within 2e-2 of max |logit|."""
    jc, jp, tc, tp = _model(name, "bfloat16")
    b = _batch(jc, seed=4)
    want = np.asarray(jlm.prefill_logits(jp, _to_jax(b), jc), np.float32)
    got = tlm.prefill_logits(tp, _to_torch(b), tc)
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= 2e-2 * np.abs(want).max()
    if name == AUDIO:
        enc = twh.encode(tp, torch.from_numpy(b["frames"]), tc)
        assert enc.dtype == torch.float32
        assert jwh.encode(jp, jnp.asarray(b["frames"]), jc).dtype == jnp.float32


def test_vlm_forward_needs_vision_tokens():
    jc, jp, tc, tp = _model(VLM)
    toks = _batch(jc, S=4)["tokens"]
    with pytest.raises(AssertionError):
        jtr.forward(jp, jnp.asarray(toks), jc)
    with pytest.raises(ValueError, match="vis_embeds"):
        ttr.forward(tp, torch.from_numpy(toks), tc)


@pytest.mark.parametrize("name", FAMILIES)
def test_launch_serve_on_cpu(name, capsys):
    from repro_torch.launch import serve

    serve.main(["--arch", name, "--device", "cpu", "--requests", "3", "--max-new", "3"])
    out = capsys.readouterr().out
    assert f"arch={name} on cpu: served 3 requests, 9 tokens" in out


def test_launch_serve_cuts_depth_in_whole_periods(capsys):
    from repro_torch.launch import serve

    serve.main(["--arch", HYBRID, "--device", "cpu", "--layers", "2", "--requests", "2",
                "--max-new", "2"])
    assert f"arch={HYBRID} on cpu: served 2 requests, 4 tokens" in capsys.readouterr().out
    with pytest.raises(ValueError, match="whole periods"):
        serve.main(["--arch", HYBRID, "--device", "cpu", "--layers", "3"])


# ----------------------------------------------------------------- modules


def _moe_cfg(capacity_factor):
    cfg = jax_archs()[MOE].reduced()
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                            capacity_factor=capacity_factor))


MOE_CASES = {
    "reduced": (2.0, 0.0),
    # capacity factor 1.0 and a router biased towards expert 0: drops
    "drops": (1.0, 4.0),
}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_apply_matches_jax(case):
    factor, bias = MOE_CASES[case]
    jc = _moe_cfg(factor)
    tc = dataclasses.replace(torch_archs()[MOE].reduced(), moe=dataclasses.replace(
        torch_archs()[MOE].reduced().moe, capacity_factor=factor))
    p = jax.tree_util.tree_map(np.asarray, jmoe.moe_init(jax.random.PRNGKey(5), jc,
                                                         jnp.float32))
    x = np.random.default_rng(5).standard_normal((2, 24, jc.d_model)).astype(np.float32)
    if bias:
        p["w_router"] = p["w_router"].copy()
        p["w_router"][:, 0] += bias * x.mean(axis=(0, 1)) / np.square(x.mean(axis=(0, 1))).sum()
    tp = lm_params_from_jax(p)
    jy, jaux = jmoe.moe_apply(_to_jax(p), jnp.asarray(x), jc)
    ty, taux = tmoe.moe_apply(tp, torch.from_numpy(x), tc)
    assert ty.dtype == torch.float32 and tuple(ty.shape) == x.shape
    _close(ty, jy, 1e-5)
    _close(taux, jaux, 1e-6)
    _, _, gates, pos, C = tmoe.route(tp, torch.from_numpy(x), tc)
    assert C == jmoe._capacity(24, jc.moe.n_experts, jc.moe.top_k, factor)
    dropped = int((pos == C).sum())
    assert (dropped > 0) == bool(bias), dropped
    assert bool((gates[pos == C] == 0).all())


def test_moe_capacity_and_param_count_match_jax():
    for S in (1, 7, 64, 512):
        for E, K, f in ((16, 2, 1.25), (128, 1, 1.25), (4, 2, 2.0), (16, 2, 1.0)):
            assert tmoe._capacity(S, E, K, f) == jmoe._capacity(S, E, K, f)
    for name in (MOE, EVERY2, HYBRID):
        assert tmoe.moe_param_count(torch_archs()[name]) == jmoe.moe_param_count(
            jax_archs()[name])


def _mamba(seed=6):
    jc = jax_archs()[HYBRID].reduced()
    tc = torch_archs()[HYBRID].reduced()
    p = jax.tree_util.tree_map(np.asarray, jmam.mamba_init(jax.random.PRNGKey(seed), jc,
                                                           jnp.float32))
    return jc, tc, p


@pytest.mark.parametrize("with_state", [False, True], ids=["zero_state", "state"])
@pytest.mark.parametrize("S", [1, 9, 128])
def test_mamba_apply_matches_jax(S, with_state):
    jc, tc, p = _mamba()
    rng = np.random.default_rng(S)
    u = rng.standard_normal((2, S, jc.d_model)).astype(np.float32)
    state = None
    if with_state:
        st = jax.tree_util.tree_map(np.asarray, jmam.mamba_init_state(jc, 2, jnp.float32))
        state = {k: rng.standard_normal(v.shape).astype(np.float32) * 0.5
                 for k, v in st.items()}
    jy, jst = jmam.mamba_apply(_to_jax(p), jnp.asarray(u), jc,
                               state=None if state is None else _to_jax(state))
    ty, tst = tmam.mamba_apply(lm_params_from_jax(p), torch.from_numpy(u), tc,
                               state=None if state is None else _to_torch(state))
    _close(ty, jy, 1e-5)
    assert sorted(tst) == sorted(jst) == ["conv", "ssm"]
    for k in tst:
        assert tuple(tst[k].shape) == jst[k].shape
        _close(tst[k], jst[k], 1e-5)


def test_mamba_scan_keeps_the_chunk_check():
    """The reference asserts S % 64 == 0 beyond one chunk; the port raises."""
    jc, tc, p = _mamba()
    u = np.zeros((1, 100, jc.d_model), np.float32)
    with pytest.raises(AssertionError, match="divisible"):
        jmam.mamba_apply(_to_jax(p), jnp.asarray(u), jc)
    with pytest.raises(ValueError, match="divisible"):
        tmam.mamba_apply(lm_params_from_jax(p), torch.from_numpy(u), tc)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attn_apply_matches_jax(dtype):
    """bf16: a bf16 query against f32 encoder output (the decoder's case),
    within the bf16 attention tolerance."""
    jc, tc = jax_archs()[AUDIO].reduced(), torch_archs()[AUDIO].reduced()
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    jp = jattn.attn_init(jax.random.PRNGKey(7), jc, jdt)
    tp = lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 8, jc.d_model)).astype(np.float32)
    src = rng.standard_normal((2, jc.enc_seq_len, jc.d_model)).astype(np.float32)
    want = jattn.cross_attn_apply(jp, jnp.asarray(x).astype(jdt), jnp.asarray(src), jc,
                                  q_chunk=4, kv_chunk=16)
    got = tattn.cross_attn_apply(tp, torch.from_numpy(x).to(getattr(torch, dtype)),
                                 torch.from_numpy(src), tc, q_chunk=4, kv_chunk=16)
    assert got.dtype == getattr(torch, str(want.dtype))
    _close(got, want, 2e-5 if dtype == "float32" else 2e-2)


def test_whisper_encode_and_decode_train_match_jax():
    jc, jp, tc, tp = _model(AUDIO)
    b = _batch(jc, S=12, seed=8)
    jenc = jwh.encode(jp, jnp.asarray(b["frames"]), jc)
    tenc = twh.encode(tp, torch.from_numpy(b["frames"]), tc)
    _close(tenc, jenc, 1e-4)
    # the decoder on the same encoder output
    want = jwh.decode_train(jp, jnp.asarray(b["tokens"]), jenc, jc)
    got = twh.decode_train(tp, torch.from_numpy(b["tokens"]), torch.from_numpy(np.array(jenc)),
                           tc)
    _close(got, want, 1e-4)


def test_sinusoid_and_promotion_match_jax():
    for S, d in ((1, 8), (37, 64), (1500, 768)):
        np.testing.assert_array_equal(tmod.sinusoidal_positions(S, d).numpy(),
                                      np.asarray(jmod.sinusoidal_positions(S, d)))
    rng = np.random.default_rng(9)
    a = rng.standard_normal((3, 16)).astype(np.float32)
    w = rng.standard_normal((16, 8)).astype(np.float32)
    want = jnp.asarray(a) @ jnp.asarray(w).astype(jnp.bfloat16)
    got = tmod.matmul(torch.from_numpy(a), torch.from_numpy(w).to(torch.bfloat16))
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    _close(got, want, 1e-6)
    x16 = torch.ones(2, dtype=torch.bfloat16)
    assert [t.dtype for t in tmod.promote(x16, x16)] == [torch.bfloat16] * 2
    assert tmod.promote(x16, x16)[0] is x16
    assert [t.dtype for t in tmod.promote(x16, torch.ones(2), x16)] == [torch.float32] * 3


@pytest.mark.parametrize("name", sorted(jax_archs()))
def test_frontends_shapes_dtypes_and_scale(name):
    tc, jc = torch_archs()[name], jax_archs()[name]
    jfn, tfn = jfront.frontend_for(jc), tfront.frontend_for(tc)
    assert (tfn and tfn.__name__) == (jfn and jfn.__name__)
    if tfn is None:
        return
    cut = dataclasses.replace(tc, d_model=256)
    x = tfn(torch.Generator().manual_seed(0), cut, 2)
    want = jfn(jax.random.PRNGKey(0), dataclasses.replace(jc, d_model=256), 2)
    assert x.dtype == torch.float32 and tuple(x.shape) == want.shape
    assert abs(float(x.std()) - 0.02) < 1e-3 and abs(float(jnp.std(want)) - 0.02) < 1e-3
    again = tfn(torch.Generator().manual_seed(0), cut, 2)
    assert torch.equal(x, again)
