"""The port's LM serving path against the JAX package, on the CPU.

Inputs are drawn with numpy from a seed and handed to both packages; the
JAX parameters are carried across with ``convert.lm_params_from_jax``.
Tolerances: attention as ``tests/test_kernels.py`` (2e-5 in f32, 2e-2 in
bf16); the modules 1e-6; whole-model hidden states, logits and caches 1e-4
(f32, reduced configs: the two packages sum matmuls in different orders);
generated token ids and configs exactly.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import all_archs as jax_archs
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.models import attention as jattn
from repro.models import lm as jlm
from repro.models import modules as jmod
from repro.models import transformer as jtr
from repro.serve import engine as jeng
from repro_torch.configs.base import all_archs as torch_archs
from repro_torch.convert import lm_params_from_jax
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import flash_attention as tfa
from repro_torch.models import attention as tattn
from repro_torch.models import lm as tlm
from repro_torch.models import modules as tmod
from repro_torch.models import transformer as ttr
from repro_torch.serve import engine as teng

DENSE = ["tinyllama-1.1b", "qwen1.5-0.5b", "starcoder2-3b"]
NOT_DENSE = ["internvl2-1b", "phi3.5-moe-42b-a6.6b", "llama4-maverick-400b-a17b",
             "jamba-v0.1-52b", "whisper-small"]

# tests/test_kernels.py ATTN_CASES, then ragged lengths (no 128-multiple).
ATTN_CASES = [
    # (B, S, Sk, H, Hk, hd, causal, dtype)
    (1, 128, 128, 4, 4, 64, True, "float32"),
    (2, 256, 256, 8, 2, 64, True, "float32"),
    (1, 128, 128, 4, 1, 32, True, "float32"),
    (2, 128, 256, 4, 4, 64, False, "float32"),
    (1, 256, 256, 2, 2, 128, True, "bfloat16"),
    (1, 512, 512, 4, 2, 64, True, "float32"),
    (1, 200, 200, 4, 2, 64, True, "float32"),
    (2, 120, 200, 4, 1, 32, False, "bfloat16"),
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _qkv(seed, B, S, Sk, H, Hk, hd, dtype):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, hd), (B, Sk, Hk, hd), (B, Sk, Hk, hd))]
    jx = [jnp.asarray(a).astype(JDT[dtype]) for a in arrs]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return jx, tx


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _ids(case):
    return "-".join(map(str, case))


# ------------------------------------------------------------------ attention


@pytest.mark.parametrize("case", ATTN_CASES, ids=_ids)
def test_reference_attention_matches_jax_flash(case):
    B, S, Sk, H, Hk, hd, causal, dtype = case
    (jq, jk, jv), (tq, tk, tv) = _qkv(0, *case[:6], dtype)
    # One block per sequence when the length is ragged (Pallas needs exact blocks).
    bq, bk = (128, 128) if S % 128 == 0 and Sk % 128 == 0 else (S, Sk)
    want = jax_flash(jq, jk, jv, causal=causal, block_q=bq, block_k=bk, interpret=True)
    got = tref.reference_attention(tq, tk, tv, causal=causal)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _close(_np(got), want, TOL[dtype])
    _close(_np(ops.attention(tq, tk, tv, causal=causal)), want, TOL[dtype])
    _close(_np(got), jref.reference_attention(jq, jk, jv, causal=causal), TOL[dtype])


def _chunk_choices(S, Sk):
    """(q_chunk, kv_chunk) pairs that cut both sequences into several blocks."""
    out = []
    for qd, kd in ((4, 2), (2, 4), (1, 1)):
        qc = tmod.pick_chunk(S, max(1, S // qd))
        kc = tmod.pick_chunk(Sk, max(1, Sk // kd))
        out.append((qc, kc))
    return out


@pytest.mark.parametrize("case", ATTN_CASES, ids=_ids)
def test_cpu_chunked_attention_matches_jax(case):
    B, S, Sk, H, Hk, hd, causal, dtype = case
    (jq, jk, jv), (tq, tk, tv) = _qkv(1, *case[:6], dtype)
    for qc, kc in _chunk_choices(S, Sk):
        want = jattn.chunked_attention(jq, jk, jv, causal=causal, q_chunk=qc, kv_chunk=kc)
        got = tattn.chunked_attention(tq, tk, tv, causal=causal, q_chunk=qc, kv_chunk=kc)
        assert got.dtype == tq.dtype
        _close(_np(got), want, TOL[dtype])


def test_chunked_attention_rejects_chunks_that_do_not_divide():
    _, (tq, tk, tv) = _qkv(2, 1, 200, 200, 4, 2, 16, "float32")
    with pytest.raises(ValueError, match="divide"):
        tattn.chunked_attention(tq, tk, tv, q_chunk=64, kv_chunk=50)


def test_flash_wrapper_refuses_cpu_tensors():
    _, (tq, tk, tv) = _qkv(3, 1, 64, 64, 4, 2, 64, "float32")
    before = dict(tfa.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tfa.flash_attention(tq, tk, tv)
    assert tfa.LAUNCHES == before


# The bf16 shapes that chip_smoke.py and tests/test_torch_cuda.py run through
# the tensor-core body: every head dim, ragged causal with 8 query heads a KV
# head, MQA and non-causal with S != Sk.  Here the plain version (the card's
# reference) against the JAX package.
ATTN_BF16_CASES = [
    (1, 256, 256, 4, 2, 32, True, "bfloat16"),
    (1, 256, 256, 4, 2, 64, True, "bfloat16"),
    (2, 100, 37, 8, 2, 160, True, "bfloat16"),
    (1, 200, 200, 32, 4, 64, True, "bfloat16"),
    (2, 128, 256, 4, 4, 64, False, "bfloat16"),
    (1, 128, 128, 4, 1, 32, True, "bfloat16"),
]


@pytest.mark.parametrize("case", ATTN_BF16_CASES, ids=_ids)
def test_reference_attention_matches_jax_flash_bf16(case):
    B, S, Sk, H, Hk, hd, causal, dtype = case
    (jq, jk, jv), (tq, tk, tv) = _qkv(4, *case[:6], dtype)
    bq, bk = (128, 128) if S % 128 == 0 and Sk % 128 == 0 else (S, Sk)
    want = jax_flash(jq, jk, jv, causal=causal, block_q=bq, block_k=bk, interpret=True)
    got = ops.attention(tq, tk, tv, causal=causal)
    assert got.dtype == torch.bfloat16 and got.shape == tq.shape
    _close(_np(got), want, TOL[dtype])


def test_flash_bodies_by_dtype_and_reset():
    """bf16 runs the tensor-core body, f32 the FMA body; reset_launches
    zeroes both counts."""
    assert tfa.BODIES == {torch.bfloat16: "tensor_core", torch.float32: "fma"}
    tfa.LAUNCHES["flash_attention"] += 2
    tfa.LAUNCHES["flash_attention_bwd"] += 1
    tfa.BODY_LAUNCHES["tensor_core"] += 2
    tfa.reset_launches()
    assert tfa.LAUNCHES == {"flash_attention": 0, "flash_attention_bwd": 0}
    assert tfa.BODY_LAUNCHES == {"tensor_core": 0, "fma": 0}


# -------------------------------------------------------------------- modules


def _mod_inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 6, 4, 16)).astype(np.float32)
    h = rng.standard_normal((2, 6, 32)).astype(np.float32)
    p = {"scale": rng.uniform(0.5, 1.5, 32).astype(np.float32),
         "bias": rng.standard_normal(32).astype(np.float32)}
    mp = {k: (rng.standard_normal(s) * 0.2).astype(np.float32) for k, s in
          {"w_gate": (32, 48), "w_up": (32, 48), "w_down": (48, 32),
           "b_up": (48,), "b_down": (32,)}.items()}
    ids = rng.integers(0, 50, size=(2, 6)).astype(np.int32)
    table = rng.standard_normal((50, 32)).astype(np.float32)
    return x, h, p, mp, ids, table


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _t(tree):
    return jax.tree_util.tree_map(torch.from_numpy, tree)


MODULE_CHECKS = {
    "rmsnorm": lambda m, h, p: m.rmsnorm(p, h),
    "layernorm": lambda m, h, p: m.layernorm(p, h),
    "make_norm": lambda m, h, p: m.make_norm("layernorm")[1](p, h * 3.0),
    "swiglu": lambda m, h, p: m.swiglu(h, h * 0.5 + 1.0),
}


@pytest.mark.parametrize("name", sorted(MODULE_CHECKS))
def test_norms_and_activations_match_jax(name):
    _, h, p, *_ = _mod_inputs()
    fn = MODULE_CHECKS[name]
    _close(_np(fn(tmod, torch.from_numpy(h), _t(p))), fn(jmod, jnp.asarray(h), _j(p)), 1e-6)


@pytest.mark.parametrize("activation", ["swiglu", "gelu"])
def test_mlp_matches_jax(activation):
    _, h, _, mp, *_ = _mod_inputs(1)
    if activation == "swiglu":
        mp = {k: mp[k] for k in ("w_gate", "w_up", "w_down")}
    else:
        mp = {k: mp[k] for k in ("w_up", "b_up", "w_down", "b_down")}
    want = jmod.mlp(_j(mp), jnp.asarray(h), activation)
    _close(_np(tmod.mlp(_t(mp), torch.from_numpy(h), activation)), want, 1e-6)


@pytest.mark.parametrize("positions", ["row", "per_batch"])
def test_rope_matches_jax(positions):
    x, *_ = _mod_inputs(2)
    pos = (np.arange(6)[None, :] if positions == "row"
           else np.array([[3], [17]]) + np.zeros((2, 6), np.int64)).astype(np.int32)
    _close(tmod.rope_freqs(16, 1e6).numpy(), jmod.rope_freqs(16, 1e6), 1e-6)
    want = jmod.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    got = tmod.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0)
    _close(_np(got), want, 1e-6)


def test_embedding_and_pick_chunk_match_jax():
    *_, ids, table = _mod_inputs(3)
    want = jmod.embedding_lookup({"table": jnp.asarray(table)}, jnp.asarray(ids))
    got = tmod.embedding_lookup({"table": torch.from_numpy(table)}, torch.from_numpy(ids))
    _close(_np(got), want, 0.0)
    for S in (1, 7, 200, 3840, 4096):
        for target in (1, 64, 128, 1024):
            assert tmod.pick_chunk(S, target) == jmod.pick_chunk(S, target)
    with pytest.raises(ValueError):
        tmod.make_norm("batchnorm")


def test_initialisers_draw_from_the_generator():
    gen = torch.Generator().manual_seed(0)
    w = tmod.lecun_normal(gen, (512, 256), torch.bfloat16)
    e = tmod.embed_init(gen, (1000, 64), torch.float32)
    assert w.dtype == torch.bfloat16 and e.dtype == torch.float32
    assert abs(float(w.float().std()) - 1 / np.sqrt(512)) < 2e-3
    assert abs(float(e.std()) - 0.02) < 1e-3
    again = tmod.lecun_normal(torch.Generator().manual_seed(0), (512, 256), torch.bfloat16)
    assert torch.equal(w, again)
    meta = tmod.lecun_normal(None, (4, 4), torch.float32, device="meta")
    assert meta.device.type == "meta"


# ------------------------------------------------------------------- configs


def test_all_archs_same_names():
    assert sorted(torch_archs()) == sorted(jax_archs())


@pytest.mark.parametrize("name", sorted(jax_archs()))
def test_arch_config_fields_equal(name):
    j, t = jax_archs()[name], torch_archs()[name]
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(t.reduced()) == dataclasses.asdict(j.reduced())
    assert (t.hd, t.n_heads_eff, t.n_kv_heads_eff, t.sub_quadratic) == (
        j.hd, j.n_heads_eff, j.n_kv_heads_eff, j.sub_quadratic)


# ------------------------------------------------------------ whole model


@functools.lru_cache(maxsize=None)
def _model(name):
    """(JAX cfg, JAX params, port cfg, port params) of the reduced arch."""
    jc, tc = jax_archs()[name].reduced(), torch_archs()[name].reduced()
    jp = jlm.init_params(jc, jax.random.PRNGKey(0))
    tp = lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    return jc, jp, tc, tp


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)


@pytest.mark.parametrize("name", DENSE)
def test_forward_and_prefill_logits_match_jax(name):
    jc, jp, tc, tp = _model(name)
    toks = _tokens(jc, 2, 48)
    jx, jaux = jtr.forward(jp, jnp.asarray(toks), jc)
    tx, taux = ttr.forward(tp, torch.from_numpy(toks), tc)
    _close(_np(tx), jx, 1e-4)
    assert float(taux) == float(jaux) == 0.0
    want = jlm.prefill_logits(jp, {"tokens": jnp.asarray(toks)}, jc)
    got = tlm.prefill_logits(tp, {"tokens": torch.from_numpy(toks)}, tc)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, jc.vocab_size)
    _close(_np(got), want, 1e-4)


@pytest.mark.parametrize("name", DENSE)
def test_decode_steps_match_jax(name):
    jc, jp, tc, tp = _model(name)
    toks = _tokens(jc, 2, 6, seed=1)
    jstep = jax.jit(lambda p, c, t, pos: jlm.decode_step(p, c, t, pos, jc))
    jcache = jlm.init_cache(jc, 2, 16)
    tcache = tlm.init_cache(tc, 2, 16, device="cpu")
    for pos in range(toks.shape[1]):
        jlog, jcache = jstep(jp, jcache, jnp.asarray(toks[:, pos]), pos)
        tlog, tcache = tlm.decode_step(tp, tcache, torch.from_numpy(toks[:, pos]), pos, tc)
        _close(_np(tlog), jlog, 1e-4)
    for k in ("k", "v"):
        assert tuple(tcache[k].shape) == jcache[k].shape
        _close(_np(tcache[k]), jcache[k], 1e-4)


@pytest.mark.parametrize("name", DENSE)
def test_capture_prefill_matches_jax(name):
    jc, jp, tc, tp = _model(name)
    toks = _tokens(jc, 2, 6, seed=2)  # the JAX side replays each step eagerly
    jlog, jcache = jeng.capture_prefill(jc, jp, jnp.asarray(toks), 16)
    tlog, tcache = teng.capture_prefill(tc, tp, torch.from_numpy(toks), 16)
    _close(_np(tlog), jlog, 1e-4)
    for k in ("k", "v"):
        _close(_np(tcache[k]), jcache[k], 1e-4)
    # The last decode step sees the same prefix as the prefill's last row.
    dlog, _ = tlm.decode_step(tp, tcache, torch.from_numpy(toks[:, -1]), 5, tc)
    _close(_np(dlog), _np(tlog[:, 0]), 1e-4)


@pytest.mark.parametrize("name", DENSE)
def test_serve_engine_token_ids_equal_jax(name):
    """The requests of tests/test_substrates.py::test_serve_engine_batched_decode."""
    jc, jp, tc, tp = _model(name)

    def requests(Request):
        return [Request(rid=0, prompt=np.array([1, 2, 3], np.int32), max_new=4),
                Request(rid=1, prompt=np.array([4, 5], np.int32), max_new=4)]

    want = jeng.ServeEngine(jc, jp, batch_capacity=2, max_seq=32).run(requests(jeng.Request))
    got = teng.ServeEngine(tc, tp, batch_capacity=2, max_seq=32).run(requests(teng.Request))
    assert [(r.rid, r.out) for r in got] == [(r.rid, r.out) for r in want]
    assert all(len(r.out) == 4 and all(0 <= t < tc.vocab_size for t in r.out) for r in got)


def test_params_convert_with_dtypes_kept():
    jc = dataclasses.replace(jax_archs()["tinyllama-1.1b"].reduced(), dtype="bfloat16")
    jp = jlm.init_params(jc, jax.random.PRNGKey(1))
    tp = lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    jl, tl = jax.tree_util.tree_leaves(jp), jax.tree_util.tree_leaves(tp)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert b.dtype == torch.bfloat16 and tuple(b.shape) == a.shape
        np.testing.assert_array_equal(b.float().numpy(), np.asarray(a, np.float32))
    assert tp["blocks"]["attn"]["wq"].shape[0] == jc.n_layers  # stacked blocks


@pytest.mark.parametrize("name", DENSE + ["stablelm-12b"])
def test_param_count_matches_jax(name):
    assert tlm.param_count(torch_archs()[name]) == jlm.param_count(jax_archs()[name])


def test_random_init_has_the_jax_layout():
    tc = torch_archs()["qwen1.5-0.5b"].reduced()
    jc = jax_archs()["qwen1.5-0.5b"].reduced()
    tp = tlm.init_params(tc, torch.Generator().manual_seed(0))
    jp = jlm.init_params(jc, jax.random.PRNGKey(0))
    tflat = jax.tree_util.tree_flatten_with_path(tp)[0]
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert [(jax.tree_util.keystr(p), tuple(v.shape)) for p, v in tflat] == [
        (jax.tree_util.keystr(p), v.shape) for p, v in jflat]


@pytest.mark.parametrize("name", NOT_DENSE)
def test_other_families_raise_not_implemented(name):
    cfg = torch_archs()[name].reduced()
    with pytest.raises(NotImplementedError, match="ROADMAP A6"):
        tlm.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="ROADMAP A6"):
        tlm.init_cache(cfg, 1, 8, device="cpu")


def test_ssm_family_builds_and_runs():
    """rwkv6-7b is ported (tests/test_torch_rwkv.py holds it against the
    JAX package): it builds, prefills and decodes instead of raising."""
    cfg = torch_archs()["rwkv6-7b"].reduced()
    params = tlm.init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.from_numpy(_tokens(cfg, 2, 8))
    logits = tlm.prefill_logits(params, {"tokens": toks}, cfg)
    cache = tlm.init_cache(cfg, 2, 8, device="cpu")
    step, cache = tlm.decode_step(params, cache, toks[:, 0], 0, cfg)
    assert tuple(logits.shape) == tuple(step.shape) == (2, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all()) and bool(torch.isfinite(step).all())
    assert sorted(cache) == ["cm_x", "tm_state", "tm_x"]


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a card")
    cfg = torch_archs()["tinyllama-1.1b"].reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tlm.init_cache(cfg, 1, 8)
    from repro_torch.launch import serve

    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "tinyllama-1.1b"])


def test_launch_serve_on_cpu(capsys):
    from repro_torch.launch import serve

    serve.main(["--arch", "tinyllama-1.1b", "--device", "cpu", "--requests", "3",
                "--max-new", "3"])
    out = capsys.readouterr().out
    assert "arch=tinyllama-1.1b on cpu: served 3 requests, 9 tokens" in out
