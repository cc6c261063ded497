"""The port's ssm family (RWKV-6) against the JAX package, on the CPU.

Inputs are drawn with numpy from a seed and handed to both packages; the
JAX parameters are carried across with ``convert.lm_params_from_jax``.
Tolerances: the WKV recurrence as ``tests/test_kernels.py`` (1e-4 in f32,
5e-2 in bf16, 1e-3 for the extreme-decay clamped case); the time-mix and
channel-mix modules 1e-6, the whole block 1e-5 (it chains both through two
norms and seven matmuls, and its output adds the residual of magnitude ~4);
whole-model hidden states, logits and recurrent states 1e-4 (f32, reduced
configs: the two packages sum matmuls in different orders); generated token
ids and parameter counts exactly.  The CUDA kernel itself runs only on a
card: ``tests/test_torch_cuda.py`` holds it against the plain version there.
"""

import dataclasses
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import all_archs as jax_archs
from repro.kernels import ref as jref
from repro.kernels.rwkv_scan import rwkv_scan as jax_rwkv_scan
from repro.models import lm as jlm
from repro.models import rwkv as jrwkv
from repro.models import scan_utils as jscan
from repro.models import transformer as jtr
from repro.serve import engine as jeng
from repro_torch.configs.base import all_archs as torch_archs
from repro_torch.convert import lm_params_from_jax
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rwkv_scan as trs
from repro_torch.models import lm as tlm
from repro_torch.models import rwkv as trwkv
from repro_torch.models import scan_utils as tscan
from repro_torch.models import transformer as ttr
from repro_torch.serve import engine as teng

ARCH = "rwkv6-7b"

# tests/test_kernels.py RWKV_CASES.
RWKV_CASES = [
    # (B, S, H, N, chunk, dtype)
    (1, 64, 2, 16, 16, "float32"),
    (2, 128, 4, 32, 32, "float32"),
    (1, 128, 2, 64, 64, "float32"),
    (1, 256, 2, 16, 64, "float32"),  # multiple chunks
    (1, 128, 2, 32, 32, "bfloat16"),
]
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _ids(case):
    return "-".join(map(str, case))


def _rwkv_inputs(seed, B, S, H, N, dtype):
    """The distributions of tests/test_kernels.py (decays in (0.7, 1.0)), as
    (JAX arrays, torch tensors)."""
    rng = np.random.default_rng(seed)
    r = rng.standard_normal((B, S, H, N)).astype(np.float32) * 0.5
    k = rng.standard_normal((B, S, H, N)).astype(np.float32) * 0.5
    v = rng.standard_normal((B, S, H, N)).astype(np.float32)
    w = (1.0 / (1.0 + np.exp(-(rng.standard_normal((B, S, H, N)) + 2.0)))).astype(np.float32)
    u = rng.standard_normal((H, N)).astype(np.float32) * 0.1
    jx = [jnp.asarray(a).astype(JDT[dtype]) for a in (r, k, v, w)] + [jnp.asarray(u)]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in (r, k, v, w)]
    return jx, tx + [torch.from_numpy(u)]


# ------------------------------------------------------------------- the scan


@pytest.mark.parametrize("case", RWKV_CASES, ids=_ids)
def test_reference_rwkv_matches_jax_scan(case):
    B, S, H, N, chunk, dtype = case
    jx, tx = _rwkv_inputs(0, B, S, H, N, dtype)
    want = jax_rwkv_scan(*jx, chunk=chunk, interpret=True)
    got = tref.reference_rwkv(*tx)
    assert got.dtype == tx[0].dtype and got.shape == tx[0].shape
    _close(got, want, TOL[dtype])
    _close(ops.rwkv(*tx, chunk=chunk), want, TOL[dtype])
    _close(got, jref.reference_rwkv(*jx), TOL[dtype])


def test_reference_rwkv_extreme_decay_clamped():
    """tests/test_kernels.py's extreme decays: the Pallas kernel clamps them;
    the plain recurrence on ``clamp_decay``'s decays gives the same."""
    jx, tx = _rwkv_inputs(4, 1, 32, 1, 16, "float32")
    r, k, v, _, u = tx
    w0 = np.full((1, 32, 1, 16), 1e-30, np.float32)
    want = jax_rwkv_scan(jx[0], jx[1], jx[2], jnp.asarray(w0), jx[4], chunk=16,
                         interpret=True)
    got = tref.reference_rwkv(r, k, v, tref.clamp_decay(torch.from_numpy(w0), 16), u)
    assert np.all(np.isfinite(_np(want)))
    _close(got, want, 1e-3)
    # The clamp is the Pallas wrapper's: -75 / min(16, chunk) per step.
    for chunk in (4, 16, 64):
        lw = torch.log(tref.clamp_decay(torch.from_numpy(w0), chunk))
        np.testing.assert_allclose(lw.numpy(), -75.0 / min(trs.SUB, chunk), rtol=1e-6)


def test_scan_state_variant_matches_jax_timemix_carry():
    """``reference_rwkv_state`` (and ``ops.rwkv`` with a state) from a random
    initial state against the final carry of the JAX ``timemix_apply``, on
    r/k/v/w projected by the port."""
    jc, jb, tc, tb = _block()
    p_j, p_t = jb["time_mix"], tb["time_mix"]
    rng = np.random.default_rng(5)
    B, S, D = 2, 24, jc.d_model
    N = jc.rwkv.head_dim
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    s0 = rng.standard_normal((B, D // N, N, N)).astype(np.float32) * 0.3
    xp = rng.standard_normal((B, D)).astype(np.float32)
    _, (jstate, _) = jrwkv.timemix_apply(p_j, jnp.asarray(x), jc, jnp.asarray(s0),
                                         jnp.asarray(xp))
    r, k, v, w = _projections(p_t, torch.from_numpy(x), torch.from_numpy(xp), tc)
    y, state = tref.reference_rwkv_state(r, k, v, w, p_t["u"], torch.from_numpy(s0))
    _close(state, jstate, 1e-4)
    y2, state2 = ops.rwkv(r, k, v, w, p_t["u"], state=torch.from_numpy(s0))
    assert torch.equal(y2, y) and torch.equal(state2, state)


def _projections(p, x, x_prev, cfg):
    """r, k, v, w of ``timemix_apply`` (the port's arithmetic, unrolled)."""
    B, S, D = x.shape
    N = cfg.rwkv.head_dim
    xs = torch.cat([x_prev[:, None], x[:, :-1]], dim=1)

    def mixed(mu):
        return x + (xs - x) * p[mu]

    shape = (B, S, D // N, N)
    r = (mixed("mu_r") @ p["wr"]).reshape(shape)
    k = (mixed("mu_k") @ p["wk"]).reshape(shape)
    v = (mixed("mu_v") @ p["wv"]).reshape(shape)
    lora = (mixed("mu_w") @ p["wA"]) @ p["wB"]
    w = torch.exp(-torch.exp(p["w0"] + lora)).reshape(shape)
    return r, k, v, w


def test_chunked_scan_matches_jax():
    rng = np.random.default_rng(6)

    def jstep(c, x):
        return c * 0.9 + x[0] * x[1], c + x[1]

    def tstep(c, x):
        return c * 0.9 + x[0] * x[1], c + x[1]

    for S in (1, 40, 64, 192):
        a, b = (rng.standard_normal((S, 3)).astype(np.float32) for _ in range(2))
        c0 = rng.standard_normal(3).astype(np.float32)
        jc, jys = jscan.chunked_scan(jstep, jnp.asarray(c0), (jnp.asarray(a), jnp.asarray(b)))
        tc, tys = tscan.chunked_scan(tstep, torch.from_numpy(c0),
                                     (torch.from_numpy(a), torch.from_numpy(b)))
        _close(tc, jc, 1e-6)
        _close(tys, jys, 1e-6)
    # The reference's check: longer than a chunk means whole chunks.
    with pytest.raises(ValueError, match="not divisible"):
        tscan.chunked_scan(tstep, torch.zeros(3), (torch.zeros(100, 3),) * 2)


def test_wkv_wrapper_refuses_cpu_tensors():
    _, tx = _rwkv_inputs(7, 1, 16, 2, 16, "float32")
    before = dict(trs.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensor"):
        trs.rwkv_scan(*tx)
    assert trs.LAUNCHES == before


@pytest.mark.parametrize("N", [16, 32, 64])
@pytest.mark.parametrize("with_state", [False, True])
def test_ops_rwkv_mixed_dtypes_equal_f32_on_upcast(N, with_state):
    """bf16 r/k/v with f32 w (the model's dtypes on the card) give, on the
    CPU, bit for bit the all-f32 call on the widened values, with y rounded
    to bf16 once: the function the kernel computes from the same operands."""
    _, tx = _rwkv_inputs(8, 2, 40, 2, N, "float32")
    r, k, v, w, u = tx
    rb, kb, vb = (t.bfloat16() for t in (r, k, v))
    s0 = (torch.from_numpy(np.random.default_rng(9).standard_normal((2, 2, N, N))
                           .astype(np.float32)) if with_state else None)
    got = ops.rwkv(rb, kb, vb, w, u, state=s0)
    want = ops.rwkv(rb.float(), kb.float(), vb.float(), w, u, state=s0)
    if with_state:
        (got, got_s), (want, want_s) = got, want
        assert got_s.dtype == torch.float32 and torch.equal(got_s, want_s)
    assert got.dtype == torch.bfloat16 and got.shape == rb.shape
    assert torch.equal(got, want.bfloat16())


_WKV_DTYPES = [torch.float32, torch.bfloat16, torch.float16]


@pytest.mark.parametrize("rkv", _WKV_DTYPES, ids=str)
@pytest.mark.parametrize("w_dtype", _WKV_DTYPES, ids=str)
def test_wkv_wrapper_takes_exactly_three_dtype_combinations(rkv, w_dtype, monkeypatch):
    """r/k/v and w all f32, all bf16, or bf16 with f32 w; any other
    combination raises TypeError before the library is built or loaded."""
    _, tx = _rwkv_inputs(10, 1, 16, 2, 16, "float32")
    r, k, v, w, u = tx

    def no_build(*_a, **_k):
        raise AssertionError("the kernel library was asked for")

    monkeypatch.setattr(trs, "_lib", no_build)
    args = (r.to(rkv), k.to(rkv), v.to(rkv), w.to(w_dtype), u)
    accepted = {(torch.float32, torch.float32): "float32",
                (torch.bfloat16, torch.bfloat16): "bfloat16",
                (torch.bfloat16, torch.float32): "mixed"}
    before = dict(trs.DTYPE_LAUNCHES)
    if (rkv, w_dtype) in accepted:
        assert trs.dtype_code(*args[:4])[1] == accepted[(rkv, w_dtype)]
        with pytest.raises(ValueError, match="CUDA tensor"):  # CPU tensors, past the dtypes
            trs.rwkv_scan(*args)
    else:
        with pytest.raises(TypeError, match="differ"):
            trs.dtype_code(*args[:4])
        with pytest.raises(TypeError, match="differ"):
            trs.rwkv_scan(*args)
    assert trs.DTYPE_LAUNCHES == before


def test_wkv_wrapper_refuses_r_k_v_of_different_dtypes():
    _, tx = _rwkv_inputs(11, 1, 16, 2, 16, "float32")
    r, k, v, w, u = tx
    for args in ((r.bfloat16(), k, v.bfloat16(), w), (r, k.bfloat16(), v, w),
                 (r.bfloat16(), k.bfloat16(), v, w)):
        with pytest.raises(TypeError, match="differ"):
            trs.rwkv_scan(*args, u)


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_reckons_wkv_bytes_per_operand_dtype():
    """The WKV bound counts r/k/v/y at their own width and w at its own."""
    cs = _chip_smoke()
    B, S, H, N = 4, 512, 64, 64
    state = 4 * H * N + 2 * 4 * B * H * N * N  # u, initial and final state
    f32 = cs.rwkv_work(B, S, H, N, 64, 4, 4, True)
    mixed = cs.rwkv_work(B, S, H, N, 64, 2, 4, True)
    assert f32[1] == 5 * 4 * B * S * H * N + state
    assert mixed[1] == (4 * 2 + 4) * B * S * H * N + state
    assert mixed[0] == f32[0]  # the same operations


def test_chip_smoke_reckons_wkv_backward_work():
    """The WKV backward's bound at the training shape: 22 bytes an element
    with bf16 r/k/v/dy/dr/dk/dv and f32 w/dw (46.1 MB), 14 N^2 + 14 N flops a
    token and head; states and their gradients counted only when given."""
    cs = _chip_smoke()
    B, S, H, N = 1, 512, 64, 64
    flops, nbytes = cs.rwkv_bwd_work(B, S, H, N, 2, 4, False, False, False)
    assert nbytes == 22 * B * S * H * N + 2 * 4 * H * N
    assert flops == B * S * H * (14 * N * N + 14 * N)
    assert cs.rwkv_bwd_work(B, S, H, N, 4, 4, True, True, True)[1] == (
        36 * B * S * H * N + 2 * 4 * H * N + 3 * 4 * B * H * N * N)
    assert cs.RWKV_BWD_MAIN[:5] == (1, 512, 64, 64, "mixed")
    cases = cs.RWKV_BWD_CASES
    assert {c[4] for c in cases} == {"float32", "bfloat16", "mixed"}
    assert {(c[6], c[7]) for c in cases} == {(a, b) for a in (False, True)
                                           for b in (False, True)}
    assert {c[5] for c in cases} >= {"1e-30", "-5", "-8", "straddle"}
    assert any(c[1] % 8 for c in cases) and any(c[1] < 8 for c in cases)


def test_chip_smoke_counts_tensor_core_instructions_per_kernel():
    cs = _chip_smoke()
    sass = """
        Function : _ZN12_GLOBAL__N_125flash_fwd_bf16_mma_kernelILi64ELb1EEEvPK
        /*0100*/   HMMA.16816.F32.BF16 R4, R12, R20, R4 ;
        /*0110*/   FFMA R1, R2, R3, R1 ;
        /*0120*/   HMMA.16816.F32.BF16 R8, R12, R22, R8 ;
        Function : _ZN12_GLOBAL__N_127flash_fwd_tf32x3_mma_kernelILi64ELb0EEEvPKfS2_S2_Pf
        /*0100*/   HMMA.1688.F32.TF32 R4, R12, R20, R4 ;
        Function : _ZN12_GLOBAL__N_122flash_fwd_merge_kernelEPKfS1_PfS2_liiii
        /*0100*/   FFMA R1, R2, R3, R1 ;
        Function : _ZN12_GLOBAL__N_116rwkv_scan_kernelIffLi64EEEvPKT_
        /*0200*/   HMMA.1688.F32.TF32 R4, R12, R20, R4 ;
    """
    counts = cs.sass_tensor_core_counts(sass)
    assert list(counts.values()) == [2, 1, 0, 1]
    names = list(counts)
    # Both forward bodies are held to their HMMA; the merge kernel, which
    # holds no product, is not.
    assert [cs.TENSOR_CORE_KERNELS["flash_attention"] in n for n in names[:3]] == [
        True, True, False]
    assert cs.TENSOR_CORE_KERNELS["rwkv_scan"] in names[3]


def _fake_profiled_torch(traces):
    """A stand-in for torch whose profiler hands out ``traces`` in turn, each
    a list of (kernel name, launches, device µs) rows; returns it and the
    number of traces taken so far."""
    from types import SimpleNamespace

    taken = [0]

    class Profile:
        def __init__(self, activities):
            assert activities == ["cuda"]

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            taken[0] += 1

        def key_averages(self):
            return [SimpleNamespace(key=k, count=n, self_device_time_total=us)
                    for k, n, us in traces[taken[0] - 1]]

    fake = SimpleNamespace(
        cuda=SimpleNamespace(synchronize=lambda: None),
        profiler=SimpleNamespace(ProfilerActivity=SimpleNamespace(CUDA="cuda"),
                                 profile=Profile))
    return fake, taken


@pytest.mark.parametrize("traces, want_ms, want_taken", [
    # a full trace at once is read and no other is taken
    ([[("rwkv_scan_kernel", 10, 200.0), ("fill", 10, 50.0)]], 0.02, 1),
    # a trace that lost every launch is taken again
    ([[("fill", 10, 50.0)], [("rwkv_scan_kernel", 10, 300.0)]], 0.03, 2),
    # traces that keep losing launches: the fullest one, over what it holds
    ([[("rwkv_scan_kernel", 2, 40.0)], [("rwkv_scan_kernel", 5, 150.0)],
      [], [("rwkv_scan_kernel", 4, 40.0)]], 0.03, 4),
])
def test_chip_smoke_device_ms_takes_a_lossy_trace_again(traces, want_ms, want_taken):
    """CUPTI may drop kernel records; device_ms traces again rather than
    reading a short trace or handing the case to another clock."""
    cs = _chip_smoke()
    fake, taken = _fake_profiled_torch(traces)
    got = cs.device_ms(fake, lambda: None, 10, "rwkv_scan")
    assert got == pytest.approx(want_ms) and taken[0] == want_taken


def test_chip_smoke_device_ms_fails_when_no_trace_holds_the_kernel(capsys):
    """When every trace misses the named kernel, the profiler's reading
    fails: device_ms returns None after PROFILE_ATTEMPTS traces and says so,
    and the caller times the case with CUDA events (as for the plain
    versions, whose empty traces are no kernel of the port's)."""
    cs = _chip_smoke()
    fake, taken = _fake_profiled_torch([[("fill", 10, 50.0)]] * cs.PROFILE_ATTEMPTS)
    assert cs.device_ms(fake, lambda: None, 10, "rwkv_scan") is None
    assert taken[0] == cs.PROFILE_ATTEMPTS
    assert "*rwkv_scan*" in capsys.readouterr().out
    fake, taken = _fake_profiled_torch([[]] * cs.PROFILE_ATTEMPTS)
    assert cs.device_ms(fake, lambda: None, 10) is None
    fake, _ = _fake_profiled_torch([[("a", 3, 30.0), ("b", 1, 10.0)]])
    assert cs.device_ms(fake, lambda: None, 10) == pytest.approx(0.004)


def test_chip_smoke_reads_the_backward_body_from_the_traced_names():
    """device_ms hands back the names of the kernels it matched in the trace
    it read (the fullest), and traced_bwd_body reads the flash-attention
    backward's body from them, as the C entry reports it (``bwd_body``)."""
    cs = _chip_smoke()
    dot, red = "flash_bwd_dot_kernel<bf16>", "flash_bwd_reduce_kernel<bf16>"
    wide = ["void (anonymous namespace)::flash_bwd_dkdv_wgmma_kernel<128, true>(...)",
            "void (anonymous namespace)::flash_bwd_dq_wgmma_kernel<128, true>(...)"]
    fake, taken = _fake_profiled_torch([
        [(dot, 2, 10.0)],
        [(dot, 10, 50.0), (wide[0], 10, 600.0), (wide[1], 10, 400.0), (red, 10, 50.0),
         ("fill", 10, 5.0)]])
    names = []
    assert cs.device_ms(fake, lambda: None, 10, "flash_bwd", per_call=4,
                        names=names) == pytest.approx(0.11)
    assert taken[0] == 2 and names == [dot, *wide, red]
    assert cs.traced_bwd_body(names) == cs.bwd_body("bfloat16", 128) == "wgmma"
    assert cs.bwd_body("bfloat16", 160) == "wgmma"
    four = ["flash_bwd_dkdv_wgmma_kernel<64, true>", "flash_bwd_dq_wgmma_kernel<64, true>"]
    assert cs.traced_bwd_body(four) == cs.bwd_body("bfloat16", 64) == "wgmma"
    tf32 = ["flash_bwd_dkdv_tf32x3_wgmma_kernel<64, false>",
            "flash_bwd_dq_tf32x3_wgmma_kernel<64, false>"]
    assert cs.traced_bwd_body(tf32) == cs.bwd_body("float32", 64) == "tf32x3_wgmma"
    assert cs.bwd_body("float32", 32) == "tf32x3_wgmma"
    tf32_wide = ["flash_bwd_dkdv_tf32x3_wide_mma_kernel<160, true>",
                 "flash_bwd_dq_tf32x3_wide_mma_kernel<160, true>"]
    assert cs.traced_bwd_body(tf32_wide) == cs.bwd_body("float32", 160) == "tf32x3_wide_mma"
    assert cs.bwd_body("float32", 128) == "tf32x3_wide_mma"
    assert cs.traced_bwd_body([dot, red]) is None
    assert cs.traced_bwd_body([tf32[0], four[1]]) == "tf32x3_wgmma+wgmma"


def test_wkv_reset_launches_zeroes_every_count():
    trs.LAUNCHES["rwkv_scan"] += 3
    trs.LAUNCHES["rwkv_scan_bwd"] += 1
    trs.DTYPE_LAUNCHES["mixed"] += 2
    trs.reset_launches()
    assert trs.LAUNCHES == {"rwkv_scan": 0, "rwkv_scan_bwd": 0}
    assert trs.DTYPE_LAUNCHES == {"float32": 0, "bfloat16": 0, "mixed": 0}


# ------------------------------------------------------------------ the gradient

#: The plain backward's cases: shapes (B, S, H, N) and decays -- random in
#: the trained range (sigmoid(N(2, 1)), as the forward's cases), a constant
#: log w of -5 or -8 (times U(0.9, 1.1)), and w = 1e-30.
BWD_SHAPES = [(2, 64, 2, 16), (1, 100, 2, 32)]
BWD_DECAYS = ["sigmoid", "-5", "-8", "1e-30"]


def _bwd_inputs(seed, shape, decays="sigmoid"):
    """r, k, v, w, u and dy as numpy f32, from the forward's distributions."""
    rng = np.random.default_rng(seed)
    B, S, H, N = shape
    r, k = (rng.standard_normal(shape).astype(np.float32) * 0.5 for _ in range(2))
    v = rng.standard_normal(shape).astype(np.float32)
    if decays == "sigmoid":
        w = 1.0 / (1.0 + np.exp(-(rng.standard_normal(shape) + 2.0)))
    elif decays == "1e-30":
        w = np.full(shape, 1e-30)
    else:
        w = np.exp(float(decays) * rng.uniform(0.9, 1.1, shape))
    u = rng.standard_normal((H, N)).astype(np.float32) * 0.1
    dy = rng.standard_normal(shape).astype(np.float32)
    return r, k, v, w.astype(np.float32), u, dy


def _assert_grads_close(got, want, tol, names):
    """Each gradient within ``tol`` of the largest |.| of its reference."""
    for name, g, w_ in zip(names, got, want):
        g, w_ = _np(g), _np(w_)
        assert g.shape == w_.shape, name
        scale = float(np.abs(w_).max())
        assert np.isfinite(g).all(), name
        assert float(np.abs(g - w_).max()) <= tol * scale, (name, float(np.abs(g - w_).max()),
                                                             scale)


@pytest.mark.parametrize("decays", BWD_DECAYS)
@pytest.mark.parametrize("shape", BWD_SHAPES, ids=_ids)
def test_reference_rwkv_backward_matches_jax_vjp(shape, decays):
    """The plain reverse recurrence (the WKV backward kernel's oracle) is
    the gradient the JAX package takes of its sequential recurrence, for any
    decay: w = 1e-30 too, where dw stays finite."""
    r, k, v, w, u, dy = _bwd_inputs(20, shape, decays)
    _, vjp = jax.vjp(jref.reference_rwkv, *map(jnp.asarray, (r, k, v, w, u)))
    want = vjp(jnp.asarray(dy))
    got = tref.reference_rwkv_backward(*map(torch.from_numpy, (r, k, v, w, u)), None,
                                       torch.from_numpy(dy), None)
    assert [t.dtype for t in got] == [torch.float32] * 6
    assert tuple(got[4].shape) == u.shape and tuple(got[5].shape) == shape[:1] + (
        shape[2], shape[3], shape[3])
    _assert_grads_close(got[:5], want, 1e-5, ("dr", "dk", "dv", "dw", "du"))


@pytest.mark.parametrize("shape", BWD_SHAPES, ids=_ids)
def test_reference_rwkv_backward_matches_autograd_with_states(shape):
    """From a random initial state and with a final-state gradient: the
    plain backward against torch autograd through ``reference_rwkv_state``,
    the initial-state gradient included."""
    r, k, v, w, u, dy = _bwd_inputs(21, shape)
    B, S, H, N = shape
    rng = np.random.default_rng(22)
    s0 = torch.from_numpy(rng.standard_normal((B, H, N, N)).astype(np.float32) * 0.3)
    ds = torch.from_numpy(rng.standard_normal((B, H, N, N)).astype(np.float32))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (r, k, v, w, u)]
    s0.requires_grad_()
    y, final = tref.reference_rwkv_state(*leaves, s0)
    want = torch.autograd.grad([y, final], leaves + [s0], [torch.from_numpy(dy), ds])
    got = tref.reference_rwkv_backward(*(t.detach() for t in leaves), s0.detach(),
                                       torch.from_numpy(dy), ds)
    _assert_grads_close(got, want, 1e-5, ("dr", "dk", "dv", "dw", "du", "dstate0"))


def test_wkv_backward_wrapper_refuses_cpu_tensors():
    r, k, v, w, u, dy = map(torch.from_numpy, _bwd_inputs(23, (1, 16, 2, 16)))
    before = dict(trs.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensor"):
        trs.rwkv_scan_backward(r, k, v, w, u, None, dy, None)
    assert trs.LAUNCHES == before


def _plain_launches(monkeypatch, seen):
    """The two kernel launches of ``rwkv_scan.py`` replaced by the plain
    versions on the CPU: the forward by ``reference_rwkv_state``, the
    backward by ``reference_rwkv_backward`` with du as one partial a batch
    row, as the kernel writes it; ``seen`` records each backward's
    final-state gradient and whether an initial-state gradient was asked."""
    def run_forward(r, k, v, w, u, state, chunk, code):
        return tref.reference_rwkv_state(r, k, v, w, u, state)

    def run_backward(r, k, v, w, u, state, dy, dstate, with_dstate0):
        seen.append((dstate, with_dstate0))
        dr, dk, dv, dw, _, dstate0 = tref.reference_rwkv_backward(r, k, v, w, u, state, dy,
                                                                  dstate)
        du_part = torch.stack([tref.reference_rwkv_backward(
            *(t[b:b + 1] for t in (r, k, v, w)), u,
            None if state is None else state[b:b + 1], dy[b:b + 1],
            None if dstate is None else dstate[b:b + 1])[4] for b in range(r.shape[0])])
        return dr, dk, dv, dw, du_part, dstate0 if with_dstate0 else None

    monkeypatch.setattr(trs, "_run_forward", run_forward)
    monkeypatch.setattr(trs, "_run_backward", run_backward)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "mixed"])
@pytest.mark.parametrize("state", ["none", "given", "requires_grad"])
def test_wkv_function_wiring(dtype, state, monkeypatch):
    """``RwkvScanFn`` with its two launches replaced by the plain versions:
    gradients in the operands' dtypes, du summed over the batch, an
    initial-state gradient only when the state requires one, a None
    final-state gradient passed on as None (no zeros), one launch of each
    kernel counted."""
    seen = []
    _plain_launches(monkeypatch, seen)
    B, S, H, N = 3, 24, 2, 16
    arrs = _bwd_inputs(24, (B, S, H, N))
    dt, wdt = {"float32": (torch.float32,) * 2, "bfloat16": (torch.bfloat16,) * 2,
               "mixed": (torch.bfloat16, torch.float32)}[dtype]
    r, k, v = (torch.from_numpy(a).to(dt).requires_grad_() for a in arrs[:3])
    w = torch.from_numpy(arrs[3]).to(wdt).requires_grad_()
    u = torch.from_numpy(arrs[4]).requires_grad_()
    dy = torch.from_numpy(arrs[5]).to(dt)
    s0 = None
    if state != "none":
        s0 = torch.from_numpy(np.random.default_rng(25).standard_normal((B, H, N, N))
                              .astype(np.float32))
        s0.requires_grad_(state == "requires_grad")
    ins = [r, k, v, w, u] + ([s0] if state == "requires_grad" else [])
    before = dict(trs.LAUNCHES)
    y, final = trs.RwkvScanFn.apply(r, k, v, w, u, s0, 64)
    assert y.dtype == dt and final.dtype == torch.float32
    got = torch.autograd.grad(y, ins, dy)  # the final state unused: its gradient is None
    assert seen == [(None, state == "requires_grad")]
    assert trs.LAUNCHES == {"rwkv_scan": before["rwkv_scan"] + 1,
                            "rwkv_scan_bwd": before["rwkv_scan_bwd"] + 1}
    assert [g.dtype for g in got] == [t.dtype for t in ins]
    plain = [t.detach() for t in (r, k, v, w, u)]
    want = list(tref.reference_rwkv_backward(*plain, s0, dy, None))
    # du: the per-row partials, summed over the batch in order.
    want[4] = sum(tref.reference_rwkv_backward(
        *(t[b:b + 1] for t in plain[:4]), plain[4], None if s0 is None else s0[b:b + 1],
        dy[b:b + 1], None)[4] for b in range(B))
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)
    # With the final state used, its gradient reaches the backward.
    ds = torch.ones((B, H, N, N))
    y, final = trs.RwkvScanFn.apply(r, k, v, w, u, s0, 64)
    torch.autograd.grad([y, final], [r], [dy, ds])
    assert seen[-1][0] is not None and torch.equal(seen[-1][0], ds)


def test_timemix_state_path_grads_match_jax():
    """The time-mix from a given state, with a gradient on the returned
    state (and on y and the shifted token): the port's gradients with
    respect to the params, x and the initial state against ``jax.vjp`` of
    the JAX package's ``timemix_apply``, on converted params."""
    jc, jb, tc, tb = _block()
    x, st = _block_inputs(26, jc)
    rng = np.random.default_rng(27)
    gy = rng.standard_normal(x.shape).astype(np.float32)
    gs = rng.standard_normal(st["tm_state"].shape).astype(np.float32)
    gx = rng.standard_normal(st["tm_x"].shape).astype(np.float32)
    jp = jb["time_mix"]

    def jf(p, xx, s0):
        return jrwkv.timemix_apply(p, xx, jc, s0, jnp.asarray(st["tm_x"]))

    _, vjp = jax.vjp(jf, jp, jnp.asarray(x), jnp.asarray(st["tm_state"]))
    jgp, jgx, jgs = vjp((jnp.asarray(gy), (jnp.asarray(gs), jnp.asarray(gx))))
    tp = {k: (dict(scale=v["scale"].clone().requires_grad_()) if isinstance(v, dict)
              else v.clone().requires_grad_()) for k, v in tb["time_mix"].items()}
    tx = torch.from_numpy(x).requires_grad_()
    ts = torch.from_numpy(st["tm_state"]).requires_grad_()
    y, (s1, last) = trwkv.timemix_apply(tp, tx, tc, ts, torch.from_numpy(st["tm_x"]))
    names = sorted(k for k in tp if k != "ln_x") + ["ln_x"]
    leaves = [tp[k] if k != "ln_x" else tp[k]["scale"] for k in names]
    got = torch.autograd.grad([y, s1, last], leaves + [tx, ts],
                              [torch.from_numpy(a) for a in (gy, gs, gx)])
    want = [jgp[k] if k != "ln_x" else jgp[k]["scale"] for k in names] + [jgx, jgs]
    _assert_grads_close(got, want, 1e-4, names + ["x", "state"])


# -------------------------------------------------------------------- modules


@functools.lru_cache(maxsize=None)
def _model(name):
    """(JAX cfg, JAX params, port cfg, port params) of the reduced arch."""
    jc, tc = jax_archs()[name].reduced(), torch_archs()[name].reduced()
    jp = jlm.init_params(jc, jax.random.PRNGKey(0))
    tp = lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    return jc, jp, tc, tp


def _block(i=0):
    """Layer ``i`` of the reduced rwkv6-7b, in both packages."""
    jc, jp, tc, tp = _model(ARCH)
    return (jc, jax.tree_util.tree_map(lambda a: a[i], jp["blocks"]), tc,
            ttr._layer(tp["blocks"], i))


def _block_inputs(seed, cfg, B=2, S=12):
    rng = np.random.default_rng(seed)
    D, N = cfg.d_model, cfg.rwkv.head_dim
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    state = {"tm_state": rng.standard_normal((B, D // N, N, N)).astype(np.float32) * 0.3,
             "tm_x": rng.standard_normal((B, D)).astype(np.float32),
             "cm_x": rng.standard_normal((B, D)).astype(np.float32)}
    return x, state


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _t(tree):
    return jax.tree_util.tree_map(torch.from_numpy, tree)


@pytest.mark.parametrize("with_state", [False, True])
def test_timemix_matches_jax(with_state):
    jc, jb, tc, tb = _block()
    x, st = _block_inputs(8, jc)
    args = (st["tm_state"], st["tm_x"]) if with_state else (None, None)
    jy, (js, jx) = jrwkv.timemix_apply(jb["time_mix"], jnp.asarray(x), jc,
                                       *(None if a is None else jnp.asarray(a) for a in args))
    ty, (ts, tx) = trwkv.timemix_apply(tb["time_mix"], torch.from_numpy(x), tc,
                                       *(None if a is None else torch.from_numpy(a)
                                         for a in args))
    _close(ty, jy, 1e-6)
    _close(ts, js, 1e-6)
    _close(tx, jx, 0.0)


@pytest.mark.parametrize("with_state", [False, True])
def test_timemix_matches_jax_below_the_pallas_clamp(with_state):
    """ROADMAP C2's regime: ``w0`` shifted to log 7, so the per-step log
    decays sit near -7, below the Pallas wrapper's clamp (-75/16); the JAX
    model's scan and the port's do not clamp, and agree as at random init."""
    jc, jb, tc, tb = _block()
    jt = dict(jb["time_mix"], w0=jb["time_mix"]["w0"] + np.float32(np.log(7.0) + 6.0))
    tt = dict(tb["time_mix"], w0=tb["time_mix"]["w0"] + float(np.log(7.0) + 6.0))
    x, st = _block_inputs(10, jc)
    args = (st["tm_state"], st["tm_x"]) if with_state else (None, None)
    xp = st["tm_x"] if with_state else np.zeros_like(st["tm_x"])
    _, _, _, w = _projections(tt, torch.from_numpy(x), torch.from_numpy(xp), tc)
    lw = torch.log(w)
    # The decay LoRA of a random reduced model spreads them: -7 is the
    # median, and most sit below the clamp.
    assert float(lw.median()) == pytest.approx(-7, abs=0.5)
    assert float((lw < -75.0 / 16).float().mean()) > 0.5
    jy, (js, _) = jrwkv.timemix_apply(jt, jnp.asarray(x), jc,
                                      *(None if a is None else jnp.asarray(a) for a in args))
    ty, (ts, _) = trwkv.timemix_apply(tt, torch.from_numpy(x), tc,
                                      *(None if a is None else torch.from_numpy(a)
                                        for a in args))
    _close(ty, jy, 1e-6)
    _close(ts, js, 1e-6)


@pytest.mark.parametrize("with_state", [False, True])
def test_channelmix_matches_jax(with_state):
    jc, jb, tc, tb = _block(1)
    x, st = _block_inputs(9, jc)
    prev = st["cm_x"] if with_state else None
    jy, jx = jrwkv.channelmix_apply(jb["channel_mix"], jnp.asarray(x),
                                    None if prev is None else jnp.asarray(prev))
    ty, tx = trwkv.channelmix_apply(tb["channel_mix"], torch.from_numpy(x),
                                    None if prev is None else torch.from_numpy(prev))
    _close(ty, jy, 1e-6)
    _close(tx, jx, 0.0)


@pytest.mark.parametrize("with_state", [False, True])
def test_rwkv_block_matches_jax(with_state):
    jc, jb, tc, tb = _block()
    x, st = _block_inputs(10, jc)
    jy, jst = jrwkv.rwkv_block_apply(jb, jnp.asarray(x), jc, _j(st) if with_state else None)
    ty, tst = trwkv.rwkv_block_apply(tb, torch.from_numpy(x), tc,
                                     _t(st) if with_state else None)
    _close(ty, jy, 1e-5)
    assert sorted(tst) == sorted(jst) == ["cm_x", "tm_state", "tm_x"]
    for key in tst:
        _close(tst[key], jst[key], 1e-5)
    init = trwkv.rwkv_init_state(tc, 2, torch.float32, "cpu")
    want = jrwkv.rwkv_init_state(jc, 2, jnp.float32)
    assert {k: (tuple(v.shape), v.dtype) for k, v in init.items()} == {
        k: (v.shape, torch.float32) for k, v in want.items()}


# ------------------------------------------------------------ whole model


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)


def test_forward_and_prefill_logits_match_jax():
    jc, jp, tc, tp = _model(ARCH)
    toks = _tokens(jc, 2, 48)
    jx, jaux = jtr.forward(jp, jnp.asarray(toks), jc)
    tx, taux = ttr.forward(tp, torch.from_numpy(toks), tc)
    _close(tx, jx, 1e-4)
    assert float(taux) == float(jaux) == 0.0
    want = jlm.prefill_logits(jp, {"tokens": jnp.asarray(toks)}, jc)
    got = tlm.prefill_logits(tp, {"tokens": torch.from_numpy(toks)}, tc)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, jc.vocab_size)
    _close(got, want, 1e-4)


def test_decode_steps_match_jax_and_keep_the_cache_object():
    jc, jp, tc, tp = _model(ARCH)
    toks = _tokens(jc, 2, 6, seed=1)
    jstep = jax.jit(lambda p, c, t, pos: jlm.decode_step(p, c, t, pos, jc))
    jcache = jlm.init_cache(jc, 2, 16)
    tcache = tlm.init_cache(tc, 2, 16, device="cpu")
    first = {k: v for k, v in tcache.items()}
    for pos in range(toks.shape[1]):
        jlog, jcache = jstep(jp, jcache, jnp.asarray(toks[:, pos]), pos)
        tlog, tcache = tlm.decode_step(tp, tcache, torch.from_numpy(toks[:, pos]), pos, tc)
        _close(tlog, jlog, 1e-4)
    assert all(tcache[k] is first[k] for k in first)  # updated in place
    for k in ("tm_state", "tm_x", "cm_x"):
        assert tuple(tcache[k].shape) == jcache[k].shape
        _close(tcache[k], jcache[k], 1e-4)


def test_decode_matches_forward():
    """Teacher-forced decode step by step == the forward's logits (the JAX
    package's tests/test_models_smoke.py check, at 1e-4 in f32)."""
    _, _, tc, tp = _model(ARCH)
    toks = torch.from_numpy(_tokens(tc, 2, 10, seed=3))
    x, _ = ttr.forward(tp, toks, tc)
    full = ttr.logits_head(tp, x, tc).float()
    cache = tlm.init_cache(tc, 2, 10, device="cpu")
    for t in range(toks.shape[1]):
        logits, cache = tlm.decode_step(tp, cache, toks[:, t], t, tc)
        _close(logits, full[:, t], 1e-4)


def test_capture_prefill_matches_jax():
    jc, jp, tc, tp = _model(ARCH)
    toks = _tokens(jc, 2, 6, seed=2)  # the JAX side replays each step eagerly
    jlog, jcache = jeng.capture_prefill(jc, jp, jnp.asarray(toks), 16)
    tlog, tcache = teng.capture_prefill(tc, tp, torch.from_numpy(toks), 16)
    _close(tlog, jlog, 1e-4)
    for k in ("tm_state", "tm_x", "cm_x"):
        _close(tcache[k], jcache[k], 1e-4)
    assert bool(tcache["tm_state"].ne(0).any())


def test_serve_engine_token_ids_equal_jax():
    """The requests of tests/test_substrates.py::test_serve_engine_batched_decode.
    Admission advances the other slots' states with token 0, as in the
    reference (ROADMAP C)."""
    jc, jp, tc, tp = _model(ARCH)

    def requests(Request):
        return [Request(rid=0, prompt=np.array([1, 2, 3], np.int32), max_new=4),
                Request(rid=1, prompt=np.array([4, 5], np.int32), max_new=4)]

    want = jeng.ServeEngine(jc, jp, batch_capacity=2, max_seq=32).run(requests(jeng.Request))
    got = teng.ServeEngine(tc, tp, batch_capacity=2, max_seq=32).run(requests(teng.Request))
    assert [(r.rid, r.out) for r in got] == [(r.rid, r.out) for r in want]
    assert all(len(r.out) == 4 and all(0 <= t < tc.vocab_size for t in r.out) for r in got)


def test_params_convert_with_f32_leaves_in_a_bf16_tree():
    jc = dataclasses.replace(jax_archs()[ARCH].reduced(), dtype="bfloat16")
    jp = jlm.init_params(jc, jax.random.PRNGKey(1))
    tp = lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    jl = jax.tree_util.tree_flatten_with_path(jp)[0]
    tl = jax.tree_util.tree_leaves(tp)
    assert len(jl) == len(tl)
    f32 = set()
    for (path, a), b in zip(jl, tl):
        assert str(b.dtype).split(".")[-1] == str(a.dtype) and tuple(b.shape) == a.shape
        np.testing.assert_array_equal(b.float().numpy(), np.asarray(a, np.float32))
        if b.dtype == torch.float32:
            f32.add(jax.tree_util.keystr(path))
    assert f32 == {"['blocks']['time_mix']['u']", "['blocks']['time_mix']['w0']"}
    assert tp["blocks"]["time_mix"]["wr"].shape[0] == jc.n_layers  # stacked blocks


def test_random_init_has_the_jax_layout():
    tc, jc = torch_archs()[ARCH].reduced(), jax_archs()[ARCH].reduced()
    tc, jc = (dataclasses.replace(c, dtype="bfloat16") for c in (tc, jc))
    tp = tlm.init_params(tc, torch.Generator().manual_seed(0))
    jp = jlm.init_params(jc, jax.random.PRNGKey(0))
    tflat = jax.tree_util.tree_flatten_with_path(tp)[0]
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert [(jax.tree_util.keystr(p), tuple(v.shape), str(v.dtype).split(".")[-1])
            for p, v in tflat] == [(jax.tree_util.keystr(p), v.shape, str(v.dtype))
                                   for p, v in jflat]
    tm = ttr._layer(tp["blocks"], 0)["time_mix"]
    assert bool((tm["w0"] == -6.0).all()) and bool((tm["mu_r"] == 0.5).all())
    assert abs(float(tm["u"].std()) - 0.1) < 0.03


def test_param_count_matches_jax():
    cfg = torch_archs()[ARCH]
    assert (cfg.n_layers, cfg.d_model, cfg.rwkv.head_dim, cfg.rwkv.decay_lora) == (
        32, 4096, 64, 64)
    assert tlm.param_count(cfg) == jlm.param_count(jax_archs()[ARCH])


def test_launch_serve_rwkv_on_cpu(capsys):
    from repro_torch.launch import serve

    serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "3", "--max-new", "3"])
    out = capsys.readouterr().out
    assert f"arch={ARCH} on cpu: served 3 requests, 9 tokens" in out
