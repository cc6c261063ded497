"""The chunk form of the WKV backward, on the CPU.

``csrc/rwkv_scan_bwd.cu`` cuts each (batch, head) sequence into ranges of
``rwkv_scan.bwd_range_len`` tokens and each range into sub-chunks of 16
(``BWD_SUB``).  A first kernel walks the state forward a sub-chunk a step,
storing it before every sub-chunk, and the adjoint backward to the range
ends; a second takes each
range's sub-chunks last to first and forms dr, dk and dv as products of the
sub-chunk's state and adjoint with decay-weighted tiles -- from factors when
every column's total log decay is >= -75, pairwise otherwise, as the
forward's rule -- and dw = rowsum(G_t * S_{t-1}) from the sub-chunk's states
and adjoints walked token by token; du is one partial a range, summed in
range order.  The kernels run only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phase 27); here the range plan is held at the training
shape, and a plain torch emulation of the decomposition is held to the
port's reverse recurrence ``ref.reference_rwkv_backward``, to autograd
through ``ref.reference_rwkv_state`` and to ``jax.vjp`` of the JAX package's
``repro.kernels.ref.reference_rwkv`` on the same numpy inputs, within 1e-5
of each gradient's max |.| as ``tests/test_torch_rwkv.py`` holds the reverse
recurrence (f32 sums in another order).
"""

import importlib.util
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ref
from repro_torch.kernels import rwkv_scan as rs

H100_SMS = 132
#: The forward's rule (``csrc/rwkv_scan.cu``'s kMinFactorLogDecay).
MIN_FACTOR_LOG_DECAY = -75.0
NAMES = ("dr", "dk", "dv", "dw", "du", "dstate0")

#: (B, S, H, N): ``tests/test_torch_rwkv.py``'s backward shapes and a ragged
#: one (37 tokens: not a multiple of 16, 32 or 64).
SHAPES = [(2, 64, 2, 16), (1, 100, 2, 32), (1, 37, 3, 16)]
#: Decays: trained (sigmoid), a constant log w of -5 or -8 (times U(0.9,
#: 1.1)), w = 1e-30, and "straddle" (sigmoid with the first half of the
#: columns of every other sub-chunk at log w = -8: those sub-chunks have
#: columns on both sides of the factor bound).
DECAYS = ["sigmoid", "-5", "-8", "1e-30", "straddle"]
#: The range length: the plan's at 132 SMs (16 at these shapes), and the
#: longer ranges larger batches get, whose blocks walk several sub-chunks.
RANGE_LENS = ["plan", 32, 64]


def _inputs(seed, shape, decays="sigmoid"):
    """r, k, v, w, u and dy as numpy f32, as ``tests/test_torch_rwkv.py``
    draws them."""
    rng = np.random.default_rng(seed)
    B, S, H, N = shape
    r, k = (rng.standard_normal(shape).astype(np.float32) * 0.5 for _ in range(2))
    v = rng.standard_normal(shape).astype(np.float32)
    if decays in ("sigmoid", "straddle"):
        w = 1.0 / (1.0 + np.exp(-(rng.standard_normal(shape) + 2.0)))
        if decays == "straddle":
            for t0 in range(0, S, 2 * rs.BWD_SUB):
                w[:, t0:t0 + rs.BWD_SUB, :, :N // 2] = math.exp(-8.0)
    elif decays == "1e-30":
        w = np.full(shape, 1e-30)
    else:
        w = np.exp(float(decays) * rng.uniform(0.9, 1.1, shape))
    u = rng.standard_normal((H, N)).astype(np.float32) * 0.1
    dy = rng.standard_normal(shape).astype(np.float32)
    return r, k, v, w.astype(np.float32), u, dy


def _range_len(shape, how):
    B, S, H, _ = shape
    return rs.bwd_range_len(B, S, H, H100_SMS) if how == "plan" else how


def chunk_backward(r, k, v, w, u, state, dy, dstate, L):
    """(dr, dk, dv, dw, du, dstate0) of the WKV recurrence the way the
    kernels form them, in plain f32 torch, and the count of sub-chunk
    blocks on each branch ``{"factorised": n, "pairwise": n}``."""
    B, S, H, N = r.shape
    T = rs.BWD_SUB
    subs = L // T
    n_sub = -(-S // T)
    n_ranges = -(-S // L)
    rf, kf, vf, wf, dyf = (x.float().permute(0, 2, 1, 3) for x in (r, k, v, w, dy))
    uf = u.float()[None, :, None, :]
    low = torch.tril(torch.ones(T, T, dtype=torch.bool), -1)  # [t, s]: s < t
    branches = {"factorised": 0, "pairwise": 0}

    def tiles(j):
        """Sub-chunk j's r, k, v, w, dy (B, H, T, N), padded past S with
        r = k = v = dy = 0 and w = 1; its token count."""
        t0 = j * T
        c = min(T, S - t0)

        def pad(x, val):
            return torch.cat([x[:, :, t0:t0 + c], torch.full((B, H, T - c, N), val)], 2)

        return (pad(rf, 0.0), pad(kf, 0.0), pad(vf, 0.0), pad(wf, 1.0), pad(dyf, 0.0)), c

    def decays(wt):
        """La (inclusive), La_{t-1} and the total, per column."""
        lw = torch.clamp(torch.log(torch.clamp(wt, min=1e-30)), max=0.0)
        la = torch.cumsum(lw, 2)
        prev = torch.cat([torch.zeros_like(la[:, :, :1]), la[:, :, :-1]], 2)
        return la, prev, la[:, :, -1]

    zeros = torch.zeros((B, H, N, N))
    # The boundary walks: the state before every sub-chunk, the adjoint at
    # every range end.
    st = zeros if state is None else state.float()
    s_sub = [st]
    for j in range(n_sub - 1):
        (_, kt, vt, wt, _), _ = tiles(j)
        la, _, total = decays(wt)
        ks = kt * torch.exp(total[:, :, None] - la)
        st = torch.exp(total)[..., None] * st + ks.transpose(-1, -2) @ vt
        s_sub.append(st)
    g = zeros if dstate is None else dstate.float()
    g_bound = {n_ranges - 1: g}
    for j in range(n_sub - 1, subs - 1, -1):
        (rt, _, _, wt, dyt), _ = tiles(j)
        _, prev, total = decays(wt)
        g = torch.exp(total)[..., None] * g + (rt * torch.exp(prev)).transpose(-1, -2) @ dyt
        if j % subs == 0:
            g_bound[j // subs - 1] = g

    grads = [torch.zeros((B, H, S, N)) for _ in range(4)]
    du_parts, dstate0 = [], None
    for rg in range(n_ranges):
        j0 = rg * subs
        nsr = min(subs, n_sub - j0)
        g = g_bound[rg]
        du_r = torch.zeros((B, H, N))
        for j in reversed(range(nsr)):
            (rt, kt, vt, wt, dyt), c = tiles(j0 + j)
            s0 = s_sub[j0 + j]
            la, prev, total = decays(wt)
            fact = (total >= MIN_FACTOR_LOG_DECAY).all(-1)[..., None, None]  # (B, H, 1, 1)
            n_fact = int(fact.sum())
            branches["factorised"] += n_fact
            branches["pairwise"] += B * H - n_fact
            q = dyt @ vt.transpose(-1, -2)  # Q_ts = dy_t . v_s
            qd = torch.diagonal(q, dim1=-2, dim2=-1)[..., None]  # v_t . dy_t
            q_low = torch.where(low, q, 0.0)
            rd = rt * torch.exp(prev)
            ki = kt * torch.exp(-la)  # inf past the bound: only the factorised branch reads it
            ks = kt * torch.exp(total[:, :, None] - la)
            # Pairwise: e^{La_{t-1} - La_s} for s < t, one exp a term.
            expo = prev[:, :, :, None, :] - la[:, :, None, :, :]  # (B, H, t, s, N)
            wts = torch.exp(torch.where(low[..., None], expo, -math.inf))
            p_pair = (rt[:, :, :, None] * kt[:, :, None] * wts).sum(-1)
            dr_pair = (q_low[..., None] * kt[:, :, None] * wts).sum(3)
            dk_pair = (q_low[..., None] * rt[:, :, :, None] * wts).sum(2)
            # Factorised: the same sums from two factors.
            p_fact = torch.where(low, rd @ ki.transpose(-1, -2), 0.0)
            dr_fact = q_low @ ki
            dk_fact = torch.exp(-la) * (q_low.transpose(-1, -2) @ rd)
            p = torch.where(fact, p_fact, p_pair)
            ruk = (rt * uf * kt).sum(-1)
            base = dyt @ s0.transpose(-1, -2)  # S_0 dy_t
            dr = torch.where(fact, torch.exp(prev) * (base + dr_fact),
                             torch.exp(prev) * base + dr_pair) + uf * kt * qd
            dk = (torch.exp(total[:, :, None] - la) * (vt @ g.transpose(-1, -2))
                  + torch.where(fact, dk_fact, dk_pair) + uf * rt * qd)
            p_prime = p + torch.diag_embed(ruk)
            dv = ks @ g + p_prime.transpose(-1, -2) @ dyt
            du_r = du_r + (rt * kt * qd).sum(2)
            # dw from the sub-chunk's states and adjoints, token by token.
            hist, s_prev = [], s0
            for t in range(T):
                hist.append(s_prev)
                s_prev = wt[:, :, t, :, None] * s_prev + kt[:, :, t, :, None] * vt[:, :, t, None, :]
            dw = torch.zeros((B, H, T, N))
            for t in reversed(range(T)):
                dw[:, :, t] = (g * hist[t]).sum(-1)
                g = wt[:, :, t, :, None] * g + rt[:, :, t, :, None] * dyt[:, :, t, None, :]
            t0 = (j0 + j) * T
            for out, x in zip(grads, (dr, dk, dv, dw)):
                out[:, :, t0:t0 + c] = x[:, :, :c]
        if rg == 0:
            dstate0 = g
        du_parts.append(du_r)
    du_bh = du_parts[0]
    for part in du_parts[1:]:  # in range order
        du_bh = du_bh + part
    du = du_bh[0]
    for b in range(1, B):  # over the batch in order, as the wrapper
        du = du + du_bh[b]
    dr, dk, dv, dw = (x.permute(0, 2, 1, 3) for x in grads)
    return (dr, dk, dv, dw, du, dstate0), branches


def _assert_close(got, want, names, what, tol=1e-5):
    for name, g, w_ in zip(names, got, want):
        g = np.asarray(g.detach() if isinstance(g, torch.Tensor) else g, dtype=np.float64)
        w_ = np.asarray(w_.detach() if isinstance(w_, torch.Tensor) else w_, dtype=np.float64)
        assert g.shape == w_.shape, (what, name)
        assert np.isfinite(g).all(), (what, name)
        scale = float(np.abs(w_).max())
        err = float(np.abs(g - w_).max())
        assert err <= tol * scale, (what, name, err, scale)


def test_range_plan_at_the_training_shape():
    """One rwkv6-7b layer of a 1 x 512 micro-batch: ranges of 64 tokens, 512
    range blocks for 132 SMs; 33.5 MB of states before the sub-chunks and 8.4
    MB of adjoints at the range ends, against the 67 MB of the token-serial
    kernel's checkpoints."""
    B, S, H, N = 1, 512, 64, 64
    L = rs.bwd_range_len(B, S, H, H100_SMS)
    n_ranges = -(-S // L)
    assert L == 64 and B * H * n_ranges == 512 >= H100_SMS
    assert B * H * n_ranges * N * N * 4 == 8_388_608
    assert B * H * -(-S // rs.BWD_SUB) * N * N * 4 == 33_554_432
    # A sequence no longer than its range is one range, and needs no boundary walk.
    assert -(-60 // rs.bwd_range_len(4, 60, 64, H100_SMS)) == 1
    assert -(-7 // rs.bwd_range_len(1, 7, 2, H100_SMS)) == 1


def test_backward_kernel_names_are_the_ones_the_tooling_reads():
    """``chip_smoke.py`` finds the backward's kernels by substring: each
    name holds ``rwkv_scan_bwd`` (HMMA is required of it, and the training
    breakdown files it under wkv_bwd) and none the forward's
    ``rwkv_scan_kernel``."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    assert cs.TENSOR_CORE_KERNELS["rwkv_scan_bwd"] == "rwkv_scan_bwd"
    for name in rs.BWD_KERNELS:
        assert "rwkv_scan_bwd" in name and "rwkv_scan_kernel" not in name
        assert cs.device_kind(f"void (anonymous namespace)::{name}<float, float, 64>") == "wkv_bwd"


@pytest.mark.parametrize("sms", [132, 114, 16])
def test_range_plan_rule(sms):
    """A multiple of 16 up to 64; the longest whose blocks fill the SMs, 16
    when none does; one range exactly where S <= L."""
    for B in (1, 2, 4):
        for S in (1, 7, 16, 37, 64, 100, 300, 512, 8192):
            for H in (1, 2, 6, 40, 64):
                L = rs.bwd_range_len(B, S, H, sms)
                assert L in (16, 32, 64)
                blocks = B * H * -(-S // L)
                if L > 16:
                    assert blocks >= sms
                if L < 64:
                    assert B * H * -(-S // (2 * L)) < sms
                assert (-(-S // L) == 1) == (S <= L)


def test_chunk_form_matches_the_reverse_recurrence():
    """Every shape, decay and range length: the gradients, and which branch
    the sub-chunks took."""
    for shape in SHAPES:
        for decays in DECAYS:
            r, k, v, w, u, dy = map(torch.from_numpy, _inputs(30, shape, decays))
            want = ref.reference_rwkv_backward(r, k, v, w, u, None, dy, None)
            for range_len in RANGE_LENS:
                what = (shape, decays, range_len)
                got, branches = chunk_backward(r, k, v, w, u, None, dy, None,
                                               _range_len(shape, range_len))
                _assert_close(got, want, NAMES, what)
                if decays == "sigmoid":
                    assert branches["pairwise"] == 0, what
                elif decays in ("-8", "1e-30"):
                    # Every whole sub-chunk (a short last one may not be).
                    assert branches["pairwise"] >= (shape[0] * shape[2]
                                                    * (shape[1] // rs.BWD_SUB)), what
                elif decays == "straddle":
                    assert branches["factorised"] > 0 and branches["pairwise"] > 0, what


def test_chunk_form_matches_jax_vjp():
    """The JAX package's gradient, at the plan's range length."""
    for shape in SHAPES[:2]:
        for decays in DECAYS:
            r, k, v, w, u, dy = _inputs(31, shape, decays)
            _, vjp = jax.vjp(jref.reference_rwkv, *map(jnp.asarray, (r, k, v, w, u)))
            want = vjp(jnp.asarray(dy))
            got, _ = chunk_backward(*map(torch.from_numpy, (r, k, v, w, u)), None,
                                    torch.from_numpy(dy), None, _range_len(shape, "plan"))
            _assert_close(got[:5], want, NAMES[:5], (shape, decays))


def test_chunk_form_with_states_matches_autograd():
    """From a random initial state and with a final-state gradient, the
    initial-state gradient (the range-0 block's adjoint) included; trained
    decays with the straddling sub-chunks; every shape and range length."""
    rng = np.random.default_rng(33)
    for shape in SHAPES:
        r, k, v, w, u, dy = map(torch.from_numpy, _inputs(32, shape, "straddle"))
        B, S, H, N = shape
        s0 = torch.from_numpy(rng.standard_normal((B, H, N, N)).astype(np.float32) * 0.3)
        ds = torch.from_numpy(rng.standard_normal((B, H, N, N)).astype(np.float32))
        leaves = [t.clone().requires_grad_() for t in (r, k, v, w, u, s0)]
        y, final = ref.reference_rwkv_state(*leaves)
        want = torch.autograd.grad([y, final], leaves, [dy, ds])
        plain = ref.reference_rwkv_backward(r, k, v, w, u, s0, dy, ds)
        for range_len in RANGE_LENS:
            what = (shape, range_len)
            got, _ = chunk_backward(r, k, v, w, u, s0, dy, ds, _range_len(shape, range_len))
            _assert_close(got, want, NAMES, what)
            _assert_close(got, plain, NAMES, what)
