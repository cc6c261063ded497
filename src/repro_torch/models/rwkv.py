"""RWKV-6 "Finch" block: time-mix with data-dependent decay + channel-mix.

A transcription of ``repro/models/rwkv.py``.  Per head (dim N):

    state_t = diag(w_t) @ state_{t-1} + k_t v_t^T          (N x N state)
    y_t     = r_t @ (state_{t-1} + diag(u) k_t v_t^T)

with w_t = exp(-exp(w0 + lora_w(x_t))) the data-dependent decay.  The dtypes
are the reference's: ``w0`` and ``u`` are f32 leaves in any config, w and
the state are f32, r/k/v enter the recurrence in f32 (on the card the
kernel widens bf16 projections itself), the gate is computed in f32.  The recurrence runs
where the JAX package's scan would, by device: on a CUDA tensor a prefill
(S > 1) goes through the hand-written chunked kernel (``ops.rwkv``, which
also returns the final state; on ``meta``, the dry-run's route), a decode
step (S == 1) takes one plain step of the scan; on the CPU the transcribed
``chunked_scan`` runs, as ``ops.rwkv``'s plain version.  Under
autograd (training) the CUDA call is the same: ``ops.rwkv`` then goes
through the kernel's autograd Function, whose backward is the WKV backward
kernel; with remat (``transformer.forward``'s non-reentrant checkpoint) the
forward kernel runs twice per layer and micro-batch, the backward once.  Decode
carries (state, shift) per layer: O(1) per token.  On DTensors (a multi-rank
plan) the projections take Megatron's layout, as ``modules.mlp`` does: each
sub-layer's rows gathered once, the out-projections through ``row_project``;
plain tensors take the same ops as the JAX model's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.modules import (_device, _normal, gather_input, lecun_normal, rmsnorm,
                                       rmsnorm_init, row_project, split_heads, whole_as)
from repro_torch.models.scan_utils import check_chunk, chunked_scan

#: Time chunk of the scan (``repro/models/rwkv.py``'s ``chunked_scan(..., chunk=64)``).
CHUNK = 64


def timemix_init(gen, cfg, dtype, device=None):
    device = _device(gen, device)
    D = cfg.d_model
    N = cfg.rwkv.head_dim
    H = D // N
    L = cfg.rwkv.decay_lora

    def lecun(shape):
        return lecun_normal(gen, shape, dtype, device=device)

    def full(value):
        return torch.full((D,), value, dtype=dtype, device=device)

    return {
        "wr": lecun((D, D)),
        "wk": lecun((D, D)),
        "wv": lecun((D, D)),
        "wg": lecun((D, D)),
        "wo": lecun((D, D)),
        # data-dependent decay LoRA: w_t = exp(-exp(w0 + (x A) B))
        "w0": torch.full((D,), -6.0, dtype=torch.float32, device=device),
        "wA": lecun((D, L)),
        "wB": lecun((L, D)),
        "u": _normal(gen, (H, N), 0.1, torch.float32, device),
        # token-shift mixing coefficients
        "mu_r": full(0.5),
        "mu_k": full(0.5),
        "mu_v": full(0.5),
        "mu_g": full(0.5),
        "mu_w": full(0.5),
        "ln_x": {"scale": torch.ones((D,), dtype=dtype, device=device)},
    }


def _token_shift(x, x_prev):
    """shift: x_{t-1} for t>0; x_prev feeds position 0. x: (B,S,D)."""
    return torch.cat([x_prev[:, None, :], x[:, :-1, :]], dim=1)


def _projections(p, x, x_prev, H, N):
    """The time-mix's r, k, v (B,S,H,N), gate g (f32) and decay LoRA from x
    and its token shift, each lerp made and consumed in turn.  Megatron's
    layout on DTensors: the rows gathered once and mixed whole, so r, k, v
    and g come out split on heads as wr..wg are, and the LoRA's narrow
    (B, S, decay_lora) hidden is gathered, so its product with wB is split
    on D with no pending sum."""
    x = gather_input(x, p["wr"])
    dx = _token_shift(x, x_prev) - x

    def mixed(name):
        return x + dx * gather_input(p[name], None)

    r = split_heads(mixed("mu_r") @ p["wr"], H, N)
    k = split_heads(mixed("mu_k") @ p["wk"], H, N)
    v = split_heads(mixed("mu_v") @ p["wv"], H, N)
    g = F.silu((mixed("mu_g") @ p["wg"]).float())
    lora = gather_input(mixed("mu_w") @ p["wA"], p["wB"]) @ p["wB"]
    return r, k, v, g, lora


def _wkv_step(u):
    def step(st, inp):
        rt, kt, vt, wt = inp  # (B,H,N) each
        kv = kt[..., :, None] * vt[..., None, :]  # (B,H,N,N)
        if hasattr(rt, "placements"):
            # DTensors split over b and h: the einsum's batched product would
            # flatten two split dims, which some torch releases refuse.
            y = (rt[..., :, None] * (st + u[None, :, :, None] * kv)).sum(-2)
        else:
            y = torch.einsum("bhn,bhnm->bhm", rt, st + u[None, :, :, None] * kv)
        return wt[..., :, None] * st + kv, y

    return step


def _plain_wkv(r, k, v, w, u, state):
    """The JAX model's scan, transcribed: (y (B,S,H,N) f32, final state)."""
    xs_t = tuple(t.float().movedim(1, 0) for t in (r, k, v, w))  # (S,B,H,N)
    state, ys = chunked_scan(_wkv_step(u), state, xs_t, chunk=CHUNK)
    return ys.movedim(0, 1), state


def timemix_apply(p, x, cfg, state=None, x_prev=None):
    """x: (B,S,D) -> (y, (state, last_x)).  state: (B,H,N,N) f32."""
    B, S, D = x.shape
    N = cfg.rwkv.head_dim
    H = D // N
    if state is None:
        state = torch.zeros((B, H, N, N), dtype=torch.float32, device=x.device)
    if x_prev is None:
        x_prev = torch.zeros((B, D), dtype=x.dtype, device=x.device)

    r, k, v, g, lora = _projections(p, x, x_prev, H, N)
    # data-dependent decay in (0,1): w = exp(-exp(w0 + lora))
    w = split_heads(torch.exp(-torch.exp(p["w0"] + lora.float())), H, N)
    u = p["u"]  # (H,N)

    if x.device.type in ("cuda", "meta") and S > 1:
        # r/k/v in x's dtype: the kernel widens bf16 to f32 exactly and rounds
        # y to bf16 as ``y.to(x.dtype)`` below would, so this is the same
        # function as on the f32 projections, without three casts.
        check_chunk(S, CHUNK)
        y, state = ops.rwkv(r, k, v, w, u, chunk=CHUNK, state=state)
    elif S > 1:
        y, state = ops.rwkv(r, k, v, w, u, chunk=CHUNK, state=state, plain=_plain_wkv)
    else:
        r, k, v, w, u = (whole_as(t, state) for t in (r, k, v, w, u))
        y, state = _plain_wkv(r, k, v, w, u, state)
    y = y.reshape(B, S, D)
    y = rmsnorm(p["ln_x"], y.to(x.dtype))
    y = (y.float() * g).to(x.dtype)
    return row_project(y, p["wo"]), (state, x[:, -1, :])


def channelmix_init(gen, cfg, dtype, device=None):
    device = _device(gen, device)
    D, Fd = cfg.d_model, cfg.d_ff
    return {
        "wk": lecun_normal(gen, (D, Fd), dtype, device=device),
        "wv": lecun_normal(gen, (Fd, D), dtype, fan_in=Fd, device=device),
        "wr": lecun_normal(gen, (D, D), dtype, device=device),
        "mu_k": torch.full((D,), 0.5, dtype=dtype, device=device),
        "mu_r": torch.full((D,), 0.5, dtype=dtype, device=device),
    }


def channelmix_apply(p, x, x_prev=None):
    """Megatron's layout on DTensors: the rows gathered once, the squared
    relu on the hidden split on F (no pending sum), its product with wv
    reduce-scattered on D (``row_project``), where r is split alike."""
    B, S, D = x.shape
    if x_prev is None:
        x_prev = torch.zeros((B, D), dtype=x.dtype, device=x.device)
    k, r = _channel_hidden(p, x, x_prev)
    return r * row_project(k, p["wv"]), x[:, -1, :]


def _channel_hidden(p, x, x_prev):
    """channel-mix's relu(.)^2 hidden k and gate r, each lerp made and
    consumed in turn."""
    x = gather_input(x, p["wk"])
    dx = _token_shift(x, x_prev) - x
    k = torch.square(F.relu(((x + dx * gather_input(p["mu_k"], None)) @ p["wk"]).float()))
    k = k.to(x.dtype)
    r = torch.sigmoid(((x + dx * gather_input(p["mu_r"], None)) @ p["wr"]).float())
    r = r.to(x.dtype)
    return k, r


def rwkv_block_init(gen, cfg, dtype, device=None):
    device = _device(gen, device)
    return {
        "ln1": rmsnorm_init(cfg.d_model, dtype, device),
        "time_mix": timemix_init(gen, cfg, dtype, device=device),
        "ln2": rmsnorm_init(cfg.d_model, dtype, device),
        "channel_mix": channelmix_init(gen, cfg, dtype, device=device),
    }


def rwkv_block_apply(p, x, cfg, state=None):
    """state: None (from zeros) or dict(tm_state, tm_x, cm_x); returns
    (x, the new state dict)."""
    tm_state = state["tm_state"] if state else None
    tm_x = state["tm_x"] if state else None
    cm_x = state["cm_x"] if state else None
    h, (tm_state, tm_x) = timemix_apply(p["time_mix"], rmsnorm(p["ln1"], x), cfg, tm_state,
                                        tm_x)
    x = x + h
    h, cm_x = channelmix_apply(p["channel_mix"], rmsnorm(p["ln2"], x), cm_x)
    x = x + h
    return x, {"tm_state": tm_state, "tm_x": tm_x, "cm_x": cm_x}


def rwkv_init_state(cfg, B, dtype, device):
    D = cfg.d_model
    N = cfg.rwkv.head_dim
    H = D // N
    return {
        "tm_state": torch.zeros((B, H, N, N), dtype=torch.float32, device=device),
        "tm_x": torch.zeros((B, D), dtype=dtype, device=device),
        "cm_x": torch.zeros((B, D), dtype=dtype, device=device),
    }
