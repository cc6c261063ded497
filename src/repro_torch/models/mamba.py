"""Mamba (selective SSM) block: the SSM component of Jamba (arXiv:2403.19887).

A transcription of ``repro/models/mamba.py``:

    x, z = in_proj(u)                        # (B,S,Di) each, Di = expand*D
    x = silu(causal_depthwise_conv(x))
    dt, B_, C = x_proj(x)                    # dt: (B,S,Di) via dt_rank
    h_t = exp(dt*A) * h_{t-1} + dt*B_ * x_t  # per-channel state (Di, N)
    y = C . h + D_skip*x ;  out = out_proj(y * silu(z))

The selective scan is the JAX package's ``chunked_scan`` over time (a
``lax.scan`` there, no Pallas kernel), here a plain torch loop over time
through ``scan_utils.chunked_scan`` on any device: one step's few
elementwise launches per token.  Decode is one step with the state
(ssm (B,Di,N) f32, conv (B,K-1,Di)): O(1) per token.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.modules import _device, lecun_normal
from repro_torch.models.scan_utils import chunked_scan

#: Time chunk of the scan (``repro/models/mamba.py``'s ``chunk=64``).
CHUNK = 64


def _dims(cfg):
    mc = cfg.mamba
    return mc.expand * cfg.d_model, mc.d_state, mc.dt_rank or max(1, cfg.d_model // 16)


def mamba_init(gen, cfg, dtype, device=None):
    device = _device(gen, device)
    D = cfg.d_model
    Di, N, R = _dims(cfg)
    K = cfg.mamba.d_conv
    A = torch.arange(1, N + 1, dtype=torch.float32, device=device)[None, :].repeat(Di, 1)
    return {
        "w_in": lecun_normal(gen, (D, 2 * Di), dtype, device=device),
        "conv_w": lecun_normal(gen, (K, Di), dtype, fan_in=K, device=device),
        "conv_b": torch.zeros((Di,), dtype=dtype, device=device),
        "w_x": lecun_normal(gen, (Di, R + 2 * N), dtype, device=device),
        "w_dt": lecun_normal(gen, (R, Di), dtype, fan_in=R, device=device),
        # softplus^-1(0.01), in f32 as the reference computes it
        "b_dt": torch.log(torch.expm1(torch.full((Di,), 0.01, dtype=torch.float32,
                                                 device=device))),
        "A_log": torch.log(A),
        "D_skip": torch.ones((Di,), dtype=torch.float32, device=device),
        "w_out": lecun_normal(gen, (Di, D), dtype, fan_in=Di, device=device),
    }


def _causal_conv(x, w, b, conv_state=None):
    """Depthwise causal conv along S. x: (B,S,Di); w: (K,Di).

    Returns (y, new conv_state): the state holds the last K-1 inputs for
    decode (zeros before the first)."""
    B, S, Di = x.shape
    K = w.shape[0]
    if conv_state is None:
        conv_state = torch.zeros((B, K - 1, Di), dtype=x.dtype, device=x.device)
    xp = torch.cat([conv_state, x], dim=1)  # (B, S+K-1, Di)
    # sum_k w[k] * x[t-K+1+k], summed from 0 in the reference's order
    y = sum(xp[:, k:k + S, :] * w[k] for k in range(K)) + b
    return y, xp[:, -(K - 1):, :]


def _ssm_step(A):
    def step(h, inp):
        xt, dtt, bt, ct = inp  # (B,Di), (B,Di), (B,N), (B,N)
        dA = torch.exp(dtt[..., None] * A)  # (B,Di,N)
        dBx = (dtt * xt)[..., None] * bt[:, None, :]
        h = dA * h + dBx
        return h, torch.einsum("bdn,bn->bd", h, ct)

    return step


def mamba_apply(p, u, cfg, state=None):
    """u: (B,S,D) -> (y (B,S,D), new state {ssm (B,Di,N) f32, conv})."""
    B, S, D = u.shape
    Di, N, R = _dims(cfg)

    xz = u @ p["w_in"]
    x, z = torch.chunk(xz, 2, dim=-1)  # (B,S,Di)
    conv_state = state["conv"] if state else None
    x, conv_state = _causal_conv(x, p["conv_w"], p["conv_b"], conv_state)
    x = F.silu(x.float()).to(u.dtype)

    proj = x @ p["w_x"]  # (B,S,R+2N)
    dt_r, B_, C = torch.split(proj, [R, N, N], dim=-1)
    dt = F.softplus((dt_r @ p["w_dt"]).float() + p["b_dt"])  # (B,S,Di)
    A = -torch.exp(p["A_log"])  # (Di,N)

    xf = x.float()
    h0 = (state["ssm"] if state else
          torch.zeros((B, Di, N), dtype=torch.float32, device=u.device))
    xs = tuple(t.movedim(1, 0) for t in (xf, dt, B_.float(), C.float()))
    h, ys = chunked_scan(_ssm_step(A), h0, xs, chunk=CHUNK)
    y = ys.movedim(0, 1) + xf * p["D_skip"]  # (B,S,Di)
    y = y.to(u.dtype) * F.silu(z.float()).to(u.dtype)
    return y @ p["w_out"], {"ssm": h, "conv": conv_state}


def mamba_init_state(cfg, B, dtype, device):
    Di, N, _ = _dims(cfg)
    return {
        "ssm": torch.zeros((B, Di, N), dtype=torch.float32, device=device),
        "conv": torch.zeros((B, cfg.mamba.d_conv - 1, Di), dtype=dtype, device=device),
    }
