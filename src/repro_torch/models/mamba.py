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

On DTensors (a multi-rank plan) the layer takes Megatron-LM's
``MambaMixer`` layout, split on the inner width Di: the input rows gathered
once, x and z split over Di (``_in_project``), the depthwise conv, the dt
projection and the scan on each rank's channels with no collective, the
x-projection row-parallel with its narrow (B, S, R+2N) sum settled once,
and the out-projection through ``row_project``.  A decode step runs on its
state's placements (whole on 'model': the cache splits only the batch), its
operands made whole there.  Plain tensors take the same ops as the JAX
model's.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.modules import (_device, gather_input, lecun_normal, row_project,
                                       settle_whole, whole_as)
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
        conv_state = _zeros_as(x, (B, K - 1, Di), x.dtype, {0: 0, 2: 2})
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

    x, z = _in_project(gather_input(u, p["w_in"]), p["w_in"])  # (B,S,Di)
    if state:
        x, z = (whole_as(t, state["ssm"]) for t in (x, z))
    q = _placed(p, x)
    conv_state = state["conv"] if state else None
    x, conv_state = _causal_conv(x, q["conv_w"], q["conv_b"], conv_state)
    x = F.silu(x.float()).to(u.dtype)

    proj = settle_whole(x @ q["w_x"])  # (B,S,R+2N)
    dt_r, B_, C = torch.split(proj, [R, N, N], dim=-1)
    dt = whole_as(F.softplus((dt_r @ q["w_dt"]).float() + q["b_dt"]), x)  # (B,S,Di)
    A = -torch.exp(q["A_log"])  # (Di,N)

    xf = x.float()
    h0 = state["ssm"] if state else _zeros_as(x, (B, Di, N), torch.float32, {0: 0, 2: 1})
    xs = (_time_major(xf), _time_major(dt), B_.float().movedim(1, 0), C.float().movedim(1, 0))
    h, ys = chunked_scan(_ssm_step(A), h0, xs, chunk=CHUNK)
    y = ys.movedim(0, 1) + xf * q["D_skip"]  # (B,S,Di)
    y = y.to(u.dtype) * F.silu(z.float()).to(u.dtype)
    return row_project(y, p["w_out"]), {"ssm": h, "conv": conv_state}


def _time_major(t):
    """(B,S,Di) -> (S,B,Di), a scan input split as x is.  On DTensors its
    gradient, which comes back permuted, is made contiguous first: DTensor's
    reshape of a product's gradient (``dt_r @ w_dt``'s, ``u @ w_in``'s)
    views the local tensor, which a permuted one refuses.  (B_ and C, whole
    on 'model', come back as pending sums, which that copy would scatter.)"""
    if hasattr(t, "placements"):
        t = _ContiguousGrad.apply(t)
    return t.movedim(1, 0)


class _ContiguousGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _in_project(u, w_in):
    """x and z (B,S,Di), the halves of ``u @ w_in``.  On DTensors, where
    ``w_in`` is split over its 2Di columns on one mesh dim (x's columns on
    its first half of ranks, z's on the other), x and z come out split
    over Di alike: ``_Regroup`` hands each rank its Di/n columns of both
    (an all-to-all of each rank's shard of ``w_in``), or, where that moves
    more bytes than gathering the product (a decode step's few rows), the
    product is gathered whole and halved."""
    if hasattr(u, "placements") and hasattr(w_in, "placements"):
        from torch.distributed.tensor import Shard

        dims = [i for i, p in enumerate(w_in.placements) if p == Shard(1)]
        if dims:
            n = w_in.device_mesh.size(dims[0])
            local = u.to_local()
            rows = local.numel() // local.shape[-1]
            if (len(dims) == 1 and n % 2 == 0 and w_in.shape[1] % (2 * n) == 0
                    and rows * w_in.shape[1] > w_in.to_local().numel()):
                w_x, w_z = _Regroup.apply(w_in, dims[0])
                return u @ w_x, u @ w_z
            return torch.chunk(settle_whole(u @ w_in), 2, dim=-1)
    xz = u @ w_in
    return torch.chunk(xz, 2, dim=-1)


class _Regroup(torch.autograd.Function):
    """``w_in`` (D, 2Di), split over its columns on mesh dim ``dim`` of n
    ranks (rank r holds the blocks 2r and 2r+1 of 2n blocks of Di/n
    columns: x's are the first n, z's the last n), as (x's (D, Di), z's
    (D, Di)), each split over Di on that dim: rank r ends with blocks r and
    n+r, from ranks r//2 and (n+r)//2, by one all-to-all of each rank's
    shard.  The backward brings each gradient to ``w_in``'s placements and
    sends it back the same way."""

    @staticmethod
    def forward(ctx, w, dim):
        mesh = w.device_mesh
        n, r = mesh.size(dim), mesh.get_local_rank(dim)
        d = w.shape[1] // (2 * n)
        send = [d if s in (2 * r % n, (2 * r + 1) % n) else 0 for s in range(n)]
        recv = [d if s in (r // 2, (n + r) // 2) else 0 for s in range(n)]
        local = w.to_local()
        ctx.meta = (mesh, dim, w.placements, w.shape, w.stride(), send, recv, local)
        halves = _all_to_all_cols(local, recv, send, (mesh, dim)).split(d, dim=1)
        shape = (w.shape[0], w.shape[1] // 2)
        return tuple(_dtensor(t.contiguous(), mesh, w.placements, shape,
                              (shape[1], 1)) for t in halves)

    @staticmethod
    def backward(ctx, gx, gz):
        mesh, dim, placements, shape, stride, send, recv, local = ctx.meta
        d = local.shape[1] // 2
        parts = [local.new_zeros((local.shape[0], d)) if g is None
                 else g.redistribute(mesh, placements).to_local() for g in (gx, gz)]
        back = _all_to_all_cols(torch.cat(parts, dim=1), send, recv, (mesh, dim))
        return _dtensor(back, mesh, placements, shape, stride), None


def _all_to_all_cols(t, out_splits, in_splits, group):
    """An all-to-all over ``t``'s columns (dim 1): ``in_splits[s]`` columns
    in turn to rank s, ``out_splits[s]`` from rank s, in rank order."""
    import torch.distributed._functional_collectives as funcol

    out = funcol.all_to_all_single(t.t().contiguous(), out_splits, in_splits, group)
    return funcol.wait_tensor(out).t().contiguous()


def _dtensor(local, mesh, placements, shape, stride):
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local, mesh, placements, run_check=False, shape=torch.Size(shape),
                              stride=tuple(stride))


def _placed(p, x):
    """The layer's leaves laid out for x (B,S,Di).  On DTensors: where x is
    split over Di, ``w_x`` and ``A_log`` re-laid to split their Di rows
    alike (the x-projection row-parallel, the scan on each rank's
    channels); where x is whole (a decode step), the leaves split over Di
    gathered, but ``w_x``, whose narrow product is gathered instead.
    ``w_dt`` stays as stored: dt comes out split as x is, or is made whole
    after.  Plain tensors: ``p``."""
    if not hasattr(x, "placements"):
        return p
    from torch.distributed.tensor import Shard

    split = [pl == Shard(2) for pl in x.placements]

    def rows(w):
        fixed = [Shard(0) if s else pl for s, pl in zip(split, w.placements)]
        return w if fixed == list(w.placements) else w.redistribute(w.device_mesh, fixed)

    q = {k: whole_as(p[k], x) for k in ("conv_w", "conv_b", "b_dt", "D_skip")}
    return {**p, **q, "w_x": rows(p["w_x"]), "A_log": whole_as(rows(p["A_log"]), x)}


def _zeros_as(x, shape, dtype, dims):
    """Zeros of ``shape`` on x's device; on DTensors split as x is on the
    dims that ``dims`` maps (x's dim -> this one's), whole elsewhere."""
    if not hasattr(x, "placements"):
        return torch.zeros(shape, dtype=dtype, device=x.device)
    from torch.distributed.tensor import Replicate, Shard

    placements = [Shard(dims[pl.dim]) if isinstance(pl, Shard) and pl.dim in dims
                  else Replicate() for pl in x.placements]
    local = list(shape)
    for xd, d in dims.items():
        local[d] = x.to_local().shape[xd]
    stride = [math.prod(shape[i + 1:]) for i in range(len(shape))]
    return _dtensor(torch.zeros(local, dtype=dtype, device=x.device), x.device_mesh,
                    placements, shape, stride)


def mamba_init_state(cfg, B, dtype, device):
    Di, N, _ = _dims(cfg)
    return {
        "ssm": torch.zeros((B, Di, N), dtype=torch.float32, device=device),
        "conv": torch.zeros((B, cfg.mamba.d_conv - 1, Di), dtype=dtype, device=device),
    }
