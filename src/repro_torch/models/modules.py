"""Primitive NN modules as (init, apply) function pairs over dict trees.

A transcription of ``repro/models/modules.py``.  Initialisers draw from an
explicit ``torch.Generator`` (on the device the parameters are made on); on
the ``meta`` device they allocate nothing, which ``lm.param_count`` uses.
Two details follow the reference on purpose: RoPE rotates split halves,
not interleaved pairs, and the gelu MLP uses the tanh approximation
(``jax.nn.gelu``'s default).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


# -- initializers -----------------------------------------------------------


def _normal(gen, shape, std, dtype, device):
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    # In place: a full-width expert tensor (llama4's 128 x 5120 x 8192) is a
    # 21.5 GB f32 draw, and ``x * std`` would hold a second one.
    return x.mul_(std).to(dtype)


def lecun_normal(gen, shape, dtype, fan_in=None, device=None):
    fan_in = fan_in if fan_in is not None else shape[-2] if len(shape) >= 2 else shape[-1]
    std = 1.0 / np.sqrt(fan_in)
    return _normal(gen, shape, std, dtype, _device(gen, device))


def embed_init(gen, shape, dtype, device=None):
    return _normal(gen, shape, 0.02, dtype, _device(gen, device))


def _device(gen, device):
    if device is not None:
        return torch.device(device)
    return gen.device


# -- norms --------------------------------------------------------------------


def rmsnorm_init(d, dtype, device):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p, x, eps=1e-6):
    xf = x.float()
    var = row_stat((xf * xf).mean(dim=-1, keepdim=True))
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


def layernorm_init(d, dtype, device):
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(p, x, eps=1e-5):
    xf = x.float()
    mu = row_stat(xf.mean(dim=-1, keepdim=True))
    var = row_stat(((xf - mu) ** 2).mean(dim=-1, keepdim=True))
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


def row_stat(v):
    """A norm's ``[.., 1]`` statistic, taken over a dim that a DTensor may
    split: summed over the ranks now (one all-reduce of ``[.., 1]``), and
    its gradient likewise before it spreads back over that dim.  DTensor
    alone would carry the gradient's pending sum into the ``[.., D]``
    expansion and reduce-scatter that, in f32.  A plain tensor is returned
    as it is."""
    if not hasattr(v, "placements"):
        return v
    from torch.distributed.tensor import DTensor, Replicate

    v = v.redistribute(v.device_mesh, [Replicate() if p.is_partial() else p
                                       for p in v.placements])
    # from_local's backward brings the incoming gradient to these placements.
    return DTensor.from_local(v.to_local(), v.device_mesh, v.placements, run_check=False,
                              shape=v.shape, stride=v.stride())


def make_norm(kind: str):
    if kind == "rmsnorm":
        return rmsnorm_init, rmsnorm
    if kind == "layernorm":
        return layernorm_init, layernorm
    raise ValueError(kind)


# -- rotary position embeddings ----------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)  # (hd/2,)
    ang = positions[..., :, None, None].float() * freqs  # (..., S, 1, hd/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -- mixed dtypes ----------------------------------------------------------------


def promote(*xs):
    """JAX's rule for operands of mixed floating dtypes: all go to the widest
    (f32 frames or vision tokens against bf16 weights give an f32 product),
    where torch's matmul would raise.  Same-dtype operands pass through."""
    dt = xs[0].dtype
    for x in xs[1:]:
        dt = torch.promote_types(dt, x.dtype)
    return tuple(x.to(dt) for x in xs)


def matmul(a, b):
    """``a @ b`` with ``promote``'s rule, as ``jnp`` computes it."""
    a, b = promote(a, b)
    return a @ b


# -- activations ---------------------------------------------------------------


def swiglu(gate, up):
    return F.silu(gate.float()).to(gate.dtype) * up


def mlp_init(gen, d_model, d_ff, dtype, activation="swiglu", device=None):
    device = _device(gen, device)
    if activation == "swiglu":
        return {
            "w_gate": lecun_normal(gen, (d_model, d_ff), dtype, device=device),
            "w_up": lecun_normal(gen, (d_model, d_ff), dtype, device=device),
            "w_down": lecun_normal(gen, (d_ff, d_model), dtype, fan_in=d_ff, device=device),
        }
    return {
        "w_up": lecun_normal(gen, (d_model, d_ff), dtype, device=device),
        "b_up": torch.zeros((d_ff,), dtype=dtype, device=device),
        "w_down": lecun_normal(gen, (d_ff, d_model), dtype, fan_in=d_ff, device=device),
        "b_down": torch.zeros((d_model,), dtype=dtype, device=device),
    }


def mlp(p, x, activation="swiglu"):
    """Megatron's layout on DTensors: the input gathered once
    (``gather_input``), the in-projections split on F, the activation on
    the split hidden, the down product reduce-scattered (``row_project``)."""
    x = gather_input(x, p["w_up"])
    if activation == "swiglu":
        h = swiglu(matmul(x, p["w_gate"]), matmul(x, p["w_up"]))
        return row_project(h, p["w_down"])
    h = F.gelu((matmul(x, p["w_up"]) + p["b_up"]).float(), approximate="tanh").to(x.dtype)
    return row_project(h, p["w_down"]) + p["b_down"]


# -- reshapes of DTensors -----------------------------------------------------------


def split_dim(x, dim: int, sizes: tuple):
    """``x`` with dim ``dim`` split into ``sizes`` (a reshape).  A DTensor
    split over that dim is first gathered on each mesh dim whose size does
    not divide ``sizes[0]`` (DTensor cannot unflatten an uneven split, e.g.
    12 heads over 16 ranks); a plain tensor is only reshaped."""
    dim = dim % x.ndim
    shape = tuple(x.shape[:dim]) + tuple(sizes) + tuple(x.shape[dim + 1:])
    if hasattr(x, "placements"):
        from torch.distributed.tensor import Replicate, Shard

        fixed = [Replicate() if p == Shard(dim) and sizes[0] % n else p
                 for p, n in zip(x.placements, x.device_mesh.shape)]
        if fixed != list(x.placements):
            x = x.redistribute(x.device_mesh, fixed)
    return x.reshape(shape)


def settle_partial(x):
    """A DTensor with pending sums (``Partial``, from a product whose
    contracted dim is split) summed now: scattered over its last dim where
    that dim divides the mesh dim, else replicated.  Some torch releases
    cannot add such a tensor to a split one (they would have to turn the
    split operand into a partial).  A plain tensor is returned as it is."""
    if not hasattr(x, "placements"):
        return x
    from torch.distributed.tensor import Partial, Replicate, Shard

    last = x.ndim - 1
    fixed = [(Shard(last) if x.shape[last] % n == 0 else Replicate())
             if isinstance(p, Partial) else p
             for p, n in zip(x.placements, x.device_mesh.shape)]
    if fixed == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, fixed)


def gather_input(x, w):
    """The input of an in-projection ``x @ w`` in Megatron's layout: a
    DTensor split over its last dim, or holding pending sums, is replicated
    on those mesh dims (one all-gather of ``[.., D]``), so that the product
    is split as ``w``'s last dim is and its hidden never moves.  On a mesh
    dim where ``w`` splits its first (contracted) dim, as a tied head's
    ``table.T`` does, ``x`` stays as it is.  Gathered once, it feeds every
    in-projection of a sub-layer.  A plain tensor is returned as it is."""
    if not hasattr(x, "placements"):
        return x
    from torch.distributed.tensor import Partial, Replicate, Shard

    last = x.ndim - 1
    wp = getattr(w, "placements", (None,) * len(x.placements))  # a plain w splits nothing
    fixed = [Replicate() if (p == Shard(last) or isinstance(p, Partial)) and q != Shard(0)
             else p for p, q in zip(x.placements, wp)]
    if fixed == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, fixed)


def row_project(h, w):
    """``h @ w`` for an out-projection, on each mesh dim where the DTensor
    ``h`` is split over its last dim.  Megatron's layout: ``w`` is
    redistributed to split its first dim alike (its stored split stays on
    the last dim; the gradient goes back through the redistribution), so
    the product is a partial sum, reduce-scattered over its last dim by
    ``settle_partial``.  Where gathering ``h`` moves no more than a rank's
    shard of ``w`` (a decode step's few rows), ``h`` is gathered instead and
    ``w`` stays as stored: the product is split as ``w`` is, with no sum.
    Plain tensors: ``matmul(h, w)``."""
    if hasattr(h, "placements") and hasattr(w, "placements"):
        from torch.distributed.tensor import Replicate, Shard

        split = [p == Shard(h.ndim - 1) for p in h.placements]
        local = h.to_local()
        if any(split) and local.numel() // local.shape[-1] * h.shape[-1] <= w.to_local().numel():
            h = h.redistribute(h.device_mesh, [Replicate() if s else p
                                               for s, p in zip(split, h.placements)])
        else:
            fixed = [Shard(0) if s else q for s, q in zip(split, w.placements)]
            if fixed != list(w.placements):
                w = w.redistribute(w.device_mesh, fixed)
    return settle_partial(matmul(h, w))


def split_heads(x, heads: int, hd: int):
    """(..., heads * hd) -> (..., heads, hd), through ``split_dim``."""
    return split_dim(x, -1, (heads, hd))


# -- embeddings -----------------------------------------------------------------


def embedding_init(gen, vocab, d_model, dtype, device=None):
    return {"table": embed_init(gen, (vocab, d_model), dtype, device=device)}


def embedding_lookup(p, ids):
    table = p["table"]
    local = _embedding_lookup_local(table, ids)
    if local is not None:
        return local
    return table.index_select(0, ids.reshape(-1)).reshape(*ids.shape, table.shape[-1])


def _embedding_lookup_local(table, ids):
    """``embedding_lookup`` of DTensors on the local shards: each rank looks
    up its own ids in its own columns of the table, so the output is split
    as the ids are on their mesh dims and on D where the table's D is.
    DTensor's own rule for ``index_select`` gathers the whole batch's rows
    on every rank under some torch versions (2.11: 4.3 GB a rank for a
    32k-token prefill of tinyllama-1.1b on a 16x16 mesh).  The gradient
    of a table that a mesh dim replicates while it splits the ids is a
    partial sum over that dim.  None where the local lookup does not cover
    the placements: either operand not a DTensor, the table split on its
    vocab, a mesh dim that splits both, or a partial operand."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    if not (isinstance(table, DTensor) and isinstance(ids, DTensor)):
        return None
    if table.device_mesh != ids.device_mesh or table.ndim != 2:
        return None
    out, grad = [], []
    for pt, pi in zip(table.placements, ids.placements):
        if pt == Replicate() and pi == Replicate():
            out.append(Replicate())
            grad.append(Replicate())
        elif pt == Replicate() and isinstance(pi, Shard):
            out.append(Shard(pi.dim))
            grad.append(Partial())
        elif pt == Shard(1) and pi == Replicate():
            out.append(Shard(ids.ndim))
            grad.append(Shard(1))
        else:
            return None
    rows = table.to_local(grad_placements=grad)
    ids_local = ids.to_local()
    y = rows.index_select(0, ids_local.reshape(-1)).reshape(*ids_local.shape, rows.shape[-1])
    shape = (*ids.shape, table.shape[-1])
    stride = tuple(int(np.prod(shape[i + 1:])) for i in range(len(shape)))
    return DTensor.from_local(y, table.device_mesh, out, run_check=False, shape=shape,
                              stride=stride)


def sinusoidal_positions(S: int, d: int, device=None) -> torch.Tensor:
    """(S, d) f32: sin at even columns, cos at odd, of pos / 10000^(2i/d)
    (computed in numpy float64 and rounded once, as the JAX package does)."""
    pos = np.arange(S)[:, None]
    dim = np.arange(0, d, 2)[None, :]
    ang = pos / np.power(10000.0, dim / d)
    out = np.zeros((S, d), np.float32)
    out[:, 0::2] = np.sin(ang)
    out[:, 1::2] = np.cos(ang)
    return torch.from_numpy(out).to(device)


def pick_chunk(S: int, target: int) -> int:
    """Largest divisor of S that is <= target (chunked scans need S % c == 0)."""
    c = min(target, S)
    while S % c:
        c -= 1
    return c


def count_params(tree) -> int:
    if isinstance(tree, dict):
        return sum(count_params(v) for v in tree.values())
    return int(tree.numel())
