"""Mixture-of-Experts MLP with top-k routing and capacity-based dispatch.

A transcription of ``repro/models/moe.py``.  Tokens route per group (one
sequence): the router runs in f32, softmax then top-k, the gates
renormalised over the k picks.  Each (token, pick) slot takes its place in
its expert's buffer in token-major order (an exclusive cumsum over the
flattened S*K axis); a slot at or past the capacity C goes to the overflow
slot C, which is dropped, and its gate is zeroed.  Dispatch is a scatter into
(B, E, C+1, D) and the combine a gather back through a zero pad, so the
buffers stay O(E*C*D).  The expert products are plain einsums, as in the JAX
package (no Pallas kernel there either).  The aux loss is Switch's load
balance, E * sum_e f_e * P_e.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.modules import _device, lecun_normal


def moe_init(gen, cfg, dtype, device=None):
    device = _device(gen, device)
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.moe.n_experts
    return {
        "w_router": lecun_normal(gen, (D, E), torch.float32, device=device),
        "w_gate": lecun_normal(gen, (E, D, Fd), dtype, device=device),
        "w_up": lecun_normal(gen, (E, D, Fd), dtype, device=device),
        "w_down": lecun_normal(gen, (E, Fd, D), dtype, fan_in=Fd, device=device),
    }


def _capacity(tokens_per_group: int, n_experts: int, top_k: int, factor: float) -> int:
    c = int(tokens_per_group * top_k * factor / n_experts)
    return max(c, top_k)


def route(p, x, cfg):
    """The router's decisions for x (B, S, D): (probs (B,S,E) f32, experts
    (B,S,K), then ``place``'s gates, slot positions and C)."""
    probs = torch.softmax(x.float() @ p["w_router"].float(), dim=-1)  # (B,S,E)
    gate_vals, expert_idx = torch.topk(probs, cfg.moe.top_k, dim=-1)  # descending
    return (probs, expert_idx) + place(gate_vals, expert_idx, cfg)


def place(gate_vals, expert_idx, cfg):
    """Gates and buffer slots of the chosen experts (B,S,K): (gates f32
    renormalised over the k picks, zero where dropped; positions, the
    overflow slot C where dropped; C)."""
    B, S, K = expert_idx.shape
    E = cfg.moe.n_experts
    C = _capacity(S, E, K, cfg.moe.capacity_factor)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    flat = F.one_hot(expert_idx, E).reshape(B, S * K, E)  # token-major (s, k)
    pos_in_expert = torch.cumsum(flat, dim=1) - flat  # exclusive
    pos = (pos_in_expert * flat).sum(-1).reshape(B, S, K)
    keep = pos < C
    return gate_vals * keep, torch.where(keep, pos, C), C


def moe_apply(p, x, cfg):
    """x: (B, S, D) -> (y (B,S,D) in x's dtype, aux loss () f32)."""
    B, S, D = x.shape
    E, K = cfg.moe.n_experts, cfg.moe.top_k
    probs, expert_idx, gate_vals, pos, C = route(p, x, cfg)

    if hasattr(x, "placements"):  # DTensors: dispatch and combine per batch shard
        local, wrap = _batch_local(x)
        x, expert_idx, gate_vals, pos = (local(t) for t in (x, expert_idx, gate_vals, pos))
        B = x.shape[0]
    else:
        wrap = None
    # Scatter tokens into (B, E, C+1, D); slot C collects the drops.
    e_flat = expert_idx.reshape(B, S * K)
    pos_flat = pos.reshape(B, S * K)
    b_idx = torch.arange(B, device=x.device)[:, None].expand(B, S * K)
    xk = x[:, :, None, :].expand(B, S, K, D).reshape(B, S * K, D)
    # Every kept slot (b, e, pos < C) is written by one (token, pick) only,
    # so its sum has one term; only the overflow slot C collects several, in
    # an order the device may choose, and it is cut off here. The gather
    # below and its backward (a scatter into out_pad) meet likewise only at
    # slot C, whose gradient the cut discards: equal calls give equal
    # outputs and gradients.
    buf = torch.zeros((B, E, C + 1, D), dtype=x.dtype, device=x.device)
    buf.index_put_((b_idx, e_flat, pos_flat), xk, accumulate=True)
    buf = buf[:, :, :C]

    # Expert FFN: (B,E,C,D) x (E,D,F).
    if wrap is None:
        h = torch.einsum("becd,edf->becf", buf, p["w_gate"])
        u = torch.einsum("becd,edf->becf", buf, p["w_up"])
        h = F.silu(h.float()).to(x.dtype) * u
        out = torch.einsum("becf,efd->becd", h, p["w_down"])  # (B,E,C,D)
    else:
        out = local(_experts_bmm(p, wrap(buf), x.dtype))

    # Gather back and combine with the gates in f32.
    out_pad = torch.cat([out, torch.zeros((B, E, 1, D), dtype=out.dtype,
                                          device=out.device)], dim=2)
    picked = out_pad[b_idx, e_flat, pos_flat].reshape(B, S, K, D)
    y = (picked.float() * gate_vals[..., None]).sum(dim=2).to(x.dtype)
    if wrap is not None:
        y = wrap(y)

    # Switch-style load-balance loss: E * sum_e f_e * P_e.  On DTensors the
    # picks are this rank's batch shard: their counts become a DTensor again,
    # so that the mean spans the whole batch.
    me = probs.mean(dim=(0, 1))
    counts = F.one_hot(expert_idx, E).sum(2).float()
    if wrap is not None:
        counts = wrap(counts)
    ce = counts.mean(dim=(0, 1)) / K
    aux = E * torch.sum(me * ce)
    return y, aux


def _experts_bmm(p, buf, dtype):
    """The expert FFN of DTensors as batched products over contiguous
    (E, B*C, .) operands: DTensor's einsum decomposition views a permuted
    local gradient in its backward, which torch refuses."""
    B, E, C, D = buf.shape
    be = buf.permute(1, 0, 2, 3).contiguous().reshape(E, B * C, D)
    h = torch.bmm(be, p["w_gate"])
    u = torch.bmm(be, p["w_up"])
    h = F.silu(h.float()).to(dtype) * u
    out = torch.bmm(h, p["w_down"])  # (E, B*C, D)
    return out.reshape(E, B, C, D).permute(1, 0, 2, 3)


def _batch_local(x):
    """(local, wrap) for a DTensor x (B, S, D): ``local(t)`` is this rank's
    batch shard of t, whole on every other dim (t gathered where it is
    split past the batch); ``wrap`` makes a batch shard a DTensor again.
    The scatter and gather of the dispatch (``index_put_``, advanced
    indexing) have no DTensor rule; per batch shard they are the plain ops."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = x.device_mesh
    batch = [Shard(0) if p == Shard(0) else Replicate() for p in x.placements]

    def local(t):
        return t.redistribute(mesh, batch).to_local()

    def wrap(t):
        return DTensor.from_local(t, mesh, batch, run_check=False)

    return local, wrap


def moe_param_count(cfg) -> tuple[int, int]:
    """(total expert params, active expert params) per layer."""
    D, Fd, E, K = cfg.d_model, cfg.d_ff, cfg.moe.n_experts, cfg.moe.top_k
    per_expert = 3 * D * Fd
    return E * per_expert + D * E, K * per_expert + D * E
