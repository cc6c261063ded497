"""LM entry points: loss, init, prefill, decode -- family-dispatched.

A transcription of ``repro/models/lm.py``: the audio family (whisper) goes
to ``models/whisper.py``, every other family to ``models/transformer.py``.
The loss is taken in sequence chunks so the (B, S, V) logits are never held
at once, in plain torch as the JAX package's ``lax.scan`` over chunks (no
kernel there either); the VLM's loss covers its text positions only, and
MoE models add ``aux_weight`` times the router's load-balance loss.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer, whisper
from repro_torch.models.modules import count_params, gather_input, pick_chunk

_EXPERT_LEAVES = ("w_gate", "w_up", "w_down")


def chunked_ce_loss(x, w_head, labels, mask=None, chunk: int = 512):
    """Mean cross-entropy over the vocab without the full logits.

    x: (B,S,D); w_head: (D,V); labels: (B,S) int; mask: (B,S) or None.  Per
    chunk of ``pick_chunk(S, chunk)`` positions: logits ``x @ w_head`` in
    the params' dtype, then f32; logsumexp minus the gold logit, times the
    mask; the sums over chunks divided by max(mask sum, 1)."""
    B, S, _ = x.shape
    chunk = pick_chunk(S, chunk)
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, S, chunk):
        xc = x[:, c0:c0 + chunk]
        lc = labels[:, c0:c0 + chunk].long()
        logits = (gather_input(xc, w_head) @ w_head).float()  # (B, chunk, V)
        # (B, chunk, 1) until the difference: a gather from a DTensor split
        # over the vocab is a masked partial that reduces at that shape.
        logz = torch.logsumexp(logits, dim=-1, keepdim=True)
        gold = torch.gather(logits, -1, lc[..., None])
        mc = (torch.ones((B, chunk), dtype=torch.float32, device=x.device)
              if mask is None else mask[:, c0:c0 + chunk].float())
        tot = tot + ((logz - gold)[..., 0] * mc).sum()
        cnt = cnt + mc.sum()
    return tot / torch.clamp(cnt, min=1.0)


def loss_fn(params, batch, cfg: ArchConfig, aux_weight: float = 0.01):
    """batch: {'tokens': (B,S), 'labels': (B,S), ['vis_embeds'|'frames']}
    -> the scalar training loss (``chunked_ce_loss`` of the final hidden
    states, plus ``aux_weight`` times the blocks' aux loss, 0 without MoE;
    whisper takes no aux term)."""
    if cfg.family == "audio":
        enc_out = whisper.encode(params, batch["frames"], cfg)
        x = whisper.decode_train(params, batch["tokens"], enc_out, cfg)
        return chunked_ce_loss(x, params["lm_head"]["w"], batch["labels"])
    x, aux = transformer.forward(params, batch["tokens"], cfg,
                                 vis_embeds=batch.get("vis_embeds"))
    if cfg.n_vis_tokens:
        x = x[:, cfg.n_vis_tokens:, :]  # loss over text positions only
    w = params["embed"]["table"].T if cfg.tie_embeddings else params["lm_head"]["w"]
    return chunked_ce_loss(x, w, batch["labels"]) + aux_weight * aux


def init_params(cfg: ArchConfig, generator=None, device=None):
    """Random parameters drawn from the ``torch.Generator`` on its device."""
    if cfg.family == "audio":
        return whisper.init_params(cfg, generator, device=device)
    return transformer.init_params(cfg, generator, device=device)


def init_cache(cfg: ArchConfig, B: int, S: int, device=None):
    if cfg.family == "audio":
        return whisper.init_cache(cfg, B, S, device=device)
    return transformer.init_cache(cfg, B, S, device=device)


def decode_step(params, cache, token, pos, cfg: ArchConfig):
    if cfg.family == "audio":
        return whisper.decode_step(params, cache, token, pos, cfg)
    return transformer.decode_step(params, cache, token, pos, cfg)


def prefill_logits(params, batch, cfg: ArchConfig):
    """batch: {'tokens': (B, S), ['vis_embeds'|'frames']} -> last-position
    logits (B, V) f32."""
    if cfg.family == "audio":
        enc_out = whisper.encode(params, batch["frames"], cfg)
        x = whisper.decode_train(params, batch["tokens"], enc_out, cfg)
        return (x[:, -1, :] @ params["lm_head"]["w"]).float()
    return transformer.prefill(
        params, batch["tokens"], cfg, vis_embeds=batch.get("vis_embeds")
    )[:, 0, :]


def param_count(cfg: ArchConfig) -> int:
    """Parameters of the model, counted on the meta device (nothing is
    allocated)."""
    return count_params(init_params(cfg, device="meta"))


def active_param_count(cfg: ArchConfig) -> int:
    """Parameters active per token: an MoE layer's expert tensors count
    top_k / n_experts of their size (integer division, as the JAX package's
    count over its tree paths)."""
    def walk(tree, path):
        if isinstance(tree, dict):
            return sum(walk(v, path + (k,)) for k, v in tree.items())
        n = int(tree.numel())
        if cfg.moe is not None and "moe" in path and path[-1] in _EXPERT_LEAVES:
            n = n * cfg.moe.top_k // cfg.moe.n_experts
        return n

    return walk(init_params(cfg, device="meta"), ())
