"""LM entry points: loss, init, prefill, decode -- family-dispatched.

A transcription of ``repro/models/lm.py`` for the decoder families: the
dense and ssm families run, the others (and the audio family, whisper)
raise ``NotImplementedError`` in ``models/transformer.py`` (ROADMAP A6).  The
loss is taken in sequence chunks so the (B, S, V) logits are never held at
once, in plain torch as the JAX package's ``lax.scan`` over chunks (no
kernel there either).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer
from repro_torch.models.modules import count_params, pick_chunk


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
        logits = (xc @ w_head).float()  # (B, chunk, V)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lc[..., None])[..., 0]
        mc = (torch.ones((B, chunk), dtype=torch.float32, device=x.device)
              if mask is None else mask[:, c0:c0 + chunk].float())
        tot = tot + ((logz - gold) * mc).sum()
        cnt = cnt + mc.sum()
    return tot / torch.clamp(cnt, min=1.0)


def loss_fn(params, batch, cfg: ArchConfig, aux_weight: float = 0.01):
    """batch: {'tokens': (B,S), 'labels': (B,S)} -> the scalar training loss
    (``chunked_ce_loss`` of the final hidden states, plus ``aux_weight``
    times the blocks' aux loss, 0 for the dense and ssm families)."""
    x, aux = transformer.forward(params, batch["tokens"], cfg,
                                 vis_embeds=batch.get("vis_embeds"))
    w = params["embed"]["table"].T if cfg.tie_embeddings else params["lm_head"]["w"]
    return chunked_ce_loss(x, w, batch["labels"]) + aux_weight * aux


def init_params(cfg: ArchConfig, generator=None, device=None):
    """Random parameters drawn from the ``torch.Generator`` on its device."""
    return transformer.init_params(cfg, generator, device=device)


def init_cache(cfg: ArchConfig, B: int, S: int, device=None):
    return transformer.init_cache(cfg, B, S, device=device)


def decode_step(params, cache, token, pos, cfg: ArchConfig):
    return transformer.decode_step(params, cache, token, pos, cfg)


def prefill_logits(params, batch, cfg: ArchConfig):
    """batch: {'tokens': (B, S)} -> last-position logits (B, V) f32."""
    return transformer.prefill(
        params, batch["tokens"], cfg, vis_embeds=batch.get("vis_embeds")
    )[:, 0, :]


def param_count(cfg: ArchConfig) -> int:
    """Parameters of the model, counted on the meta device (nothing is
    allocated)."""
    return count_params(transformer.init_params(cfg, device="meta"))
