"""LM entry points: init, prefill, decode -- family-dispatched.

A transcription of ``repro/models/lm.py`` for the decoder families: the
dense and ssm families run, the others (and the audio family, whisper)
raise ``NotImplementedError`` in ``models/transformer.py`` (ROADMAP A8).  The
loss (``chunked_ce_loss``, ``loss_fn``) belongs to the training slice.
"""

from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer
from repro_torch.models.modules import count_params


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
