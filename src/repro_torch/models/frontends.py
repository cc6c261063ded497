"""Modality frontend stubs: the vision and audio families' input embeddings.

A transcription of ``repro/models/frontends.py``.  The ``[vlm]`` and
``[audio]`` configs specify the transformer backbone; a frontend supplies
precomputed patch or frame embeddings.  These stubs draw them from a
``torch.Generator`` on its device with the shapes, dtype (f32, as the JAX
input specs give) and scale a real frontend would produce, so a trained
ViT or conv encoder is a drop-in change.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ArchConfig


def vit_patch_stub(gen: torch.Generator, cfg: ArchConfig, batch: int) -> torch.Tensor:
    """InternViT patch embeddings: (B, n_vis_tokens, d_model) f32, RMS 0.02.

    A real InternViT-300M runs 448x448 crops -> 1024 patches -> pixel
    shuffle to 256 tokens -> MLP projector into the LM width."""
    x = torch.randn((batch, cfg.n_vis_tokens, cfg.d_model), generator=gen,
                    dtype=torch.float32, device=gen.device)
    d = float(cfg.d_model)
    return x / math.sqrt(d) * d ** 0.5 * 0.02


def audio_frame_stub(gen: torch.Generator, cfg: ArchConfig, batch: int) -> torch.Tensor:
    """Whisper frame embeddings: (B, enc_seq_len, d_model) f32, RMS 0.02.

    A real frontend is two strided 1-D convs over an 80-bin log-mel
    spectrogram (3000 frames -> 1500)."""
    x = torch.randn((batch, cfg.enc_seq_len, cfg.d_model), generator=gen,
                    dtype=torch.float32, device=gen.device)
    return x * 0.02


def frontend_for(cfg: ArchConfig):
    """The stub that makes ``cfg``'s extra input, or None for text only."""
    if cfg.family == "vlm":
        return vit_patch_stub
    if cfg.family == "audio":
        return audio_frame_stub
    return None
