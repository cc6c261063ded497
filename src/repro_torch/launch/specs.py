"""input_specs(): shape-and-dtype stand-ins for every program's inputs.

The port of ``repro/launch/specs.py``.  Where the JAX package returns
``jax.ShapeDtypeStruct``s, this returns tensors on the ``meta`` device:
each has the shape and dtype of the input it stands for, and nothing is
allocated.  Token ids are int32 and the frontend stubs' frames and vision
tokens f32, as there.  ``train`` stacks the workers' batches on a leading
M axis, as ``train.trainer.make_train_step`` takes them.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import SHAPES, ArchConfig, ShapeSpec
from repro_torch.models import lm
from repro_torch.train.trainer import abstract_stacked


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _text_len(cfg: ArchConfig, S: int) -> int:
    """Text positions of a sequence of S; the vision tokens take the rest."""
    return S - cfg.n_vis_tokens if cfg.n_vis_tokens else S


def train_batch_specs(cfg: ArchConfig, shape: ShapeSpec, M: int) -> dict:
    """Stacked training batch: leaves (M, B/M, ...)."""
    B = shape.global_batch
    if B % M:
        raise ValueError(f"global_batch {B} not divisible by {M} workers")
    b, s_text = B // M, _text_len(cfg, shape.seq_len)
    out = {"tokens": _meta((M, b, s_text), torch.int32),
           "labels": _meta((M, b, s_text), torch.int32)}
    if cfg.n_vis_tokens:
        out["vis_embeds"] = _meta((M, b, cfg.n_vis_tokens, cfg.d_model), torch.float32)
    if cfg.family == "audio":
        out["frames"] = _meta((M, b, cfg.enc_seq_len, cfg.d_model), torch.float32)
    return out


def prefill_batch_specs(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    B = shape.global_batch
    out = {"tokens": _meta((B, _text_len(cfg, shape.seq_len)), torch.int32)}
    if cfg.n_vis_tokens:
        out["vis_embeds"] = _meta((B, cfg.n_vis_tokens, cfg.d_model), torch.float32)
    if cfg.family == "audio":
        out["frames"] = _meta((B, cfg.enc_seq_len, cfg.d_model), torch.float32)
    return out


def decode_specs(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    B, S = shape.global_batch, shape.seq_len
    return {"cache": lm.init_cache(cfg, B, S, device="meta"),
            "token": _meta((B,), torch.int32),
            "pos": _meta((), torch.int32)}


def gossip_specs(M: int) -> dict:
    return {"neighbors": _meta((M,), torch.int32),
            "weights": _meta((M,), torch.float32),
            "lr": _meta((), torch.float32)}


def input_specs(cfg: ArchConfig, shape_name: str, M: int, optimizer) -> dict:
    """All inputs of the program the shape's kind selects."""
    shape = SHAPES[shape_name]
    if shape.kind == "train":
        params, opt_state = abstract_stacked(cfg, optimizer, M)
        return {"params": params, "opt_state": opt_state,
                "batch": train_batch_specs(cfg, shape, M), "gossip_in": gossip_specs(M)}
    params = lm.init_params(cfg, device="meta")
    if shape.kind == "prefill":
        return {"params": params, "batch": prefill_batch_specs(cfg, shape)}
    return {"params": params, **decode_specs(cfg, shape)}
