"""Gossip compression: sparsified / quantized pulls with error feedback.

The torch transcription of the JAX package's ``core/compression.py``.  The
consensus mix moves ``w * (x_pull - x_half)``; compressing that delta before
it crosses a slow link cuts collective bytes by the compression ratio.
Error feedback (Karimireddy et al. style memory) keeps the compression
unbiased in the long run.

Every op works on any tree of ``tree.py`` and on any device.  Differences
from the JAX module, none of which changes a deterministic result:

* ``topk_mask`` picks its indices with a stable descending sort of |x|, so
  ties keep the lower index, as ``jax.lax.top_k`` does (``torch.topk``
  promises no order on ties).  It builds the mask out of place, so it runs
  under ``torch.func.vmap``;
* the random ops (``randk_mask``, stochastic rounding) draw from an explicit
  ``torch.Generator`` instead of a JAX key, so their draws differ from JAX's
  while their laws are the same.
"""

from __future__ import annotations

import torch

from repro_torch.tree import tree_flatten, tree_map, tree_unflatten


def _flatten(tree):
    leaves, treedef = tree_flatten(tree)
    shapes = [tuple(l.shape) for l in leaves]
    sizes = [l.numel() for l in leaves]
    flat = (torch.cat([l.reshape(-1) for l in leaves]) if leaves
            else torch.zeros((0,)))
    return flat, (treedef, shapes, sizes)


def _unflatten(flat, spec):
    treedef, shapes, sizes = spec
    leaves = []
    off = 0
    for shp, sz in zip(shapes, sizes):
        leaves.append(flat[off:off + sz].reshape(shp))
        off += sz
    return tree_unflatten(treedef, leaves)


def _mask(flat, idx):
    return torch.zeros_like(flat).scatter(0, idx, 1.0)


def topk_mask(flat: torch.Tensor, k: int) -> torch.Tensor:
    """Keep the k largest-magnitude entries, zero the rest (ties: the lower
    index is kept)."""
    if k >= flat.numel():
        return flat
    idx = torch.sort(flat.abs(), descending=True, stable=True).indices[:k]
    return flat * _mask(flat, idx)


def randk_mask(flat: torch.Tensor, k: int, generator: torch.Generator) -> torch.Tensor:
    """Keep k uniformly random entries, rescaled by n / k to stay unbiased."""
    if k >= flat.numel():
        return flat
    idx = torch.randperm(flat.numel(), generator=generator,
                         device=generator.device)[:k].to(flat.device)
    return flat * _mask(flat, idx) * (flat.numel() / k)


def quantize_int8(flat: torch.Tensor, generator: torch.Generator | None = None):
    """Symmetric int8 quantization with optional stochastic rounding."""
    scale = torch.clamp(flat.abs().max(), min=1e-12) / 127.0
    x = flat / scale
    if generator is not None:
        u = torch.rand(x.shape, generator=generator, device=generator.device)
        x = torch.floor(x + u.to(x.device))
    else:
        x = torch.round(x)
    q = torch.clamp(x, -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


class ErrorFeedback:
    """Per-worker error-feedback memory for compressed gossip deltas.

    usage:
        delta = pulled - x_half                        # what we want to send
        sent, state = ef.compress(delta, state)        # compress with memory
        state captures what was dropped; next round re-injects it.
    """

    def __init__(self, ratio: float = 0.01, mode: str = "topk"):
        assert mode in ("topk", "randk")
        self.ratio = float(ratio)
        self.mode = mode

    def init_state(self, tree):
        return tree_map(torch.zeros_like, tree)

    def compress(self, delta_tree, state_tree, generator: torch.Generator | None = None):
        flat, spec = _flatten(delta_tree)
        sflat, _ = _flatten(state_tree)
        target = flat + sflat
        k = max(1, int(self.ratio * target.numel()))
        if self.mode == "topk":
            sent = topk_mask(target, k)
        else:
            assert generator is not None, "randk needs a torch.Generator"
            sent = randk_mask(target, k, generator)
        new_state = target - sent
        return _unflatten(sent, spec), _unflatten(new_state, spec)

    def bytes_ratio(self) -> float:
        """Approximate wire-bytes ratio (values + int32 indices vs dense f32)."""
        return self.ratio * 2.0  # value + index per kept entry
