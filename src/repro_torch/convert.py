"""Carry parameters across from the JAX package.

The JAX initialisers draw from ``jax.random``, which torch cannot
reproduce, so runs that must match the JAX package take its parameters as
numpy: the simulator's MLP through ``params_from_jax`` (for
``simulate(init_params=...)``), an LM's tree through ``lm_params_from_jax``,
an optimizer's state through ``opt_state_from_jax``.  This module does not
import ``jax``: anything ``np.asarray`` accepts will do.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_jax(tree) -> list[dict[str, torch.Tensor]]:
    """A list of ``{"w", "b"}`` dicts of arrays -> the same tree of CPU
    tensors, dtypes kept (``simulate`` moves them to its device)."""
    return [
        {k: torch.from_numpy(np.array(v, copy=True)) for k, v in layer.items()}
        for layer in tree
    ]


def _tensor(a) -> torch.Tensor:
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16, which torch cannot read
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def lm_params_from_jax(tree):
    """A JAX LM parameter tree (nested dicts of arrays, blocks stacked on a
    leading layer axis) -> the same tree of CPU tensors, dtypes kept."""
    if isinstance(tree, dict):
        return {k: lm_params_from_jax(v) for k, v in tree.items()}
    return _tensor(tree)


def opt_state_from_jax(state):
    """A JAX optimizer state (``repro.optim``: SGD's ``{"m"}``, ``{}`` without
    momentum, AdamW's ``{"m", "v", "t"}``; moments stacked like the params)
    -> the same tree of CPU tensors, dtypes kept (f32 moments, an int32
    step count)."""
    return lm_params_from_jax(state)
