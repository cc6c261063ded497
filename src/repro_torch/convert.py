"""Carry parameters across from the JAX package.

The JAX ``mlp_init`` draws from ``jax.random``, which torch cannot
reproduce, so runs that must match the JAX package take its initial
parameters as numpy and hand them to ``simulate(init_params=...)``.  This
module does not import ``jax``: anything ``np.asarray`` accepts will do.
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
