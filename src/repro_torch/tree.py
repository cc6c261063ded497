"""Parameter trees of the port: a list of ``{"w", "b"}`` dicts of tensors,
the same structure the JAX MLP uses (one dict per layer)."""

from __future__ import annotations


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leaf by leaf across trees of the same structure."""
    return [
        {k: fn(layer[k], *(r[i][k] for r in rest)) for k in layer}
        for i, layer in enumerate(tree)
    ]
