"""Parameter trees of the port, by JAX's pytree rules.

A tree is a dict, list or tuple of subtrees, ``None`` (a node with no
leaves), or a leaf (anything else: a tensor, a number).  Leaves come in
``jax.tree_util``'s order: list and tuple items in order, dict items by
sorted key.  The simulator's MLP is a list of ``{"w", "b"}`` dicts, so its
leaves run ``b`` then ``w`` in each layer; an LM's parameters are nested
dicts.  Rebuilt dicts hold their keys in sorted order, as JAX's do.
"""

from __future__ import annotations


def _check_children(kind, n, rest):
    for r in rest:
        if not isinstance(r, kind) or len(r) != n:
            raise ValueError(f"tree structures differ: a {kind.__name__} of {n} "
                             f"against {type(r).__name__} {r!r:.60}")


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leaf by leaf across trees of the same structure."""
    if isinstance(tree, dict):
        _check_children(dict, len(tree), rest)
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        _check_children(type(tree), len(tree), rest)
        out = [tree_map(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    if tree is None:
        return None
    return fn(tree, *rest)


def _flatten(t, leaves: list):
    if isinstance(t, dict):
        keys = sorted(t)
        return (dict, keys, [_flatten(t[k], leaves) for k in keys])
    if isinstance(t, (list, tuple)):
        return (type(t), len(t), [_flatten(x, leaves) for x in t])
    if t is None:
        return None
    leaves.append(t)
    return ...


def tree_flatten(tree):
    """(leaves in JAX's order, treedef for ``tree_unflatten``).

    The recursion is a module-level function, not a closure over itself: a
    self-referencing closure is a reference cycle, which would keep every
    leaf it saw alive until Python's cycle collector runs."""
    leaves: list = []
    return leaves, _flatten(tree, leaves)


def _unflatten(d, it):
    if d is ...:
        return next(it)
    if d is None:
        return None
    kind, keys, kids = d
    if kind is dict:
        return {k: _unflatten(c, it) for k, c in zip(keys, kids)}
    out = [_unflatten(c, it) for c in kids]
    return out if kind is list else tuple(out)


def tree_unflatten(treedef, leaves):
    """Rebuild the tree ``tree_flatten`` described, from its leaves in order."""
    return _unflatten(treedef, iter(leaves))


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in JAX's order."""
    return tree_flatten(tree)[0]
