"""Gossip pulls and the consensus mix on stacked replicas.

A transcription of ``repro/dist/gossip.py`` for one process: the replicas
of all M workers lie stacked on the leading axis of every leaf, on one
device, and "worker i pulls the pre-round params of neighbour m_i" is a
selection along that axis.

  pull_gather       ``index_select`` along the worker axis.
  pull_masked_psum  the one-hot contraction over the worker axis, cast back
                    to the leaf dtype (in JAX it lowers to a masked psum).
  pull_ppermute     a point-to-point pull between devices; it needs one
                    process group per card and is not ported yet.

Both ported pulls give the same values (a one-hot row picks one replica
exactly).
"""

from __future__ import annotations

import torch

from repro_torch.tree import tree_map


def pull_gather(params, neighbors):
    """pulled[i] = params[neighbors[i]], along the stacked axis."""
    def leaf(x):
        return torch.index_select(x, 0, torch.as_tensor(neighbors, device=x.device).long())

    return tree_map(leaf, params)


def pull_masked_psum(params, neighbors, M: int):
    """One-hot contraction over the worker axis, in the leaf dtype."""
    def leaf(x):
        nb = torch.as_tensor(neighbors, device=x.device).long()
        oh = torch.nn.functional.one_hot(nb, M).to(x.dtype)
        return torch.einsum("ij,j...->i...", oh, x).to(x.dtype)

    return tree_map(leaf, params)


def pull_ppermute(params, perm, mesh, worker_axes, specs=None):
    """The JAX package's collective-permute pull across devices."""
    raise NotImplementedError(
        "pull_ppermute needs one process group per card (torch.distributed "
        "point-to-point); it is not ported yet (ROADMAP A5, the multi-card "
        "trainer); use gossip_mode='gather' or 'masked_psum'"
    )


def mix(x_half, pulled, weights):
    """Consensus mix on stacked replicas (Alg. 2 lines 13-15):
    out_i = (1 - w_i) * x_half_i + w_i * pulled_i, with the weights cast to
    each leaf's dtype."""
    def leaf(h, p):
        w = weights.reshape((-1,) + (1,) * (h.ndim - 1)).to(h.dtype)
        return (1.0 - w) * h + w * p

    return tree_map(leaf, x_half, pulled)
