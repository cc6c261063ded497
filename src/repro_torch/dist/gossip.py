"""Gossip pulls and the consensus mix on stacked replicas.

A transcription of ``repro/dist/gossip.py``: "worker i pulls the pre-round
params of neighbour m_i", over leaves stacked (M, ...) on the worker axis.

  pull_gather       ``index_select`` along the worker axis.
  pull_masked_psum  the one-hot contraction over the worker axis, cast back
                    to the leaf dtype.
  pull_ppermute     point-to-point: worker block i receives block perm[i]
                    through ``torch.distributed.batch_isend_irecv``.

Without a mesh every leaf holds all M rows on one device.  With a mesh
(``launch.mesh``) and worker axes, each rank holds its rows of the stacked
axis (``dist.sharding.worker_rows``) and gets back its rows of the pull, in
the cross-rank form GSPMD gives the JAX package: the gather is an
``all_gather`` of the rows over the worker group, then ``index_select``;
the masked psum is the local one-hot partial contraction, then an
``all_reduce(SUM)``.  ``pull_ppermute`` sends whole blocks between ranks;
a block whose source is its own rank is a local copy.  JAX's
collective-permute needs a permutation; the point-to-point form also
serves a draw with repeated sources (a source sends to each reader).  All
three give the same values (a one-hot row picks one replica exactly).
"""

from __future__ import annotations

import torch

from repro_torch.dist.sharding import worker_shard
from repro_torch.tree import tree_flatten, tree_map, tree_unflatten


def _index(neighbors, device):
    return torch.as_tensor(neighbors, device=device).long()


def pull_gather(params, neighbors, mesh=None, worker_axes=()):
    """pulled[i] = params[neighbors[i]], along the stacked axis; with a
    mesh, this rank's rows of it."""
    shard = None if mesh is None else worker_shard(mesh, worker_axes, len(neighbors))
    if shard is None:
        return tree_map(lambda x: torch.index_select(x, 0, _index(neighbors, x.device)),
                        params)

    def leaf(x):
        nb = _index(neighbors, x.device)[shard.rows.start:shard.rows.stop]
        return torch.index_select(shard.gather(x), 0, nb)

    return tree_map(leaf, params)


def pull_masked_psum(params, neighbors, M: int, mesh=None, worker_axes=()):
    """One-hot contraction over the worker axis, in the leaf dtype; with a
    mesh, over this rank's rows, summed across the worker ranks."""
    shard = None if mesh is None else worker_shard(mesh, worker_axes, M)

    def leaf(x):
        oh = torch.nn.functional.one_hot(_index(neighbors, x.device), M).to(x.dtype)
        if shard is None:
            return torch.einsum("ij,j...->i...", oh, x).to(x.dtype)
        lo, hi = shard.rows.start, shard.rows.stop
        part = torch.einsum("ij,j...->i...", oh[:, lo:hi], x).to(x.dtype).contiguous()
        return shard.sum(part)[lo:hi]

    return tree_map(leaf, params)


def pull_ppermute(params, perm, mesh, worker_axes, specs=None):
    """Point-to-point pull: worker block i receives block perm[i].

    ``perm``: one source block a worker block of the mesh (its length is
    the number of worker ranks).  A leaf split over 'model' too sends this
    rank's slice to the ranks of the same 'model' coordinate
    (``dist.sharding.worker_ranks``).  ``specs`` (the params' partition
    specs) is accepted for the JAX signature and not needed.  With no
    worker axis in the mesh this is ``pull_gather``.
    """
    shard = None if mesh is None else worker_shard(mesh, worker_axes, len(perm))
    if shard is None:
        return pull_gather(params, perm)
    import torch.distributed as dist

    n, me = len(shard.ranks), shard.block
    if len(perm) != n:
        raise ValueError(f"perm has {len(perm)} sources for {n} worker ranks")
    src = int(perm[me])
    readers = [i for i in range(n) if int(perm[i]) == me and i != me]
    leaves, treedef = tree_flatten(params)
    out, ops = [], []
    for tag, x in enumerate(leaves):
        x = x.contiguous()
        if src == me:
            out.append(x.clone())
        else:
            out.append(torch.empty_like(x))
            ops.append(dist.P2POp(dist.irecv, out[-1], shard.ranks[src], tag=tag))
        ops += [dist.P2POp(dist.isend, x, shard.ranks[i], tag=tag) for i in readers]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return tree_unflatten(treedef, out)


def mix(x_half, pulled, weights):
    """Consensus mix on stacked replicas (Alg. 2 lines 13-15):
    out_i = (1 - w_i) * x_half_i + w_i * pulled_i, with the weights cast to
    each leaf's dtype."""
    def leaf(h, p):
        w = weights.reshape((-1,) + (1,) * (h.ndim - 1)).to(h.dtype)
        return (1.0 - w) * h + w * p

    return tree_map(leaf, x_half, pulled)
