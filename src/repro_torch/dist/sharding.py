"""Sharding plans: map (arch config, mesh) -> partition specs.

The port of ``repro/dist/sharding.py``.  NetMax-DP shards the *stacked*
training state: every leaf carries a leading worker axis enumerated over
``cfg.worker_axes`` (single-pod meshes drop the 'pod' axis); the trailing
feature dim rides the 'model' axis when divisible (TP).  Serving drops the
worker dim and keeps TP only.  A mesh here is a ``DeviceMesh``, a
``{name: size}`` mapping or any object whose ``.shape`` is one
(``launch.mesh.mesh_shape``), so plans need no process group.

Specs are ``PartitionSpec``s, one entry a tensor dim: ``None``
(replicated), an axis name, or a tuple of names; they compare equal to the
JAX package's ``jax.sharding.PartitionSpec`` entry by entry.
``placements`` turns one into DTensor placements on a ``DeviceMesh``,
``distribute`` a tree of local shards into DTensors, ``local_shape`` and
``local_meta`` give a rank's shard shapes (the dry-run's inputs).

Where the worker rows lie, seen from one rank: ``worker_rows`` (the rows
of the stacked axis a rank holds), ``worker_ranks`` (the ranks holding
each worker block of its model slice) and ``WorkerShard`` (those and the
process group, with the row collectives the trainer and the engine need).
Worker axes that span several mesh dims flatten in mesh order, the order
of JAX's ``NamedSharding`` for ``P(("pod", "data"))`` and of DTensor's
``Shard`` placements.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.launch.mesh import mesh_shape, worker_axis_names, worker_count
from repro_torch.tree import tree_map


def _entry(e):
    """JAX's normal form: a one-name tuple is the name, an empty one None."""
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        return None if not e else e[0] if len(e) == 1 else e
    return e


class PartitionSpec:
    """One entry a tensor dim: None, an axis name, or a tuple of names."""

    __slots__ = ("entries",)

    def __init__(self, *entries):
        self.entries = tuple(_entry(e) for e in entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other):
        if isinstance(other, (PartitionSpec, tuple)):
            return self.entries == tuple(other)
        return NotImplemented

    def __hash__(self):
        return hash(self.entries)

    def __repr__(self):
        return f"PartitionSpec{self.entries!r}"


P = PartitionSpec


@dataclass(frozen=True)
class ShardingPlan:
    mesh: object
    n_workers: int
    worker_axes: tuple  # worker-enumeration axes present in this mesh
    model_axis: str = "model"

    def axis_size(self, name: str) -> int:
        return int(mesh_shape(self.mesh).get(name, 1))


def plan_for(cfg, mesh, serve: bool = False) -> ShardingPlan:
    """Resolve the worker/TP split for this config on this mesh."""
    if serve:
        return ShardingPlan(mesh=mesh, n_workers=1, worker_axes=())
    waxes = worker_axis_names(mesh, getattr(cfg, "worker_axes", ("pod", "data")))
    return ShardingPlan(mesh=mesh, n_workers=worker_count(mesh, waxes),
                        worker_axes=waxes)


def _tp(plan: ShardingPlan) -> int:
    return plan.axis_size(plan.model_axis)


def _leaf_spec(leaf, plan: ShardingPlan, stacked: bool) -> PartitionSpec:
    """Leading worker axes (stacked), trailing dim on 'model' when divisible."""
    ndim = leaf.ndim
    tp = _tp(plan)
    lead = [tuple(plan.worker_axes)] if stacked else []
    body_ndim = ndim - (1 if stacked else 0)
    body = [None] * body_ndim
    if body_ndim >= 1 and tp > 1:
        last = leaf.shape[-1]
        if last % tp == 0 and last >= tp:
            body[-1] = plan.model_axis
    return P(*lead, *body)


def param_specs(cfg, params, plan: ShardingPlan, stacked: bool = True):
    """PartitionSpec tree for (stacked) parameters."""
    return tree_map(lambda leaf: _leaf_spec(leaf, plan, stacked), params)


def batch_specs(cfg, plan: ShardingPlan, shape, stacked: bool = True):
    """Specs for the training batch: leading worker dim, rest replicated."""
    from repro_torch.launch import specs as sp

    abstract = sp.train_batch_specs(cfg, shape, max(plan.n_workers, 1))
    lead = tuple(plan.worker_axes)
    return tree_map(lambda leaf: P(lead, *([None] * (leaf.ndim - 1))), abstract)


def _data_axis_spec(plan: ShardingPlan, dim: int) -> object:
    data = plan.axis_size("data")
    return "data" if data > 1 and dim % data == 0 else None


def prefill_batch_specs(cfg, plan: ShardingPlan, batch):
    """Serve prefill: shard the batch dim over 'data', rest replicated."""
    return tree_map(
        lambda leaf: P(_data_axis_spec(plan, leaf.shape[0]), *([None] * (leaf.ndim - 1))),
        batch)


def cache_specs(cfg, cache, plan: ShardingPlan, global_batch: int):
    """Decode cache: shard the batch-sized axis over 'data' when present."""

    def leaf_spec(leaf):
        body = [None] * leaf.ndim
        for ax, dim in enumerate(leaf.shape):
            if dim == global_batch and _data_axis_spec(plan, dim) is not None:
                body[ax] = "data"
                break
        return P(*body)

    return tree_map(leaf_spec, cache)


def serve_batch_spec(plan: ShardingPlan, global_batch: int) -> PartitionSpec:
    return P(_data_axis_spec(plan, global_batch))


def placements(spec, mesh) -> list:
    """DTensor placements of a spec on a mesh: ``Shard(d)`` on each mesh dim
    that tensor dim d's entry names, ``Replicate()`` on the others.  A dim
    split over several mesh dims lists them in mesh order (DTensor splits
    in that order)."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh_shape(mesh))
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        pos = [names.index(ax) for ax in axes]
        if pos != sorted(pos):
            raise ValueError(f"dim {d} of {spec} names mesh dims out of mesh order "
                             f"{tuple(names)}; DTensor splits in mesh order")
        for p in pos:
            out[p] = Shard(d)
    return out


def spec_on(spec, mesh) -> PartitionSpec:
    """``spec`` restricted to ``mesh``'s dims: names of other mesh dims are
    dropped (a worker axis, seen from the 'model' sub-mesh)."""
    names = set(mesh_shape(mesh))

    def keep(entry):
        if entry is None:
            return None
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        return tuple(a for a in axes if a in names)

    return P(*(keep(e) for e in spec))


def local_shape(shape, spec, mesh) -> tuple:
    """A rank's shard of a tensor of global ``shape``: each dim divided by
    the sizes of the mesh dims its spec entry names (even splits only)."""
    sizes = mesh_shape(mesh)
    out = list(shape)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for ax in (entry,) if isinstance(entry, str) else entry:
            n = int(sizes.get(ax, 1))
            if out[d] % n:
                raise ValueError(f"dim {d} of {tuple(shape)} does not split evenly over "
                                 f"{ax!r} ({n}); spec {spec}")
            out[d] //= n
    return tuple(out)


def local_meta(tree, specs, mesh):
    """``meta`` tensors of each leaf's local shape: a rank's shards of a tree
    of (global) tensors, allocating nothing."""
    return tree_map(lambda leaf, spec: torch.empty(local_shape(leaf.shape, spec, mesh),
                                                   dtype=leaf.dtype, device="meta"),
                    tree, specs)


def local_slices(shape, spec, mesh, skip=()) -> tuple:
    """The slices of a tensor of global ``shape`` that this rank holds on the
    ``DeviceMesh`` ``mesh``: each dim cut at the rank's coordinates on the
    mesh dims its spec entry names (a dim over several, flattened in mesh
    order), except the names in ``skip``."""
    names = list(mesh_shape(mesh))
    out = []
    for d, size in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        axes = () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)
        axes = [a for a in names if a in axes and a not in skip]
        n, index = 1, 0
        for a in axes:
            k = int(mesh_shape(mesh)[a])
            n, index = n * k, index * k + mesh.get_local_rank(a)
        per = size // n
        out.append(slice(index * per, (index + 1) * per))
    return tuple(out)


def local_part(tree, specs, mesh, skip=()):
    """This rank's part of each leaf of a tree held whole along the mesh
    dims the specs name (``local_slices``), as contiguous copies."""
    return tree_map(lambda x, spec: x[local_slices(x.shape, spec, mesh, skip)].contiguous(),
                    tree, specs)


def distribute(tree, specs, mesh):
    """DTensors on the ``DeviceMesh`` ``mesh`` from this rank's local shards
    (on any device, ``meta`` too), placed by ``placements`` of each spec
    restricted to the mesh (``spec_on``); no data moves."""
    from torch.distributed.tensor import DTensor

    def leaf(x, spec):
        return DTensor.from_local(x, mesh, placements(spec_on(spec, mesh), mesh),
                                  run_check=False)

    return tree_map(leaf, tree, specs)


def _rank_grid(mesh) -> np.ndarray:
    """The ranks of the mesh laid out on its dims (``init_device_mesh``'s
    row-major layout for a planned mesh)."""
    if hasattr(mesh, "mesh") and isinstance(mesh.mesh, torch.Tensor):
        return mesh.mesh.cpu().numpy()
    sizes = tuple(mesh_shape(mesh).values())
    return np.arange(int(np.prod(sizes))).reshape(sizes)


def _my_rank(rank):
    if rank is not None:
        return int(rank)
    import torch.distributed as dist

    return dist.get_rank()


def worker_ranks(mesh, worker_axes, rank=None) -> tuple:
    """The ranks that hold the worker blocks of ``rank``'s model slice, in
    worker order: the ranks sharing its coordinates on every other mesh
    dim, flattened over the worker dims in mesh order."""
    names = list(mesh_shape(mesh))
    axes = worker_axis_names(mesh, worker_axes)
    grid = _rank_grid(mesh)
    coords = np.argwhere(grid == _my_rank(rank))
    if not len(coords):
        raise ValueError(f"rank {_my_rank(rank)} is not in the mesh")
    index = tuple(slice(None) if name in axes else int(c)
                  for name, c in zip(names, coords[0]))
    return tuple(int(r) for r in grid[index].reshape(-1))


def worker_rows(mesh, worker_axes, n_rows: int, rank=None) -> range:
    """The rows of a stacked worker axis of ``n_rows`` that ``rank`` holds
    (the caller's rank by default)."""
    ranks = worker_ranks(mesh, worker_axes, rank)
    if n_rows % len(ranks):
        raise ValueError(f"{n_rows} worker rows do not split over {len(ranks)} "
                         "worker ranks")
    per = n_rows // len(ranks)
    i = ranks.index(_my_rank(rank))
    return range(i * per, (i + 1) * per)


@dataclass(frozen=True)
class WorkerShard:
    """This rank's share of a stacked worker axis of M rows on a mesh: its
    ``rows``, the ``ranks`` of the worker blocks of its model slice (in
    worker order), its own ``block`` among them, and the process ``group``
    over them (ranks in the same order)."""

    M: int
    rows: range
    ranks: tuple
    block: int
    group: object

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """All M rows of a stacked tensor of which this rank holds its rows."""
        import torch.distributed as dist

        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in self.ranks]
        dist.all_gather(parts, x, group=self.group)
        return torch.cat(parts)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the worker ranks, in place."""
        import torch.distributed as dist

        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.group)
        return x


def worker_shard(mesh, worker_axes, M: int) -> WorkerShard | None:
    """The calling rank's ``WorkerShard`` of M rows, or None when no worker
    axis is in the mesh (every rank holds all rows)."""
    axes = worker_axis_names(mesh, worker_axes)
    if not axes:
        return None
    ranks = worker_ranks(mesh, axes)
    rows = worker_rows(mesh, axes, M)
    names = [n for n in mesh_shape(mesh) if n in axes]  # mesh order
    if len(names) == 1:
        group = mesh.get_group(names[0])
    else:
        group = mesh[tuple(names)]._flatten().get_group()
    return WorkerShard(M=M, rows=rows, ranks=ranks, block=ranks.index(_my_rank(None)),
                       group=group)
