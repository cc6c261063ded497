"""NetMax training step on stacked LM replicas, driven by an ``Algorithm``.

A transcription of ``repro/train/trainer.py``, for one process and one
device or (with a mesh) one process a card.  Parameters are *stacked*
over the M NetMax workers (leading axis of every leaf); one round = every
worker performs one Alg.-2 iteration:

  1. per-worker loss and grads      (a loop over the workers; each worker's
                                     loss reads only its own row, and its
                                     grads land in that row; f32 sums over
                                     micro-batches, ``microbatch_scan``)
  2. optional clip                  (``clip_by_global_norm``)
  3. algorithm grad reduction       (identity | all-mean | group-mean)
  4. local optimizer step           (x_half; momenta stay worker-local)
  5. gossip pull of pre-round x     (gather | masked_psum | ppermute)
  6. algorithm consensus mix        (``Algorithm.mix_stacked``, or the fused
                                     tree mix ``ops.gossip_mix_tree`` -- the
                                     gossip-mix kernel on the card, one launch
                                     per tree -- under
                                     ``use_gossip_mix_kernel`` when the
                                     strategy's delta transform is the
                                     identity)

The JAX package vmaps ``value_and_grad`` over the workers; here the workers
run one after another, so the attention kernel and its backward see one
worker's batch at a time.  A batch holds (M, b, ...) ``tokens`` and
``labels``, and for the audio and vlm families f32 ``frames`` or
``vis_embeds`` (``launch/specs.train_batch_specs``), split over workers
and micro-batches alike.  On the card every attention call goes through
the flash-attention kernels (forward with LSE, and backward), and every
ssm time-mix's WKV recurrence through the WKV kernels (forward, and
backward); MoE routing, scatter and gather and the mamba scan run in
plain torch, as in the JAX package.  Every family is held to the JAX
trainer on the CPU (one round, remat on, the fused mix: the dense and ssm
families in ``tests/test_torch_trainer.py``, the moe, every_2 MoE,
hybrid, audio and vlm families in ``tests/test_torch_family_training.py``)
and trains on the card (``chip_smoke.py``: phi3.5-moe, whisper-small and
internvl2-1b at their published widths, each family's reduced cut card
against CPU).
With a mesh (``launch.mesh``) the step runs on every rank of a process
group, one a card: each rank steps its own rows of the stacked state, and
what spans the worker axis (the clip's norm, the strategy's grad
reduction, the pull, the mean loss) is a collective over the worker ranks
(``dist.sharding.WorkerShard``); held to the JAX trainer in gloo groups of
2, 4 and 8 ranks in ``tests/test_torch_dist.py``.  Tensor-parallel leaves
(a trailing dim on 'model') run each worker's loss and grads as DTensors
over the 'model' sub-mesh (``TensorParallel``); the rest of the step acts on
the local shards.
The legacy ``TrainStepConfig`` flags (``allreduce``, ``prague_groups``)
still select a strategy, with the JAX package's ``DeprecationWarning``s.
"""

from __future__ import annotations

import math
import warnings
from contextlib import nullcontext
from dataclasses import dataclass

import torch

from repro_torch.algos import Algorithm, get_algorithm
from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.dist import gossip
from repro_torch.dist.sharding import (P, distribute, local_part, local_slices, placements,
                                       spec_on, worker_rows, worker_shard)
from repro_torch.launch.mesh import mesh_shape, worker_axis_names
from repro_torch.kernels import ops as kops
from repro_torch.models import lm
from repro_torch.models.scan_utils import microbatch_scan
from repro_torch.optim import Optimizer
from repro_torch.optim.optimizers import clip_by_global_norm
from repro_torch.tree import tree_leaves, tree_map


@dataclass(frozen=True)
class TrainStepConfig:
    gossip_mode: str = "gather"  # gather | ppermute | masked_psum | none
    allreduce: bool = False  # DEPRECATED: use algo="allreduce"
    prague_groups: int = 0  # DEPRECATED: use algo="prague"
    use_gossip_mix_kernel: bool = False  # the fused tree mix (the CUDA kernel)
    grad_clip: float = 0.0


def resolve_algorithm(algo, step_cfg: TrainStepConfig) -> Algorithm:
    """Map the caller's strategy spec (Algorithm | name | legacy flags) to an
    Algorithm instance."""
    if algo is not None and (step_cfg.allreduce or step_cfg.prague_groups > 1):
        raise ValueError(
            "conflicting strategy specs: an explicit algo was given alongside "
            "legacy TrainStepConfig flags (allreduce/prague_groups); drop the "
            "flags"
        )
    if isinstance(algo, Algorithm):
        return algo
    if isinstance(algo, str):
        return get_algorithm(algo)
    # Legacy: derive the strategy from TrainStepConfig booleans.
    if step_cfg.allreduce:
        warnings.warn(
            "TrainStepConfig(allreduce=True) is deprecated; pass "
            "algo='allreduce' to make_train_step instead",
            DeprecationWarning, stacklevel=3,
        )
        return get_algorithm("allreduce")
    if step_cfg.prague_groups > 1:
        warnings.warn(
            "TrainStepConfig(prague_groups=...) is deprecated; pass "
            "algo='prague' to make_train_step instead",
            DeprecationWarning, stacklevel=3,
        )
        return get_algorithm("prague", trainer_groups=step_cfg.prague_groups)
    # Default gossip strategy: the mixing weights arrive per round via
    # gossip_in, so netmax covers the whole adaptive/uniform gossip family.
    return get_algorithm("netmax")


def _as_tensor(x, dtype, device):
    return torch.as_tensor(x).to(device=device, dtype=dtype)


def _model_axes(mesh, worker_axes, param_specs) -> tuple:
    """The mesh dims (in mesh order) that specs name past the worker dim,
    worker axes excepted: 'model' in every plan."""
    waxes = set(worker_axis_names(mesh, worker_axes))
    used = set()
    for spec in tree_leaves(param_specs):
        for entry in tuple(spec)[1:]:
            if entry is not None:
                used.update((entry,) if isinstance(entry, str) else entry)
    return tuple(n for n in mesh_shape(mesh) if n in used and n not in waxes)


def row_axes(mesh, worker_axes, model_axes) -> tuple:
    """The mesh dims of more than one rank (in mesh order) that hold neither
    a worker nor a split of a leaf: 'data' where the workers enumerate
    'pod' alone.  A worker's rows are shared out over them."""
    waxes = set(worker_axis_names(mesh, worker_axes))
    return tuple(n for n, size in mesh_shape(mesh).items()
                 if size > 1 and n not in waxes and n not in model_axes)


class TensorParallel:
    """The part of a plan past the worker dim: the sub-mesh of the mesh dim
    that param specs name there (``'model'``, where it has more than one
    rank) and of those that hold neither a worker nor a split
    (``row_axes``: 'data' where the workers enumerate 'pod' alone), and per
    leaf its spec with the worker dim dropped and whether it is split
    there.  A worker's rows run as DTensors on that sub-mesh (``wrap``,
    ``rows``), split over the row axes where they divide, with the params
    replicated there (so each rank's loss and grads are its rows' share,
    summed over those axes by the redistribution back to the params'
    placements); the rest of the step acts on the local shards.
    ``layout``: (split, whole) of the last micro-batch ``rows`` placed, the
    row axes its rows were shared out over and those whose ranks each ran
    them all."""

    def __init__(self, mesh, model_axes, param_specs, row_axes):
        self.mesh = mesh[tuple(n for n in mesh_shape(mesh)
                               if n in model_axes or n in row_axes)]
        self.model_axes, self.row_axes = tuple(model_axes), tuple(row_axes)
        self.specs = tree_map(lambda spec: spec_on(P(None, *tuple(spec)[1:]), self.mesh),
                              param_specs)
        self.split = [any(e is not None for e in spec) for spec in tree_leaves(self.specs)]
        self.layout = None

    @staticmethod
    def of(mesh, worker_axes, param_specs):
        """A ``TensorParallel``, or None when no spec splits past the worker
        dim and every mesh dim of more than one rank holds workers."""
        if mesh is None or param_specs is None:
            return None
        axes = _model_axes(mesh, worker_axes, param_specs)
        rows = row_axes(mesh, worker_axes, axes)
        return TensorParallel(mesh, axes, param_specs, rows) if axes or rows else None

    def wrap(self, params):
        """The stacked local shards as DTensors on the sub-mesh."""
        return distribute(params, self.specs, self.mesh)

    def rows(self, x):
        """A worker's micro-batch leaf (rows, ...), whole on every rank, as
        a DTensor: split over all row axes where their ranks divide the
        rows (each rank keeps its slice; no data moves), else over none,
        and replicated on the other dims."""
        from torch.distributed.tensor import DTensor

        ranks = math.prod(mesh_shape(self.mesh)[name] for name in self.row_axes)
        split = self.row_axes if x.shape[0] % ranks == 0 else ()
        self.layout = (split, tuple(a for a in self.row_axes if a not in split))
        spec = P(split, *([None] * (x.ndim - 1)))
        return DTensor.from_local(x[local_slices(x.shape, spec, self.mesh)], self.mesh,
                                  placements(spec, self.mesh), run_check=False,
                                  shape=x.shape, stride=x.stride())

    def sum(self, x):
        """``x`` summed, in place, over the ranks of the one 'model' dim (the
        row axes hold the params whole; without a 'model' dim nothing is
        split)."""
        import torch.distributed as dist

        if self.model_axes:
            dist.all_reduce(x, op=dist.ReduceOp.SUM,
                            group=self.mesh.get_group(self.model_axes[0]))
        return x


def make_train_step(
    cfg: ArchConfig,
    optimizer: Optimizer,
    M: int,
    algo: Algorithm | str | TrainStepConfig | None = None,
    step_cfg: TrainStepConfig | None = None,
    mesh=None,
    worker_axes: tuple = (),
    param_specs=None,
):
    """Returns train_step(params, opt_state, batch, gossip_in, *, perm=None)
    -> (params, opt_state, metrics).

    params/opt_state leaves: (M, ...), on one device.  batch leaves:
    (M, B/M, ...): int token ids and labels, and the family's f32 frames or
    vision tokens.  gossip_in: {'neighbors': (M,) ints,
    'weights': (M,) f32, 'lr': a number}, as numpy arrays or tensors.
    metrics: {'loss': the mean over workers, 'loss_per_worker': (M,)}.

    With a ``mesh`` (``launch.mesh``) and ``worker_axes``, each rank holds
    its rows of every stacked leaf of params, opt state and batch
    (``dist.sharding.worker_rows``) on its own device; ``gossip_in`` is the
    whole (M,) draw on every rank, and ``loss_per_worker`` all M losses.
    Whatever spans the worker axis is a collective over the worker ranks:
    the clip's global norm, the strategy's grad reduction, the pull and
    the mean loss.  ``param_specs`` (``dist.sharding.param_specs``) may also
    split a leaf's other dims over the mesh's 'model' dim: each rank then
    holds its slice of those leaves too, every worker's loss and grads run
    as DTensors over the 'model' sub-mesh (``TensorParallel``), and the
    clip's norm also sums over it; the optimizer, the pull and the mix act
    on the local shards.  A mesh dim of more than one rank that holds
    neither workers nor a split ('data' where the workers enumerate 'pod'
    alone) joins that sub-mesh, and each micro-batch's rows are shared out
    over it where they divide; ``train_step.row_layout()`` says after a
    step whether they were (``TensorParallel.layout``).
    ``gossip_mode="ppermute"`` needs a mesh; ``perm`` (one source a worker
    rank) defaults to the neighbours.

    ``algo``: an Algorithm instance or registry name.  Passing a
    TrainStepConfig here (the pre-registry calling convention) still works:
    its flags select the strategy through the deprecation shim.
    """
    if isinstance(algo, TrainStepConfig):
        if step_cfg is not None:
            raise ValueError("pass TrainStepConfig once, not twice")
        step_cfg = algo
        algo = None
    if step_cfg is None:
        step_cfg = TrainStepConfig()
    algorithm = resolve_algorithm(algo, step_cfg)
    if not algorithm.supports_trainer:
        raise NotImplementedError(
            f"algorithm {algorithm.name!r} has no lockstep SPMD form; "
            "use the event-driven simulator (train/simulator.py) instead"
        )
    if step_cfg.gossip_mode == "ppermute" and mesh is None:
        raise ValueError("gossip_mode='ppermute' pulls between the ranks of a mesh; "
                         "pass mesh= and worker_axes=")
    shard = None if mesh is None else worker_shard(mesh, worker_axes, M)
    reduce = None if shard is None else shard.sum
    tp = TensorParallel.of(mesh, worker_axes, param_specs)

    def per_worker(params, batch):
        """(losses (n,) f32, grads (n, ...) in the param dtype) for the n
        rows held here: worker i's loss on its own row of the params,
        differentiated into that row.  With a ``TensorParallel`` each row
        runs as DTensors on its sub-mesh, and its grads come back as this
        rank's shards."""
        n = tree_leaves(params)[0].shape[0]
        losses = torch.empty((n,), dtype=torch.float32, device=tree_leaves(batch)[0].device)
        grads = tree_map(torch.empty_like, params)
        source = params if tp is None else tp.wrap(params)
        for i in range(n):
            p_i = worker_leaves(source, i, lambda leaf: leaf.detach().requires_grad_())
            b_i = tree_map(lambda a: a[i], batch)
            with torch.enable_grad(), _implicit_replication(tp):
                if tp is not None:
                    b_i = tree_map(tp.rows, b_i)
                loss = lm.loss_fn(p_i, b_i, cfg)
                gs = torch.autograd.grad(loss, tree_leaves(p_i), allow_unused=True,
                                         materialize_grads=True)
            if tp is not None:
                loss = loss.full_tensor()
                gs = [g.redistribute(p.device_mesh, p.placements).to_local()
                      for g, p in zip(gs, tree_leaves(p_i))]
            for dst, g in zip(tree_leaves(worker_leaves(grads, i)), gs):
                dst.copy_(g)
            losses[i] = loss.detach()
            del loss, gs, p_i
        return losses, grads

    def gossip_pull(params, neighbors, perm):
        if step_cfg.gossip_mode == "gather":
            return gossip.pull_gather(params, neighbors, mesh, worker_axes)
        if step_cfg.gossip_mode == "masked_psum":
            return gossip.pull_masked_psum(params, neighbors, M, mesh, worker_axes)
        if step_cfg.gossip_mode == "ppermute":
            return gossip.pull_ppermute(params, perm, mesh, worker_axes, specs=param_specs)
        raise ValueError(step_cfg.gossip_mode)

    communicates = (
        algorithm.communicates_in_trainer
        and step_cfg.gossip_mode != "none"
        and M > 1
    )
    # The fused mix hard-codes the linear mix: only for the identity delta.
    fused_mix = (step_cfg.use_gossip_mix_kernel
                 and type(algorithm).delta_transform is Algorithm.delta_transform)

    def train_step(params, opt_state, batch, gossip_in, *, perm=None):
        leaves = tree_leaves(params)
        dev = leaves[0].device
        lr = gossip_in["lr"]
        lr = float(lr) if not isinstance(lr, torch.Tensor) else lr.to(dev)
        with torch.no_grad():
            losses, grads = microbatch_scan(per_worker, params, batch, cfg.microbatches)
            if step_cfg.grad_clip:
                split = None if tp is None else (tp.split, tp.sum)
                grads, _ = clip_by_global_norm(grads, step_cfg.grad_clip, reduce, split)
            # Strategy-owned grad reduction: identity for gossip, global mean
            # for allreduce/ps-sync, group mean for prague.
            grads = algorithm.transform_grads(grads, M, shard)
            updates, opt_state = optimizer.update(grads, opt_state, params, lr)
            del grads
            x_half = optimizer.apply(params, updates)
            del updates
            if communicates:
                # One host-to-device copy each, not one a leaf (each waits
                # for the device).
                neighbors = _as_tensor(gossip_in["neighbors"], torch.int64, dev)
                weights = _as_tensor(gossip_in["weights"], torch.float32, dev)
                if shard is not None:
                    weights = weights[shard.rows.start:shard.rows.stop]
                if step_cfg.gossip_mode == "ppermute":
                    perm = tuple(int(p) for p in (gossip_in["neighbors"] if perm is None
                                                  else perm))
                pulled = gossip_pull(params, neighbors, perm)
                if fused_mix:
                    new_params = kops.gossip_mix_tree(x_half, pulled, weights)
                else:
                    new_params = algorithm.mix_stacked(x_half, pulled, weights)
                del pulled, x_half
            else:
                new_params = x_half
            if shard is not None:
                losses = shard.gather(losses)
        metrics = {"loss": losses.mean(), "loss_per_worker": losses}
        return new_params, opt_state, metrics

    def row_layout():
        """(split, whole): the mesh dims that the last step shared each
        micro-batch's rows out over, and those whose ranks each ran them all
        (both empty where every dim of more than one rank holds workers or
        splits leaves)."""
        return ((), ()) if tp is None else tp.layout

    train_step.row_layout = row_layout
    return train_step


#: The keys of an LM tree whose leaves are stacked on a layer axis after the
#: worker axis (the models index them with ``transformer._layer``).
STACKED_BLOCKS = ("blocks", "enc_blocks", "dec_blocks")


def worker_leaves(params, i: int, fn=lambda leaf: leaf):
    """Worker i's row of stacked LM params, with each layer of the stacked
    blocks a leaf of its own (each of ``STACKED_BLOCKS`` becomes a list of
    per-layer trees, which the models take as they take the stacked form):
    the gradient of a view of one layer of a stacked leaf would be a
    zero-filled tensor of all layers, one per layer.  ``fn`` maps each
    view."""
    out = {}
    for k, v in params.items():
        if k in STACKED_BLOCKS:
            n_layers = tree_leaves(v)[0].shape[1]
            out[k] = [tree_map(lambda leaf: fn(leaf[i, layer]), v) for layer in range(n_layers)]
        else:
            out[k] = tree_map(lambda leaf: fn(leaf[i]), v)
    return out


def _implicit_replication(tp):
    """Plain tensors made inside the model (zeros, positions) count as
    replicated beside DTensors."""
    if tp is None:
        return nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication

    return implicit_replication()


def init_stacked(cfg: ArchConfig, optimizer: Optimizer, M: int, generator=None,
                 device=None, mesh=None, worker_axes: tuple = (), param_specs=None):
    """M identical worker replicas (paper Alg. 2 line 1 allows independent
    x_i^0; identical init is the common practical choice, as in the JAX
    package) and the optimizer state.  The parameters are drawn from
    ``generator`` on its device; without one, from a generator seeded 0 on
    ``device`` (CUDA unless the caller asks for the CPU).  With a ``mesh``
    and ``worker_axes``, this rank's rows of them (every rank draws the
    same seeded replica); with ``param_specs`` that split past the worker
    dim, this rank's slices of those leaves too (``dist.sharding.local_part``)."""
    if generator is None:
        generator = torch.Generator(device=resolve_device(device)).manual_seed(0)
    rows = M if mesh is None else len(worker_rows(mesh, worker_axes, M))
    params1 = lm.init_params(cfg, generator)
    params = tree_map(lambda leaf: leaf.unsqueeze(0).expand((rows,) + tuple(leaf.shape))
                      .contiguous(), params1)
    del params1
    if TensorParallel.of(mesh, worker_axes, param_specs) is not None:
        params = local_part(params, param_specs, mesh, skip=worker_axis_names(mesh, worker_axes))
    return params, optimizer.init(params)


def abstract_stacked(cfg: ArchConfig, optimizer: Optimizer, M: int):
    """The stacked training state's shapes and dtypes, as tensors on the
    ``meta`` device (nothing is allocated)."""
    p1 = lm.init_params(cfg, device="meta")
    params = tree_map(lambda leaf: leaf.unsqueeze(0).expand((M,) + tuple(leaf.shape)), p1)
    return params, optimizer.init(params)
