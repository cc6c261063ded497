"""Mesh construction over ``torch.distributed``.

The port of ``repro/launch/mesh.py``.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` built by ``init_device_mesh``
over the default process group (one rank a card), with the JAX package's
axis names: ``data`` and ``model``, and a leading ``pod`` for the
multi-pod mesh.  The single-pod mesh is 16 x 16 = 256 ranks, multi-pod
2 x 16 x 16 = 512.  Functions, not module-level constants: importing this
module touches no process group.

The helpers read axis sizes through ``mesh_shape``, which also takes a
plain ``{name: size}`` mapping (or any object whose ``.shape`` is one, as
the JAX package's ``Mesh.shape`` is), so a mesh can be planned without
being built.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np

PRODUCTION_SHAPE = {False: ((16, 16), ("data", "model")),
                    True: ((2, 16, 16), ("pod", "data", "model"))}


def mesh_shape(mesh) -> dict:
    """``{axis name: size}`` in mesh order, for a ``DeviceMesh`` (whose
    ``.shape`` is a tuple beside ``.mesh_dim_names``), a mapping, or an
    object whose ``.shape`` is a mapping."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    shape = mesh.shape
    if isinstance(shape, Mapping):
        return dict(shape)
    return dict(zip(mesh.mesh_dim_names, shape))


def _world_size() -> int:
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError("a mesh needs an initialised default process group "
                         "(torch.distributed.init_process_group)")
    return dist.get_world_size()


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """The 16 x 16 (data, model) mesh, or 2 x 16 x 16 (pod, data, model).

    Raises when the default group has fewer ranks than the mesh; with more,
    the mesh takes the first ranks, as the JAX function takes the first
    devices."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    shape, axes = PRODUCTION_SHAPE[multi_pod]
    n = int(np.prod(shape))
    world = _world_size()
    if world < n:
        raise RuntimeError(
            f"need {n} ranks for mesh {shape}; have {world} -- plan it with a "
            "{name: size} mapping instead, or run on that many cards")
    if world == n:
        return init_device_mesh(device_type, shape, mesh_dim_names=axes)
    return DeviceMesh(device_type, torch.arange(n).reshape(shape), mesh_dim_names=axes)


def make_debug_mesh(n_workers: int = 2, tp: int = 1, device_type: str = "cuda"):
    """A small (data, model) mesh over every rank of the default group
    (``n_workers * tp`` of them)."""
    from torch.distributed.device_mesh import init_device_mesh

    world = _world_size()
    if world != n_workers * tp:
        raise ValueError(f"a ({n_workers}, {tp}) mesh needs {n_workers * tp} ranks; "
                         f"the default group has {world}")
    return init_device_mesh(device_type, (n_workers, tp), mesh_dim_names=("data", "model"))


def worker_count(mesh, worker_axes: tuple) -> int:
    """Number of NetMax workers enumerated by the given mesh axes."""
    shape = mesh_shape(mesh)
    M = 1
    for ax in worker_axes:
        if ax in shape:
            M *= shape[ax]
    return M


def worker_axis_names(mesh, worker_axes: tuple) -> tuple:
    """The subset of worker_axes present in this mesh (single-pod drops 'pod')."""
    shape = mesh_shape(mesh)
    return tuple(ax for ax in worker_axes if ax in shape)
