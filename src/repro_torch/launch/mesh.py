"""Meshes of ranks — the port of ``repro/launch/mesh.py``, on
``torch.distributed.device_mesh.DeviceMesh``.

Single pod: 16×16 = 256 ranks, axes ("data", "model").
Multi-pod:  2×16×16 = 512 ranks, axes ("pod", "data", "model") — "pod"
joins "data" for batch sharding, so only gradient reductions cross the
slow links between pods.

A mesh spans the world of the default process group, which the caller
initialises (``torch.distributed.init_process_group``, or
``core.distributed.file_group``): ``init_device_mesh`` would otherwise
start one from environment variables.  Functions, not module
constants: importing this module touches no process group.
"""
from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.core.backend import resolve_device


def _mesh(shape, axes, device) -> DeviceMesh:
    """``shape`` (None: ``(world, 1)``) over the default group."""
    device = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("a mesh spans the default process group: "
                           "initialise torch.distributed first")
    world = dist.get_world_size()
    shape = (world, 1) if shape is None else tuple(shape)
    if math.prod(shape) != world:
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs "
                         f"{math.prod(shape)} ranks, the world has {world}")
    return init_device_mesh(device.type, shape,
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device=None) -> DeviceMesh:
    """16×16 ("data", "model"), or 2×16×16 ("pod", "data", "model") with
    ``multi_pod``; raises ``ValueError`` naming the ranks it needs when
    the world has another number.  ``device=None`` is the GPU."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device)


def batch_axes(mesh) -> tuple[str, ...]:
    """Axes used for batch sharding (everything but "model"), of a
    ``DeviceMesh`` or of a stand-in with the reference's ``axis_names``."""
    names = getattr(mesh, "mesh_dim_names", None) or mesh.axis_names
    return tuple(a for a in names if a != "model")


def make_host_mesh(shape=None, axes=("data", "model"),
                   device=None) -> DeviceMesh:
    """A small mesh over the default group's ranks, ``(world, 1)`` by
    default — used by tests and examples.  ``device=None`` is the GPU
    and raises without one."""
    return _mesh(shape, axes, device)


def axis_group(mesh: DeviceMesh, axes) -> tuple:
    """The process group over the mesh axes ``axes`` (a name or a tuple
    of names) that holds this rank -> (group, this rank's coordinate
    along ``axes``, the group's size).

    The coordinate is row-major over ``axes`` in the order given, as
    ``PartitionSpec(axes)`` splits a dimension, and it is the rank's
    rank in the group.  Every rank of the mesh must call this together
    (it creates one group for each point of the other axes)."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    names = list(mesh.mesh_dim_names)
    unknown = [a for a in axes if a not in names]
    if unknown or len(set(axes)) != len(axes):
        raise ValueError(f"axes {axes} must be distinct names of the "
                         f"mesh's {tuple(names)}")
    dims = [names.index(a) for a in axes]
    others = [d for d in range(len(names)) if d not in dims]
    size = math.prod(mesh.mesh.shape[d] for d in dims)
    rows = mesh.mesh.permute(*others, *dims).reshape(-1, size).tolist()
    me = dist.get_rank()
    mine = None
    for row in rows:
        group = dist.new_group(row)
        if me in row:
            mine = (group, row.index(me), size)
    if mine is None:
        raise RuntimeError(f"rank {me} is not in the mesh")
    return mine
