"""Mesh factories (port of ``repro/launch/mesh.py``) over
``torch.distributed``. Functions, not module-level constants: importing
this module touches no device and no process group.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named dims
("data", "model"), or ("pod", "data", "model"). The port is multi-
controller: one process per rank, each started by ``torchrun`` (or given
its rank, world size and address by the caller), so a mesh needs an
initialised process group whose world size equals the mesh's size.
"""
from __future__ import annotations

import math

import torch.distributed as dist


def make_axes_mesh(shape, axes, *, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` over named ``axes`` on the current
    process group; raises, naming both sizes, when the world does not
    match."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in rank")
    n = math.prod(shape)
    if not dist.is_available() or not dist.is_initialized():
        raise ValueError(
            f"a {shape} mesh needs an initialised process group of {n} "
            "ranks — start one process per rank with torchrun (or use "
            "distrib.tp.serve_mesh, which starts a world of one for tp=1)")
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"a {shape} mesh needs {n} ranks, the process group "
                         f"has {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The production mesh: 16 x 16 = 256 ranks per pod; multi-pod adds a
    leading pod axis (2 x 16 x 16 = 512 ranks)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_axes_mesh(shape, axes, device_type=device_type)


def make_mesh(data: int, model: int, pods: int = 1, *,
              device_type: str = "cuda"):
    """Any (pods x data x model) mesh that matches the world size."""
    if pods > 1:
        return make_axes_mesh((pods, data, model), ("pod", "data", "model"),
                              device_type=device_type)
    return make_axes_mesh((data, model), ("data", "model"),
                          device_type=device_type)
