"""Device-mesh helpers over ``torch.distributed.device_mesh.DeviceMesh``
(the JAX package's ``launch/mesh.py``).

:func:`make_host_mesh` is the small mesh tests and single-host runs use:
``("data", "model")`` over the initialized world (one rank per replica
for LM training), or a one-rank mesh when no process group exists -- what
the reference's ``make_host_mesh`` gives on one device.  The production
meshes of the reference's TPU pods have no counterpart here.
"""
from __future__ import annotations

from typing import Tuple

import torch

SINGLE_POD_AXES: Tuple[str, ...] = ("data", "model")


class HostMesh:
    """A one-rank mesh for a process without a process group: the
    ``DeviceMesh`` attributes the port reads (``mesh_dim_names``,
    ``shape``, the rank array ``mesh``, ``device_type``)."""

    def __init__(self, device_type: str = "cuda",
                 axes: Tuple[str, ...] = SINGLE_POD_AXES):
        self.device_type = device_type
        self.mesh_dim_names = tuple(axes)
        self.shape = (1,) * len(axes)
        self.mesh = torch.zeros(self.shape, dtype=torch.int64)

    def __repr__(self) -> str:
        return f"HostMesh({self.device_type!r}, {self.mesh_dim_names})"


def make_host_mesh(model: int = 1, device_type: str = "cuda"):
    """``("data", "model") = (world // model, model)`` over the initialized
    world, or a one-rank :class:`HostMesh` without a process group."""
    import torch.distributed as dist
    if not dist.is_initialized():
        if model != 1:
            raise ValueError(f"model={model} needs a process group of "
                             f"{model}+ ranks; none is initialized")
        return HostMesh(device_type)
    n = dist.get_world_size()
    if n % model:
        raise ValueError(f"world size {n} does not split into model={model}")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, (n // model, model),
                            mesh_dim_names=SINGLE_POD_AXES)


def data_axes(mesh) -> Tuple[str, ...]:
    """Axes the global batch is sharded over (pod included when present)."""
    names = tuple(mesh.mesh_dim_names or ())
    return tuple(a for a in ("pod", "data") if a in names)


def axis_size(mesh, name: str) -> int:
    """The size of ``mesh``'s dimension ``name``, 1 when the mesh has no
    such dimension (as the JAX package's ``axis_size``)."""
    names = tuple(mesh.mesh_dim_names or ())
    if name not in names:
        return 1
    return int(mesh.shape[names.index(name)])
