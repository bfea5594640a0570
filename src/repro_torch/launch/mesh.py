"""Device-mesh helpers over ``torch.distributed.device_mesh.DeviceMesh``.

Only :func:`axis_size` is here so far; the JAX package's mesh builders
and sharding rules wait for the LM workload's parameter shardings
(ROADMAP A9).
"""
from __future__ import annotations


def axis_size(mesh, name: str) -> int:
    """The size of ``mesh``'s dimension ``name``, 1 when the mesh has no
    such dimension (as the JAX package's ``axis_size``)."""
    names = tuple(mesh.mesh_dim_names or ())
    if name not in names:
        return 1
    return int(mesh.shape[names.index(name)])
