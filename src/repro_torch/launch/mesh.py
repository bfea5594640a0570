"""Device-mesh helpers over ``torch.distributed.device_mesh.DeviceMesh``
(the JAX package's ``launch/mesh.py``).

The reference's production meshes are one pod as ``("data", "model") =
(16, 16)`` and two pods as ``("pod", "data", "model") = (2, 16, 16)``:
:func:`make_production_mesh` lays them over an initialized world of 256 or
512 ranks.  :func:`make_abstract_mesh` gives the same names and sizes with
no process group, which is what the sharding rules (``launch/sharding.py``)
and ``fold_batch`` read.  :func:`make_host_mesh` is the small mesh tests
and single-host runs use: ``("data", "model")`` over the initialized world,
or a one-rank mesh when no process group exists -- what the reference's
``make_host_mesh`` gives on one device.  :class:`RankMesh` names any block
of a world's ranks as a mesh (a test's two (1, 2) meshes in a world of
four), and :func:`axis_slice` the ranks at one coordinate of an axis (a
TreeSync mesh's replicas that share a ``model`` coordinate).

Every mesh here exposes what ``DeviceMesh`` does and the port reads:
``mesh_dim_names``, ``shape`` and, for a mesh with ranks, the rank array
``mesh`` (row-major) and ``device_type``.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

SINGLE_POD_SHAPE: Tuple[int, ...] = (16, 16)
SINGLE_POD_AXES: Tuple[str, ...] = ("data", "model")
MULTI_POD_SHAPE: Tuple[int, ...] = (2, 16, 16)
MULTI_POD_AXES: Tuple[str, ...] = ("pod", "data", "model")


class AbstractMesh:
    """Axis names and sizes, no ranks and no process group (the
    reference's ``jax.sharding.AbstractMesh``)."""

    device_type = None

    def __init__(self, shape: Sequence[int], axes: Sequence[str]):
        if len(shape) != len(axes):
            raise ValueError(f"shape {tuple(shape)} and axes {tuple(axes)} "
                             f"differ in length")
        self.shape = tuple(int(s) for s in shape)
        self.mesh_dim_names = tuple(axes)

    def __repr__(self) -> str:
        return (f"AbstractMesh({dict(zip(self.mesh_dim_names, self.shape))})")


class RankMesh(AbstractMesh):
    """A mesh over given ranks of the initialized world: ``ranks`` an int
    array of the mesh's shape (the rank at each coordinate).  The groups
    of its axes are built where they are used (``models/shardctx.py``)."""

    def __init__(self, ranks, axes: Sequence[str] = SINGLE_POD_AXES,
                 device_type: str = "cuda"):
        ranks = torch.as_tensor(ranks, dtype=torch.int64)
        super().__init__(tuple(ranks.shape), axes)
        self.mesh = ranks
        self.device_type = device_type

    def __repr__(self) -> str:
        return (f"{type(self).__name__}({self.device_type!r}, "
                f"{dict(zip(self.mesh_dim_names, self.shape))}, "
                f"ranks={self.mesh.flatten().tolist()})")


class HostMesh(RankMesh):
    """A one-rank mesh for a process without a process group."""

    def __init__(self, device_type: str = "cuda",
                 axes: Tuple[str, ...] = SINGLE_POD_AXES):
        super().__init__(torch.zeros((1,) * len(axes), dtype=torch.int64),
                         axes, device_type)


def make_abstract_mesh(shape: Tuple[int, ...],
                       axes: Tuple[str, ...]) -> AbstractMesh:
    """An :class:`AbstractMesh` of ``shape`` named ``axes``."""
    return AbstractMesh(shape, axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The reference's production mesh over the initialized world:
    ``(16, 16)`` as ``("data", "model")``, or ``(2, 16, 16)`` as
    ``("pod", "data", "model")`` with ``multi_pod``.  Raises a
    ``ValueError`` naming the world size when it is another size."""
    import torch.distributed as dist
    shape = MULTI_POD_SHAPE if multi_pod else SINGLE_POD_SHAPE
    axes = MULTI_POD_AXES if multi_pod else SINGLE_POD_AXES
    need = 1
    for s in shape:
        need *= s
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != need:
        raise ValueError(f"the production mesh {dict(zip(axes, shape))} "
                         f"needs a world of {need} ranks; the world has "
                         f"{world}")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


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


def axis_slice(mesh, name: str, index: int) -> RankMesh:
    """The ranks of ``mesh`` at coordinate ``index`` of axis ``name``, as a
    :class:`RankMesh` with the same axes (``name`` of size 1): a TreeSync
    mesh's replicas at one ``model`` coordinate."""
    names = tuple(mesh.mesh_dim_names or ())
    ranks = torch.as_tensor(mesh.mesh).narrow(names.index(name), index, 1)
    return RankMesh(ranks, names, device_type=mesh.device_type)


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


def mesh_coords(mesh, rank: Optional[int] = None) -> Dict[str, int]:
    """``{axis: coordinate}`` of ``rank`` (this process's rank by default)
    in ``mesh``: its position in the rank array, or for an
    :class:`AbstractMesh` the row-major position of index ``rank``."""
    names = tuple(mesh.mesh_dim_names or ())
    if rank is None:
        import torch.distributed as dist
        rank = dist.get_rank() if dist.is_initialized() else 0
    ranks = getattr(mesh, "mesh", None)
    if ranks is None:
        flat = int(rank)
        n = 1
        for s in mesh.shape:
            n *= int(s)
        if not 0 <= flat < n:
            raise ValueError(f"index {rank} outside the mesh {mesh}")
    else:
        hits = (torch.as_tensor(ranks).flatten() == int(rank)).nonzero()
        if hits.numel() != 1:
            raise ValueError(f"rank {rank} is not in the mesh {mesh}")
        flat = int(hits[0, 0])
    out = {}
    for name, size in reversed(list(zip(names, mesh.shape))):
        out[name] = flat % int(size)
        flat //= int(size)
    return {a: out[a] for a in names}
