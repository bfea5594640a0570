"""TreeDualMethod on the mesh: the paper's Algorithms 1-3 run as a
``torch.distributed`` program, one rank per leaf, through the mesh
backend (``core/engine/mesh.py``), with the ``sdca_block`` kernel on
every rank.

The tree is the mesh-axis hierarchy itself:

  leaves         = ranks along the innermost sync axis (e.g. "data"),
                   each owning a contiguous block of the dual vector;
  level-l node   = the group of ranks sharing coordinates on the axes
                   above axis l;
  level-l round  = H_l leaf solves + an average of delta_w over axis l.

E.g. axes=("data", "pod"), rounds=(3, R): each cross-pod round runs 3
intra-pod rounds, then averages w over "pod" -- Algorithm 2's nesting
with K = the axis size at each level, keeping w = A alpha (the paper's
eq. (13)).  The mesh backend consumes the same compiled plan and key
replay as the host backend, so :func:`mesh_tree_dual_solve` gives the
host backend's iterates on the equivalent balanced tree.
"""
from __future__ import annotations

import warnings
from typing import Sequence, Tuple

import torch

from repro_torch.core.dual import Loss
from repro_torch.core.engine.mesh import tree_from_mesh_axes
from repro_torch.launch.mesh import axis_size

Tensor = torch.Tensor


def mesh_tree_dual_solve(
    X: Tensor,                   # (m, d) global data (rows = examples)
    y: Tensor,                   # (m,)
    mesh,                        # a DeviceMesh, one rank per leaf
    *,
    loss: Loss,
    lam: float,
    axes: Sequence[str] = ("data",),   # innermost (leaf) level first
    rounds: Sequence[int] = (10,),     # rounds per level, aligned to axes
    local_steps: int = 64,             # H at the leaves
    key=None,
    use_kernel: bool = True,
    device="cuda",
) -> Tuple[Tensor, Tensor]:
    """DEPRECATED shim: the mesh program behind the sessionized surface --
    ``Session.compile(..., backend="mesh", mesh=mesh)``.  Returns (alpha
    (m,), w (d,)) on every rank."""
    warnings.warn(
        "mesh_tree_dual_solve is a legacy shim; use repro_torch.api.Session "
        "with backend='mesh' instead", DeprecationWarning, stacklevel=2)
    from repro_torch import api
    if len(axes) != len(rounds):
        raise ValueError(f"{len(axes)} axes but {len(rounds)} round counts")
    m = X.shape[0]
    n_leaves = 1
    for a in axes:
        n_leaves *= axis_size(mesh, a)
    if m % n_leaves:
        raise ValueError(f"{m} rows do not split into {n_leaves} leaves")
    tree = tree_from_mesh_axes(mesh, axes, rounds, local_steps=local_steps,
                               m_leaf=m // n_leaves)
    res = api.solve(
        api.Problem(X, y, loss=loss, lam=lam), api.Topology.from_tree(tree),
        backend="mesh", device=device, mesh=mesh, mesh_axes=tuple(axes),
        key=key, mesh_use_kernel=use_kernel, record_history=False)
    return res.alpha, res.w
