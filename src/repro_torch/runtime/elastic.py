"""Elastic scaling: move a state between devices, size a shrunk job.

Checkpoints hold *global* host arrays (``runtime/checkpoint.py``), so
elasticity is: gather to the host, place onto the new devices.  On one
card that is a host round trip and a device move (:func:`to_host`,
:func:`remesh_state`); a checkpointed session carry restores through the
same pair (``runtime/fault.py::with_ef_residuals``, which on the mesh
backend places each rank's own rows).  :func:`fold_batch` sizes the
per-replica batch of a mesh (a ``DeviceMesh`` or an ``AbstractMesh``).
:func:`remesh_params` moves a model's parameter shards onto a new mesh:
gathered whole by the old mesh's specs, cut by the new one's.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.launch.mesh import axis_size
from repro_torch.runtime.checkpoint import _host, _map_tree

PyTree = Any


def to_host(state: PyTree) -> PyTree:
    """Gather a tree of tensors to host copies (numpy arrays; bfloat16
    leaves, which numpy lacks, as CPU tensors)."""
    return _map_tree(state, lambda _, t: _host(t, copy=True))


def _place(leaf, device):
    t = leaf if isinstance(leaf, torch.Tensor) else torch.as_tensor(leaf)
    return t.to(torch.device(device))


def remesh_state(state: PyTree, devices: PyTree) -> PyTree:
    """Place a host (or other-device) state onto ``devices``, a tree of
    the same structure matched leaf by leaf (see :func:`replicated`)."""
    flat = {}
    _map_tree(devices, lambda k, dv: flat.__setitem__(k, dv))
    return _map_tree(state, lambda k, t: _place(t, flat[k]))


def replicated(device, tree: PyTree) -> PyTree:
    """A devices tree placing every leaf of ``tree`` on ``device``: the
    leaf-matched structure :func:`remesh_state` takes when a whole state
    restores onto one device."""
    return _map_tree(tree, lambda _k, _t: device)


def remesh_params(cfg, params: PyTree, new_mesh, rules=None, *,
                  old_mesh=None) -> PyTree:
    """This rank's shards of ``params`` on ``new_mesh`` under ``rules``
    (the defaults when None).  ``params`` is whole, or this rank's shards
    on ``old_mesh`` (gathered first: a collective of that mesh)."""
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.steps import params_shape
    rules = rules or sh.DEFAULT_RULES
    pshape = params_shape(cfg)
    if old_mesh is not None:
        params = sh.gather_tree(params, sh.param_specs(
            cfg, pshape, old_mesh, rules), old_mesh)
    return sh.shard_tree(params, sh.param_specs(cfg, pshape, new_mesh,
                                                rules), new_mesh)


def fold_batch(global_batch: int, mesh) -> Dict[str, int]:
    """Per-replica batch for an invariant global batch on any mesh size:
    data parallelism is the product of the ``data`` and ``pod`` axes."""
    dp = axis_size(mesh, "data") * axis_size(mesh, "pod")
    if global_batch % dp != 0:
        raise ValueError(
            f"global batch {global_batch} must divide data parallelism "
            f"{dp}; pad or regrid the batch")
    return {"data_parallel": dp, "per_replica": global_batch // dp}


def shrink_survivors(n_devices: int, lost: int, model_parallel: int) -> int:
    """Largest usable device count after losing ``lost`` devices, keeping
    the model-parallel group width (a TP group is one failure domain)."""
    alive = n_devices - lost
    return (alive // model_parallel) * model_parallel
