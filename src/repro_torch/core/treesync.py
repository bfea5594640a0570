"""TreeSync: the paper's tree-structured synchronization schedule for
data-parallel LM training (the JAX package's ``core/treesync.py``).

  level 0  local optimizer steps on every replica   (H_0 = period between
           level-1 syncs)
  level 1  average replicas over the "data" axis    (the fast link)
  level 2  average over the "pod" axis              (the slow link),
           optionally int8-compressed with error feedback

Here each replica is one ``torch.distributed`` rank (``core/engine/lm.py``):
a level-l sync is a mean over the ranks of that level's sync group.
periods=(1, 1) makes every step fully synchronous: with SGD this is
standard data parallelism, the paper's star-network special case.

This module keeps the reference's legacy static-periods surface as thin
shims: ``make_treesync_step`` is deprecated in favor of ``Problem.lm(...)``
+ ``Session.compile(backend="mesh")`` (``api/lm.py``).  Tensor
parallelism inside a replica (the reference's ``tp_rules`` /
``replica_specs`` over the ``model`` axis) comes with
``launch/sharding.py`` (ROADMAP); a mesh whose ``model`` axis is larger
than 1 is refused until then.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import compression as comp_mod
from repro_torch.core import prng
from repro_torch.core.engine import lm as lm_mod
from repro_torch.core.engine.lm import (  # noqa: F401
    TreeSyncState, consensus_params, split_batch)
from repro_torch.launch.mesh import axis_size
from repro_torch.optim import Optimizer

_TP = ("tensor parallelism over the mesh's 'model' axis is not ported yet "
       "(ROADMAP A9.5: launch/sharding.py and models/shardctx.py); use a mesh "
       "whose 'model' axis has size 1, one rank per replica")


@dataclasses.dataclass(frozen=True)
class TreeSyncConfig:
    """sync_axes are bottom-up (fastest link first). periods[i] = number of
    level-(i-1) rounds per level-i sync (paper: H at each tree level);
    level i fires every prod(periods[:i+1]) local steps."""
    sync_axes: Tuple[str, ...] = ("data", "pod")
    periods: Tuple[int, ...] = (4, 16)
    compression: str = "none"     # outermost-level delta compression
    average_opt_state: bool = True

    def __post_init__(self):
        if len(set(self.sync_axes)) != len(self.sync_axes):
            raise ValueError(
                f"duplicate sync_axes {self.sync_axes}: each mesh axis is "
                "one tree level and can appear once")
        if not self.periods or any(
                not isinstance(p, int) or p <= 0 for p in self.periods):
            raise ValueError(
                f"periods must be positive ints, got {self.periods}")
        if len(self.periods) > len(self.sync_axes):
            raise ValueError(
                f"{len(self.periods)} periods for {len(self.sync_axes)} "
                "sync_axes: periods[i] schedules level i+1, one per axis")
        try:
            comp_mod.parse_spec(self.compression)
        except (KeyError, ValueError):
            raise ValueError(
                f"unknown compression {self.compression!r}; use one of "
                f"{sorted(comp_mod.COMPRESSORS)} or 'topk_<frac>'") from None

    def cum_periods(self) -> Tuple[int, ...]:
        out, p = [], 1
        for h in self.periods:
            p *= h
            out.append(p)
        return tuple(out)


def check_replica_mesh(mesh) -> None:
    """Refuse a mesh that would shard a replica over the ``model`` axis."""
    if axis_size(mesh, "model") > 1:
        raise NotImplementedError(_TP)


def _present_axes(ts: TreeSyncConfig, mesh) -> Tuple[str, ...]:
    return lm_mod.present_axes(mesh, ts.sync_axes)


def replica_count(ts: TreeSyncConfig, mesh) -> int:
    n = 1
    for a in _present_axes(ts, mesh):
        n *= axis_size(mesh, a)
    return n


def tp_rules():
    """The reference's param sharding inside one replica (TP over
    ``model``): not ported (see the module docstring)."""
    raise NotImplementedError(_TP)


def replica_specs(*args, **kwargs):
    """The reference's specs of an (R, ...)-stacked tree: not ported (each
    rank holds one replica; see the module docstring)."""
    raise NotImplementedError(_TP)


def init_state(cfg: ModelConfig, optimizer: Optimizer, key, mesh,
               ts: TreeSyncConfig, *, device="cuda") -> TreeSyncState:
    """This rank's replica of a fresh state on ``device``: ``key`` a PRNG
    key (``core/prng.py``, or a jax key's two words) or an int seed
    (``PRNGKey(seed)``), drawn as the reference's ``init_state`` draws."""
    check_replica_mesh(mesh)
    return lm_mod.init_lm_state(cfg, optimizer, prng.as_key(key),
                                compression=ts.compression, device=device)


def make_treesync_step(cfg: ModelConfig, optimizer: Optimizer,
                       ts: TreeSyncConfig, mesh) -> Callable:
    """DEPRECATED shim: returns ``step(state, batch) -> (state, metrics)``
    with the periods fixed.  Use ``Problem.lm(cfg, optimizer, ...)`` +
    ``Session.compile(backend="mesh")`` for the Session-driven program
    (runtime periods, straggler masks, checkpoint/resume).

    ``batch`` is this rank's rows of the global batch
    (``split_batch(batch, n, replica)``).  Building the step is a
    collective when the mesh has sync axes."""
    warnings.warn(
        "make_treesync_step is deprecated; use Problem.lm(...) + "
        "Session.compile(backend='mesh') (repro_torch.api) for the "
        "Session-driven LM program", DeprecationWarning, stacklevel=2)
    check_replica_mesh(mesh)
    axes = _present_axes(ts, mesh)
    level_sizes = tuple(axis_size(mesh, a) for a in reversed(axes))
    periods = list(ts.periods[: len(axes)])
    base = lm_mod.get_lm_executor(
        cfg, optimizer, level_sizes=level_sizes, compression=ts.compression,
        average_opt_state=ts.average_opt_state, mesh=mesh, axes=axes)

    def step(state, batch):
        return base(state, batch, periods)

    return step
