"""TreeSync: the paper's tree-structured synchronization schedule for
data-parallel LM training (the JAX package's ``core/treesync.py``).

  level 0  local optimizer steps on every replica   (H_0 = period between
           level-1 syncs)
  level 1  average replicas over the "data" axis    (the fast link)
  level 2  average over the "pod" axis              (the slow link),
           optionally int8-compressed with error feedback

Here each replica is one ``torch.distributed`` rank, or the ranks of the
mesh's ``model`` axis (``core/engine/lm.py``): a level-l sync is a mean
over the ranks of that level's sync group.
periods=(1, 1) makes every step fully synchronous: with SGD this is
standard data parallelism, the paper's star-network special case.

This module keeps the reference's legacy static-periods surface as thin
shims: ``make_treesync_step`` is deprecated in favor of ``Problem.lm(...)``
+ ``Session.compile(backend="mesh")`` (``api/lm.py``).  The reference's
specs of a replica's state, ``tp_rules`` / ``replica_specs`` (TP over
``model`` inside each replica), are here as spec functions equal to the
reference's.  The reference's LM engine never places its state by them;
the port's does on a ``model`` axis larger than 1: each rank holds its
shards of its replica (``engine.lm.ReplicaTP``).
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
from repro_torch.launch import sharding as sh
from repro_torch.launch.mesh import axis_size
from repro_torch.optim import Optimizer


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


def _present_axes(ts: TreeSyncConfig, mesh) -> Tuple[str, ...]:
    return lm_mod.present_axes(mesh, ts.sync_axes)


def replica_count(ts: TreeSyncConfig, mesh) -> int:
    n = 1
    for a in _present_axes(ts, mesh):
        n *= axis_size(mesh, a)
    return n


def tp_rules() -> sh.AxisRules:
    """Param sharding inside one replica: TP over "model" only (the "data"
    axis is occupied by the replica dim, so no FSDP)."""
    return lm_mod.replica_rules()


def replica_specs(cfg: ModelConfig, tree_shape, mesh, ts: TreeSyncConfig,
                  base_rules=None):
    """Specs for an (R, ...)-stacked tree: replica dim over the sync axes
    (outermost level first, matching reshape order), rest per tp_rules."""
    rules = base_rules or tp_rules()
    base = sh.param_specs(cfg, tree_shape, mesh, rules)
    rep_axes = tuple(reversed(_present_axes(ts, mesh)))  # (pod, data)
    rep = rep_axes if len(rep_axes) > 1 else \
        (rep_axes[0] if rep_axes else None)
    return sh.map_with_path(lambda _p, spec: sh.P(rep, *spec), base)


def init_state(cfg: ModelConfig, optimizer: Optimizer, key, mesh,
               ts: TreeSyncConfig, *, device="cuda") -> TreeSyncState:
    """This rank's replica of a fresh state on ``device`` (its shards of
    it on a ``model`` axis): ``key`` a PRNG key (``core/prng.py``, or a
    jax key's two words) or an int seed (``PRNGKey(seed)``), drawn as the
    reference's ``init_state`` draws."""
    return lm_mod.init_replica_state(cfg, optimizer, prng.as_key(key),
                                     compression=ts.compression,
                                     device=device, mesh=mesh)


def make_treesync_step(cfg: ModelConfig, optimizer: Optimizer,
                       ts: TreeSyncConfig, mesh) -> Callable:
    """DEPRECATED shim: returns ``step(state, batch) -> (state, metrics)``
    with the periods fixed.  Use ``Problem.lm(cfg, optimizer, ...)`` +
    ``Session.compile(backend="mesh")`` for the Session-driven program
    (runtime periods, straggler masks, checkpoint/resume).

    ``batch`` is this rank's rows of the global batch
    (``split_batch(batch, n, replica)``; every rank of a replica takes
    its rows).  Building the step is a collective when the mesh has sync
    axes or a ``model`` axis."""
    warnings.warn(
        "make_treesync_step is deprecated; use Problem.lm(...) + "
        "Session.compile(backend='mesh') (repro_torch.api) for the "
        "Session-driven LM program", DeprecationWarning, stacklevel=2)
    axes = _present_axes(ts, mesh)
    level_sizes = tuple(axis_size(mesh, a) for a in reversed(axes))
    periods = list(ts.periods[: len(axes)])
    base = lm_mod.get_lm_executor(
        cfg, optimizer, level_sizes=level_sizes, compression=ts.compression,
        average_opt_state=ts.average_opt_state, mesh=mesh, axes=axes)

    def step(state, batch):
        return base(state, batch, periods)

    return step
