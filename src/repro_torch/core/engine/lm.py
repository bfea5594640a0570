"""LM TreeSync as a mesh-backend *Method* on the schedule IR (the JAX
package's ``core/engine/lm.py``), one ``torch.distributed`` rank per
replica.

The paper's tree schedule (H local iterations per level, nested per-level
rounds) is method-agnostic; this module supplies the LM-training side of
the Method protocol (see ``engine.method``): the local step is one
optimizer update on this rank's replica, and the per-level combine is a
(masked) mean over that level's sync group.

Where the reference keeps a leading replica dimension R = prod(sync-axis
sizes), sharded so that each device group holds one replica, each rank
here holds one replica's params, optimizer state and error-feedback
residual.  The replicas are numbered as the reference's replica dimension
(``P(tuple(reversed(axes)))``: outermost level slowest), and a rank's
replica is its leaf in ``engine.mesh.leaf_ranks``.  Digit l of the
replica index in the mixed radix of the bottom-up level sizes is its
position on level l, so

  * a level-l sync (``_mean_over_level``) is a mean over the ranks that
    differ from this one in digit l only;
  * a prefix sync (``_mean_over_prefix``, levels 0..l at once) over the
    ranks that differ in digits 0..l only;
  * a masked mean gives participants the mean of the participants in
    their group and leaves absentees their own value (``_masked_mean``).

Every mean gathers the group's rows in replica order and sums them on
each rank (``GroupComm.gather_rows`` of ``engine.mesh``): every member
computes the same bits, and the sum runs in the order the reference's
mean over the reshaped replica axis takes, whatever order a backend's
``all_reduce`` would pick.  Tensors are synced in flat chunks of
``SYNC_CHUNK`` elements (a multiple of the int8 codec's 32-element
blocks, so a chunked int8 round trip is the whole leaf's bit for bit),
which bounds the gather buffers at full width.

A replica may span the ranks of a ``model`` axis (tensor parallelism
inside it, :class:`ReplicaTP`): its state is split over them by the
reference's ``replica_specs`` rules (``replica_rules``: TP over ``model``,
no FSDP), its local step is ``make_train_step``'s under a shard context
over ``model`` alone, and all its ranks draw the same rows and share its
participation.  Every sync group then runs per ``model`` coordinate: a
level sync averages each rank's shards over the ranks that share its
coordinate (so no replica counts twice), the int8 root quantizes a shard
on its own only when its blocks are the whole leaf's (else the delta is
gathered over ``model`` and quantized whole, as top-k always is), and
``consensus_params`` and checkpoints gather the shards whole.

The step takes the per-level periods as a runtime operand: level l fires
when the step number is a multiple of ``cumprod(periods)[l]``.  Optional
runtime operands, each a separate executor variant: ``masked=True`` (a
per-replica (R,) participation mask, replicated on every rank) and
``with_lr=True`` (a learning rate overriding the optimizer's schedule).
``batched=True`` is a sweep's executor (:class:`BatchedLMStep`): B members
on each rank, one shared batch, the members stepped one after another.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.core import compression as comp_mod
from repro_torch.core.engine.mesh import GROUP_TIMEOUT, GroupComm, leaf_ranks
from repro_torch.launch import sharding as sh
from repro_torch.launch.mesh import axis_size, axis_slice
from repro_torch.launch.steps import grads_of, params_shape
from repro_torch.models import shardctx, transformer
from repro_torch.optim import Optimizer
from repro_torch.optim.api import tree_leaves, tree_unflatten

PyTree = Any
Tensor = torch.Tensor

# elements of one synced piece of a tensor (64 MiB of f32), a multiple of
# the int8 codec's BLOCK
SYNC_CHUNK = 1 << 24
assert SYNC_CHUNK % comp_mod.BLOCK == 0


# ---------------------------------------------------------------------------
# this rank's replica of the state
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class TreeSyncState:
    """One replica of the reference's replica-stacked state: ``params``
    (the reference's layout, blocks stacked), ``opt_state``, the host
    step count and, under a compressed root edge, the f32 error-feedback
    ``residual`` shaped like ``params``."""
    params: PyTree
    opt_state: PyTree
    step: int
    residual: Optional[PyTree] = None


def clone_tree(tree: PyTree) -> PyTree:
    if tree is None:
        return None
    return tree_unflatten(tree, [t.clone() if isinstance(t, Tensor) else t
                                 for t in tree_leaves(tree)])


def clone_state(state: TreeSyncState) -> TreeSyncState:
    return TreeSyncState(clone_tree(state.params), clone_tree(state.opt_state),
                         int(state.step), clone_tree(state.residual))


def init_lm_state(cfg: ModelConfig, optimizer: Optimizer, key,
                  compression: str = "none", *, device="cuda"
                  ) -> TreeSyncState:
    """A fresh replica on ``device``: parameters drawn from the threefry
    ``key`` as the reference's ``init_lm_state`` draws them (every rank
    draws the same ones), in the reference's stacked layout, and the
    optimizer's initial state."""
    params = transformer.stack_blocks(transformer.init_params(
        cfg, key, device=device))
    state = TreeSyncState(params=params, opt_state=optimizer.init(params),
                          step=0)
    if comp_mod.spec_name(*comp_mod.parse_spec(compression)) != "none":
        state.residual = comp_mod.get_compressor(compression).init_residual(
            params)
    return state


def init_replica_state(cfg: ModelConfig, optimizer: Optimizer, key,
                       compression: str = "none", *, device="cuda",
                       mesh=None) -> TreeSyncState:
    """:func:`init_lm_state`, cut to this rank's shards when ``mesh`` has a
    ``model`` axis larger than 1 (the optimizer state initialized whole,
    as its factoring follows the whole shapes; the residual made on the
    shards)."""
    if mesh is None or axis_size(mesh, "model") == 1:
        return init_lm_state(cfg, optimizer, key, compression,
                             device=device)
    state = cut_replica_state(cfg, mesh, init_lm_state(
        cfg, optimizer, key, device=device))
    if comp_mod.spec_name(*comp_mod.parse_spec(compression)) != "none":
        state.residual = comp_mod.get_compressor(compression).init_residual(
            state.params)
    return state


def replica_rows(batch: int, n_replicas: int, replica: int) -> slice:
    """The rows of a global batch that replica ``replica`` trains on (the
    reference's ``split_batch``: (B, ...) -> (R, B/R, ...))."""
    if batch % n_replicas:
        raise ValueError(f"batch {batch} does not split over {n_replicas} "
                         "replicas")
    b = batch // n_replicas
    return slice(replica * b, (replica + 1) * b)


def split_batch(batch: Dict[str, Tensor], n_replicas: int, replica: int
                ) -> Dict[str, Tensor]:
    """This replica's rows of a global batch."""
    rows = replica_rows(next(iter(batch.values())).shape[0], n_replicas,
                        replica)
    return {k: v[rows] for k, v in batch.items()}


# ---------------------------------------------------------------------------
# a replica over the ranks of a model axis
# ---------------------------------------------------------------------------
def replica_rules() -> sh.AxisRules:
    """The rules of one replica's state (the reference's ``tp_rules``): TP
    over ``model`` only, the ``data`` axis taken by the replica dim."""
    return dataclasses.replace(sh.DEFAULT_RULES, embed=None,
                               act_batch=("pod", "data"))


def _state_specs(cfg: ModelConfig, mesh, opt_state):
    """(param specs, optimizer-state specs) of one replica's whole state
    on ``mesh``; ``opt_state`` gives the state's whole shapes."""
    rules = replica_rules()
    pshape = params_shape(cfg)
    return (sh.param_specs(cfg, pshape, mesh, rules),
            sh.opt_state_specs(cfg, opt_state, pshape, mesh, rules))


def cut_replica_state(cfg: ModelConfig, mesh,
                      state: TreeSyncState) -> TreeSyncState:
    """This rank's shards of a whole replica state (new tensors; no
    collective): params and residual by the replica's parameter specs,
    the optimizer state by its specs."""
    pspecs, ospecs = _state_specs(cfg, mesh, state.opt_state)
    return TreeSyncState(
        sh.shard_tree(state.params, pspecs, mesh),
        sh.shard_tree(state.opt_state, ospecs, mesh), int(state.step),
        None if state.residual is None
        else sh.shard_tree(state.residual, pspecs, mesh))


def shard_layout(cfg: ModelConfig, mesh
                 ) -> Tuple[List[Optional[int]], List[bool]]:
    """Per parameter leaf (``tree_leaves`` order) of one replica on
    ``mesh``: the dim its spec splits over ``model`` (None: whole on every
    rank), and whether its shard's int8 blocks are the whole leaf's --
    every run of the shard along the flattened leaf a whole number of
    ``compression.BLOCK`` elements."""
    pshape = params_shape(cfg)
    m = axis_size(mesh, "model")
    split, aligned = [], []
    for (_, spec), t in zip(
            sh.flat_with_path(sh.param_specs(cfg, pshape, mesh,
                                             replica_rules())),
            tree_leaves(pshape), strict=True):
        dims = [d for d, e in enumerate(spec) if "model" in sh.entry_axes(e)]
        d = dims[0] if dims else None
        split.append(d)
        run = 0 if d is None else t.shape[d] // m * math.prod(
            t.shape[d + 1:])
        aligned.append(run % comp_mod.BLOCK == 0)
    return split, aligned


class ReplicaTP:
    """One replica split over the ranks of ``mesh``'s ``model`` axis: the
    shard context its local step runs in (building it is a collective of
    the whole world) and the specs that cut its state or gather it whole.
    Parameter leaves are numbered in ``tree_leaves`` order."""

    def __init__(self, cfg: ModelConfig, optimizer: Optimizer, mesh):
        self.cfg, self.mesh, self.rules = cfg, mesh, replica_rules()
        self.ctx = shardctx.context_for(mesh, self.rules, ("model",))
        self.model_rank = self.ctx.coords["model"]
        self.size = axis_size(mesh, "model")
        self.pspecs, self.ospecs = _state_specs(
            cfg, mesh, optimizer.init(params_shape(cfg)))
        self.split_dim, self.aligned = shard_layout(cfg, mesh)

    def scope(self):
        return shardctx.activation_sharding(self.mesh, self.rules,
                                            ("model",))

    def cut(self, state: TreeSyncState) -> TreeSyncState:
        return cut_replica_state(self.cfg, self.mesh, state)

    def _gather(self, tree, specs):
        def whole(_p, spec, t):
            if not isinstance(t, Tensor):
                return t
            for dim, entry in enumerate(spec):
                if "model" in sh.entry_axes(entry):
                    t = self.ctx.gather(t, dim, ("model",))
            return t
        return sh.map_with_path(whole, sh.for_layout(specs, tree), tree)

    def whole_params(self, params: PyTree) -> PyTree:
        """Parameters (or a tree shaped like them) gathered whole over
        ``model``, on every rank of it."""
        return self._gather(params, self.pspecs)

    def whole(self, state: TreeSyncState) -> TreeSyncState:
        return TreeSyncState(
            self.whole_params(state.params),
            self._gather(state.opt_state, self.ospecs), int(state.step),
            None if state.residual is None
            else self.whole_params(state.residual))

    def whole_leaf(self, i: int, t: Tensor) -> Tensor:
        d = self.split_dim[i]
        return t if d is None else self.ctx.gather(t, d, ("model",))

    def whole_shape(self, i: int, shape) -> Tuple[int, ...]:
        d = self.split_dim[i]
        return tuple(n * self.size if k == d else n
                     for k, n in enumerate(shape))

    def cut_leaf(self, i: int, t: Tensor) -> Tensor:
        d = self.split_dim[i]
        if d is None:
            return t
        c = t.shape[d] // self.size
        return t.narrow(d, self.model_rank * c, c)


_TPS: Dict[Tuple, ReplicaTP] = {}


def replica_tp(cfg: ModelConfig, optimizer: Optimizer, mesh
               ) -> Optional[ReplicaTP]:
    """The cached :class:`ReplicaTP` of ``(cfg, optimizer, mesh)``; None
    when the mesh's ``model`` axis is 1 (a replica is one rank)."""
    if mesh is None or axis_size(mesh, "model") == 1:
        return None
    key = (cfg, optimizer.name, optimizer.init, _mesh_key(mesh, ()))
    if key not in _TPS:
        _TPS[key] = ReplicaTP(cfg, optimizer, mesh)
    return _TPS[key]


# ---------------------------------------------------------------------------
# the sync groups of one mesh
# ---------------------------------------------------------------------------
def present_axes(mesh, sync_axes: Sequence[str]) -> Tuple[str, ...]:
    """Mesh axes actually present (size > 1), bottom-up (fastest first)."""
    names = tuple(mesh.mesh_dim_names or ())
    return tuple(a for a in sync_axes
                 if a in names and axis_size(mesh, a) > 1)


def level_sizes_for(mesh, sync_axes: Sequence[str]) -> Tuple[int, ...]:
    """Replica-dim factorization (s_{L-1}, ..., s_0): outermost level
    first, as the reference reshapes its (R, ...) replica dim."""
    return tuple(axis_size(mesh, a)
                 for a in reversed(present_axes(mesh, sync_axes)))


def _runs(sizes_up: Sequence[int], lo: int, hi: int) -> List[List[int]]:
    """The replica groups that vary digits lo..hi (bottom-up) of the mixed
    radix ``sizes_up`` and agree on the others, members ascending."""
    R = math.prod(sizes_up)
    stride = math.prod(sizes_up[:lo])
    span = math.prod(sizes_up[lo:hi + 1])
    groups: Dict[int, List[int]] = {}
    for r in range(R):
        inner = (r // stride) % span
        groups.setdefault(r - inner * stride, []).append(r)
    return list(groups.values())


class LMComm:
    """This rank's replica index and its sync groups: ``level[l]`` (digit
    l) and ``prefix[l]`` (digits 0..l), each a ``(GroupComm, members)``
    pair with the members' replica indices in order.  With a ``model``
    axis every group holds the ranks of one ``model`` coordinate (this
    rank's, ``model_rank``), and ``everyone`` is a group of every rank of
    the mesh.  Building one is a collective: every rank creates every
    group."""

    def __init__(self, mesh, axes: Sequence[str]):
        self.axes = tuple(axes)                       # bottom-up
        sizes_up = [axis_size(mesh, a) for a in self.axes]
        self.R = math.prod(sizes_up)
        m = axis_size(mesh, "model")
        # replica -> rank, per model coordinate
        per = [leaf_ranks(axis_slice(mesh, "model", c) if m > 1 else mesh,
                          self.axes) for c in range(m)]
        me = dist.get_rank()
        self.model_rank = next(c for c in range(m) if me in per[c])
        self.replica = per[self.model_rank].index(me)
        self.level, self.prefix = [], []
        for l in range(len(self.axes)):
            self.level.append(self._group(per, _runs(sizes_up, l, l)))
            self.prefix.append(self._group(per, _runs(sizes_up, 0, l)))
        if m == 1:
            self.everyone = self.prefix[-1][0]
        else:
            every = sorted(r for ranks in per for r in ranks)
            group, _ = dist.new_subgroups_by_enumeration(
                [every], timeout=GROUP_TIMEOUT)
            self.everyone = GroupComm(group, every)

    def _group(self, per, runs):
        group, _ = dist.new_subgroups_by_enumeration(
            [[ranks[r] for r in run] for ranks in per for run in runs],
            timeout=GROUP_TIMEOUT)
        mine = next(run for run in runs if self.replica in run)
        ranks = per[self.model_rank]
        return GroupComm(group, [ranks[r] for r in mine]), mine

    @property
    def world(self):
        """The group of every replica (the prefix of all levels)."""
        return self.prefix[-1]


_COMMS: Dict[Tuple, LMComm] = {}


def _mesh_key(mesh, axes) -> Tuple:
    return (tuple(mesh.mesh_dim_names or ()), tuple(mesh.shape),
            tuple(int(r) for r in mesh.mesh.reshape(-1).tolist()),
            tuple(axes))


def get_comm(mesh, axes: Sequence[str]) -> Optional[LMComm]:
    """The cached :class:`LMComm` of ``mesh`` over ``axes`` (None when no
    axis is present: one replica, no collectives)."""
    if not axes:
        return None
    key = _mesh_key(mesh, axes)
    if key not in _COMMS:
        _COMMS[key] = LMComm(mesh, axes)
    return _COMMS[key]


def _group_mean(group, x: Tensor, mask: Optional[np.ndarray],
                own: bool) -> Tensor:
    """The f32 mean of ``x`` (flat) over ``group``'s members, rows summed
    in replica order; masked: over the participants, or ``x`` itself for
    an absentee (``own`` False) -- the reference's ``_masked_mean``."""
    comm, members = group
    rows = comm.gather_rows(x.float()[None])
    if mask is None:
        return torch.sum(rows, dim=0) / comm.size
    mb = torch.as_tensor(mask[members], dtype=torch.float32,
                         device=x.device)
    num = torch.sum(rows * mb[:, None], dim=0)
    mean = num / torch.clamp(torch.sum(mb), min=1.0)
    return mean if own else x.float()


def _syncable(t) -> bool:
    return (isinstance(t, Tensor) and t.dim() > 0
            and t.is_floating_point())


def _pieces(t: Tensor):
    flat = t.view(-1)
    for s in range(0, flat.numel(), SYNC_CHUNK):
        yield flat[s:s + SYNC_CHUNK]


@torch.no_grad()
def mean_tree(tree: PyTree, group, mask: Optional[np.ndarray] = None,
              own: bool = True) -> None:
    """Replace every float leaf of ``tree`` (scalars and integer leaves
    excepted: step counters are the same on every replica) by its mean
    over ``group``, in place."""
    for t in tree_leaves(tree):
        if not _syncable(t):
            continue
        for piece in _pieces(t):
            piece.copy_(_group_mean(group, piece, mask, own).to(t.dtype))


def _fits(compressor) -> bool:
    """Whether the codec works block by block (so a flat piece of a leaf
    compresses as its part of the whole): int8 and none, not top-k."""
    return compressor.name in ("int8", "none")


@torch.no_grad()
def compressed_outer_sync(params: PyTree, residual: PyTree, comm: LMComm,
                          compressor, mask: Optional[np.ndarray],
                          tp: Optional[ReplicaTP] = None) -> None:
    """Cross-outermost-level averaging of compressed deltas with error
    feedback, in place.  The anchor is the inner-level mean (identical
    within each outer group after the inner syncs); each rank compresses
    its own delta from that anchor plus its residual, the outer group
    averages the decompressed deltas and the anchors.  Masked: absentees
    keep their params and residual exactly.  Under ``tp`` a split leaf
    whose shard is not a run of the whole leaf's int8 blocks (and every
    split leaf under top-k, which selects over the replica's whole leaf)
    has its delta and residual gathered over ``model`` and compressed
    whole; the residual stays this rank's shard."""
    L = len(comm.level)
    own = mask is None or bool(mask[comm.replica] > 0)
    outer = comm.level[L - 1]
    for i, (p, r) in enumerate(zip(tree_leaves(params), tree_leaves(residual),
                                   strict=True)):
        whole = tp is not None and tp.split_dim[i] is not None and not (
            _fits(compressor) and tp.aligned[i])
        pieces = (zip(_pieces(p), _pieces(r), strict=True)
                  if _fits(compressor) and not whole
                  else [(p.view(-1), r.view(-1))])
        for pp, rr in pieces:
            x = pp.float()
            inner = (_group_mean(comm.prefix[L - 2], x, mask, own)
                     if L > 1 else x)
            if whole:
                shape = tuple(p.shape)
                wire, new_r = compressor.compress(
                    [tp.whole_leaf(i, (x - inner).view(shape)).reshape(-1)],
                    [tp.whole_leaf(i, rr.view(shape)).reshape(-1)])
                full = tp.whole_shape(i, shape)
                deq = tp.cut_leaf(i, compressor.decompress(wire)[0]
                                  .view(full))
                new_r = [tp.cut_leaf(i, new_r[0].view(full))]
            else:
                wire, new_r = compressor.compress([x - inner], [rr])
                deq = compressor.decompress(wire)[0]
            both = torch.stack([deq.reshape(-1), inner.reshape(-1)])
            avg = _group_mean(outer, both.reshape(-1), mask, own)
            avg = avg.reshape(2, -1)
            new_p = (avg[1] + avg[0]).to(p.dtype)
            if own:
                pp.copy_(new_p)
                rr.copy_(new_r[0].reshape(rr.shape))


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------
class LMStep:
    """One replica's LM train step with the tree syncs:
    ``step(state, batch, periods[, participation][, lr]) -> (state,
    metrics)``, the reference's signature with ``batch`` this rank's rows
    and ``participation`` the (R,) mask on every rank.  The state is
    updated in place (the reference's executor donates it) and returned;
    ``metrics`` are the replicas' mean ``loss``, ``moe_aux`` and
    ``tokens`` as 0-d f32 tensors.  Under ``tp`` the state is this rank's
    shards of its replica and the local step runs in the replica's shard
    context."""

    def __init__(self, cfg: ModelConfig, optimizer: Optimizer, *,
                 comm: Optional[LMComm], compression: str = "none",
                 average_opt_state: bool = True, masked: bool = False,
                 with_lr: bool = False, tp: Optional[ReplicaTP] = None):
        self.cfg, self.optimizer, self.comm = cfg, optimizer, comm
        self.tp = tp
        self.L = 0 if comm is None else len(comm.level)
        self.masked, self.with_lr = masked, with_lr
        self.average_opt_state = average_opt_state
        self.use_comp = comp_mod.spec_name(
            *comp_mod.parse_spec(compression)) != "none"
        self.compressor = (comp_mod.get_compressor(compression)
                           if self.use_comp else None)
        # seconds spent in each level's syncs (host clock, after a device
        # synchronize), and how many ran
        self.reset_timers()

    def reset_timers(self) -> None:
        self.sync_seconds = [0.0] * self.L
        self.sync_count = [0] * self.L

    def local_step(self, state: TreeSyncState, batch, lr):
        kw = {"lr": lr} if self.with_lr else {}
        if self.tp is None:
            grads, metrics = grads_of(self.cfg, state.params, batch)
        else:
            with self.tp.scope():
                grads, metrics = grads_of(self.cfg, state.params, batch)
                kw["shards"] = shardctx.leaf_shards(self.cfg, state.params)
        _, state.opt_state = self.optimizer.update(
            state.params, grads, state.opt_state, inplace=True, **kw)
        return metrics

    def sync_level(self, state: TreeSyncState, level: int, mask) -> None:
        own = mask is None or bool(mask[self.comm.replica] > 0)
        group = self.comm.level[level]
        mean_tree(state.params, group, mask, own)
        if self.average_opt_state:
            mean_tree(state.opt_state, group, mask, own)

    def __call__(self, state: TreeSyncState, batch, periods,
                 participation=None, lr=None):
        metrics = self.local_step(state, batch, lr)
        step_no = int(state.step) + 1
        cum = np.cumprod(np.asarray(periods, np.int64)[: self.L])
        mask = (None if not self.masked else
                np.asarray(participation.cpu() if isinstance(  # analysis: allow(host-sync-in-tick) the straggler mask is a host decision, read once a step
                    participation, Tensor) else participation, np.float32))
        for level in range(self.L):
            if step_no % int(cum[level]):
                continue
            dev = tree_leaves(state.params)[0].device
            # a sync's seconds on the host clock around synchronized work
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)  # analysis: allow(host-sync-in-tick) the sync timer's start, a step's syncs only
            t0 = time.perf_counter()  # analysis: allow(wall-clock-in-trace) eager host timer around the sync
            if level == self.L - 1 and self.use_comp:
                compressed_outer_sync(state.params, state.residual,
                                      self.comm, self.compressor, mask,
                                      self.tp)
            else:
                self.sync_level(state, level, mask)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)  # analysis: allow(host-sync-in-tick) the sync timer's end
            self.sync_seconds[level] += time.perf_counter() - t0  # analysis: allow(wall-clock-in-trace) eager host timer around the sync
            self.sync_count[level] += 1
        state.step = step_no
        return state, self.replica_mean(metrics)

    def replica_mean(self, metrics: Dict[str, Tensor]) -> Dict[str, Tensor]:
        """The mean of each metric over the replicas (the reference's mean
        over its replica axis), on every rank."""
        if self.comm is None:
            return metrics
        names = sorted(metrics)
        vec = torch.stack([metrics[k].float().reshape(()) for k in names])
        mean = _group_mean(self.comm.world, vec, None, True)
        return {k: mean[i] for i, k in enumerate(names)}


class BatchedLMStep(LMStep):
    """B members of a sweep on this rank: ``step(states, batch, periods[,
    participation][, lr]) -> (states, metrics)`` with ``states`` a list of
    B :class:`TreeSyncState` (updated in place), ``periods`` one row of
    per-level periods per member, ``lr`` one learning rate per member (a
    (B,) sequence of floats; ``with_lr`` executors) and ``metrics`` the
    members' replica means as (B,) tensors.

    The batch is one draw shared by every member (the data stream belongs
    to the problem).  The members then step one after another, each
    through :meth:`LMStep.__call__` -- the same ``grads_of``, optimizer
    update and level syncs, in the same order, as a standalone step -- so
    each member equals its standalone run bit for bit, and gradients exist
    for one member at a time.  A fused forward over the members would
    need batched products whose sums differ from a standalone run's, and
    the scan is a small share of a step."""

    def __call__(self, states: List[TreeSyncState], batch, periods,
                 participation=None, lr=None):
        if len(periods) != len(states) or (lr is not None
                                           and len(lr) != len(states)):
            raise ValueError(f"{len(states)} members need as many period "
                             f"rows and learning rates")
        metrics = []
        for b, state in enumerate(states):
            _, m = LMStep.__call__(self, state, batch, periods[b],
                                   participation,
                                   None if lr is None else lr[b])
            metrics.append(m)
        return states, {k: torch.stack([m[k] for m in metrics])
                        for k in metrics[0]}


@torch.no_grad()
def consensus_params(state: TreeSyncState, comm: Optional[LMComm] = None,
                     tp: Optional[ReplicaTP] = None) -> PyTree:
    """The fully-averaged model (what you checkpoint / serve): the f32
    mean of every parameter over all replicas, whole (gathered over
    ``model`` under ``tp``), on every rank."""
    out = []
    for t in tree_leaves(state.params):
        v = t.float().clone()
        if comm is not None:
            for piece in _pieces(v):
                piece.copy_(_group_mean(comm.world, piece, None, True))
        out.append(v)
    out = tree_unflatten(state.params, out)
    return out if tp is None else tp.whole_params(out)


# ---------------------------------------------------------------------------
# cached executors
# ---------------------------------------------------------------------------
LM_KEY_FIELDS = ("cfg", "optimizer", "init", "update", "level_sizes",
                 "compression", "average_opt_state", "masked", "with_lr",
                 "batched", "mesh")
_EXECUTOR_CACHE: Dict[Tuple, Callable] = {}
_CACHE_STATS = {"hits": 0, "misses": 0}
_MISS_LOG: List[dict] = []
_MISS_LOG_MAX = 64


def _named(key) -> dict:
    return {f: (v if isinstance(v, (int, float, str, bool, tuple))
                or v is None else repr(v))
            for f, v in zip(LM_KEY_FIELDS, key, strict=True)}


def get_lm_executor(cfg: ModelConfig, optimizer: Optimizer, *,
                    level_sizes: Tuple[int, ...], compression: str = "none",
                    average_opt_state: bool = True, masked: bool = False,
                    with_lr: bool = False, batched: bool = False,
                    mesh=None, axes: Sequence[str] = ()) -> LMStep:
    """Memoized :class:`LMStep` for one (config, variant, mesh).  Building
    one may build the mesh's sync groups and, on a ``model`` axis, the
    replica's shard context: collectives.  ``batched=True``
    gives the sweep's :class:`BatchedLMStep` (B members on each rank; B is
    the length of the states it is called with, so one executor serves
    every grid)."""
    axes = tuple(axes)
    tp = replica_tp(cfg, optimizer, mesh)
    mkey = None if mesh is None or not (axes or tp) else _mesh_key(mesh, axes)
    key = (cfg, optimizer.name, optimizer.init, optimizer.update,
           tuple(level_sizes), compression, average_opt_state, masked,
           with_lr, batched, mkey)
    hit = key in _EXECUTOR_CACHE
    _CACHE_STATS["hits" if hit else "misses"] += 1
    if hit:
        return _EXECUTOR_CACHE[key]
    _MISS_LOG.append({"backend": "lm", "key": _named(key)})
    del _MISS_LOG[:-_MISS_LOG_MAX]
    comm = get_comm(mesh, axes) if mesh is not None else None
    if comm is not None and tuple(level_sizes) != tuple(
            reversed([c.size for c, _ in comm.level])):
        raise ValueError(f"level_sizes {tuple(level_sizes)} do not match "
                         f"the mesh's {axes}")
    fn = (BatchedLMStep if batched else LMStep)(
        cfg, optimizer, comm=comm, compression=compression,
        average_opt_state=average_opt_state, masked=masked, with_lr=with_lr,
        tp=tp)
    _EXECUTOR_CACHE[key] = fn
    return fn


def lm_executor_cache_stats() -> Dict[str, int]:
    return dict(_CACHE_STATS, size=len(_EXECUTOR_CACHE))


def lm_executor_cache_keys() -> List[dict]:
    """Current LM-cache keys as named dicts (see ``LM_KEY_FIELDS``)."""
    return [_named(k) for k in _EXECUTOR_CACHE]


def lm_executor_miss_log() -> List[dict]:
    """The newest cache misses, ``{"backend": "lm", "key": {...}}``."""
    return list(_MISS_LOG)


def clear_lm_executor_cache() -> None:
    _EXECUTOR_CACHE.clear()
    _CACHE_STATS.update(hits=0, misses=0)
