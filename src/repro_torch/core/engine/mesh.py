"""Mesh backend: run a level-homogeneous :class:`TreePlan` as a
``torch.distributed`` program, one rank per leaf, with the ``sdca_block``
kernel on every rank.

The tree maps onto the ranks as the JAX package maps it onto devices.  A
``DeviceMesh`` names one axis per internal depth; ``axes`` lists them
innermost (leaf level) first, so depth d is axis ``axes[L-1-d]``.  The
leaf index runs over the axes top-down (the reference's ``P(tuple(
reversed(axes)))``), and a depth-d sync group is the set of ranks that
share coordinates on the axes above depth d: it spans depth d's axis and
every deeper one.  Each depth's groups are built once per executor
(``dist.new_subgroups_by_enumeration``) and every sync is collectives
over one such group.

The program is the host executor's tick loop (``core/engine/host.py``)
on one leaf's state: each rank carries its leaf's blocked alpha, its w
replica, the per-depth snapshots and servers, its error-feedback
residuals and momentum anchors (:class:`MeshExecutor` is a
``HostExecutor`` whose ``rows`` are this rank's leaf).  Each solve tick
is one ``sdca_block`` launch over the rank's block (K = 1; B x 1 for a
batched executor); the participation gates are computed on every rank
from the replicated (S, n) mask, exactly as the host computes them.
``init`` takes the global (alpha, w), ``step`` the global key plan and
masks, and ``finalize`` returns the global (alpha (m,), w (d,)) on every
rank (one all-gather over the root group).

Sync lowerings (``sync=``):

* ``"psum"``: replicated server state.  A sync all-gathers the group's
  weighted w-deltas in leaf order and sums them as the host executor
  does (one ``(1, G, d)`` reduction), so the result is the host
  backend's bit for bit: an ``all_reduce`` would sum in whatever order
  the backend picks.
* ``"reduce_scatter"``: the per-depth server state lives sharded over the
  depth's group (each rank owns a ``ceil(d / G_d)`` chunk, placed where
  the collectives put it: chunk i on group rank i).  A sync all-gathers
  the snapshot from the shards, reduce-scatters the weighted delta into
  the shard and all-gathers the new w; deeper shards are slices of it.
  Needs full participation (the mask is not read), and equals ``"psum"``
  up to the reassociation of the sum.

Collective forms, chosen once by the process group's backend name
(:data:`COLLECTIVE_FORMS`): on ``"nccl"`` (one rank per card) the native
``all_gather_into_tensor`` / ``reduce_scatter_tensor`` / ``all_reduce``;
on ``"gloo"``, which reduces CUDA tensors only through ``all_reduce``,
every collective is an ``all_reduce``: an all-gather sums a zero-filled
(G, ...) buffer in which each rank wrote its own row (x + 0 is exact), a
reduce-scatter sums the full vector and keeps this rank's chunk.

Executors are memoized on ``MESH_KEY_FIELDS`` (the reference's fields,
plus the device the buffers live on).  Building one is a collective
(group creation and a check that every rank built the same plan and
flags), so every rank must make the same calls in the same order.
"""
from __future__ import annotations

import hashlib
import math
from collections import OrderedDict
from datetime import timedelta
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import compression as comp_mod
from repro_torch.core import prng
from repro_torch.core.dual import Loss
from repro_torch.core.engine.host import (BlockedData, ExecState,
                                          HostExecutor, regularizer_scale)
from repro_torch.core.engine.plan import (TreePlan, balanced_tree,
                                          full_participation, full_steps,
                                          key_plan)
from repro_torch.core.tree import TreeNode
from repro_torch.launch.mesh import axis_size

Tensor = torch.Tensor

_MESH_EXEC_CACHE: OrderedDict = OrderedDict()
_MESH_EXEC_CACHE_MAX = 16
MESH_KEY_FIELDS = ("plan_fingerprint", "loss", "gamma", "axes", "mesh",
                   "use_kernel", "carry_state", "sync", "batched",
                   "accelerated", "device")
_MESH_CACHE_STATS = {"hits": 0, "misses": 0}
_MISS_LOG: list = []
_MISS_LOG_MAX = 64

SYNC_MODES = ("psum", "reduce_scatter")
# how each backend runs the three collectives (see the module docstring)
COLLECTIVE_FORMS = {"gloo": "all_reduce", "nccl": "native"}
# the longest a rank waits in one collective of an executor's groups
GROUP_TIMEOUT = timedelta(seconds=60)


def mesh_executor_cache_stats() -> dict:
    """Mesh executor-cache counters: {hits, misses, size}."""
    return dict(_MESH_CACHE_STATS, size=len(_MESH_EXEC_CACHE))


def _named_key(key) -> dict:
    return {f: (v if isinstance(v, (int, float, str, bool, tuple))
                or v is None else repr(v))
            for f, v in zip(MESH_KEY_FIELDS, key, strict=True)}


def mesh_executor_cache_keys() -> list:
    """Current mesh-cache keys as named dicts (see ``MESH_KEY_FIELDS``)."""
    return [_named_key(k) for k in _MESH_EXEC_CACHE]


def _check_plan_mesh(plan: TreePlan, mesh, axes: Sequence[str]):
    """The reference's plan checks, with its messages, as ValueErrors."""
    if plan.levels is None:
        raise ValueError(
            "the mesh backend needs a level-homogeneous plan (balanced "
            "tree, uniform per-depth rounds); use the host backend "
            "otherwise")
    if plan.weighting != "uniform":
        raise ValueError(
            "mesh lowering uses per-level psum/K averaging (uniform "
            "weights)")
    L = len(axes)
    if plan.depth != L:
        raise ValueError(str((plan.depth, L)))
    sizes = [axis_size(mesh, a) for a in axes]
    for d in range(L):
        if plan.levels[d].group_size != sizes[L - 1 - d]:
            raise ValueError(
                f"depth {d} fan-out {plan.levels[d].group_size} != mesh "
                f"axis {axes[L - 1 - d]} size {sizes[L - 1 - d]}")
    if int(plan.leaf_sizes.min()) != plan.m_b:
        raise ValueError("mesh backend needs equal blocks")


def _comp_specs(plan: TreePlan):
    """The per-depth (kind, frac) compression spec of a mesh-lowerable
    plan; raises when a depth mixes specs across edges (one collective
    per depth, so the spec must be level-uniform)."""
    specs = []
    for dd in range(plan.depth):
        pairs = {(int(k), float(f)) for k, f in
                 zip(plan.compress_kind[dd], plan.compress_frac[dd],
                     strict=True)}
        if len(pairs) != 1:
            raise ValueError(
                f"mesh backend needs ONE compression spec per depth; depth "
                f"{dd} mixes "
                f"{sorted(comp_mod.spec_name(*p) for p in pairs)}")
        specs.append(next(iter(pairs)))
    return specs


def mesh_state_floats(plan: TreePlan, d_feat: int, *,
                      sync: str = "psum") -> int:
    """Per-rank PERSISTENT carry floats of the mesh program (blocked
    alpha, the w replica, per-depth snapshots / servers, error-feedback
    residuals), the reference's count.  The ``reduce_scatter`` lowering
    keeps per-depth server state sharded over the depth's group."""
    if sync not in SYNC_MODES:
        raise ValueError(f"sync must be one of {SYNC_MODES}, got {sync!r}")
    L, m_b = plan.depth, plan.m_b
    ks = [plan.levels[d].group_size for d in range(L)]
    specs = _comp_specs(plan)
    n_res = sum(1 for k, _ in specs if k != comp_mod.KIND_NONE)
    base = m_b + d_feat + L * m_b + n_res * d_feat
    if sync == "psum":
        return base + 2 * L * d_feat          # snapW + srvW, replicated
    shard = sum(-(-d_feat // math.prod(ks[d:])) for d in range(L))
    return base + shard                       # sharded server (snap == srv)


# ---------------------------------------------------------------------------
# the rank layout and the collectives of one group
# ---------------------------------------------------------------------------
def leaf_ranks(mesh, axes: Sequence[str]) -> List[int]:
    """The global rank of every leaf, in leaf order: the mesh's rank
    array with its axes ordered top-down (``reversed(axes)``), flattened.
    Every other axis of the mesh must have size 1 (one rank per leaf)."""
    names = tuple(mesh.mesh_dim_names or ())
    missing = [a for a in axes if a not in names]
    if missing:
        raise ValueError(f"mesh axes {missing} are not dimensions of the "
                         f"mesh {names}")
    top_down = [names.index(a) for a in reversed(axes)]
    rest = [i for i in range(len(names)) if i not in top_down]
    if any(mesh.shape[i] != 1 for i in rest):
        raise ValueError(
            f"the mesh backend runs one rank per leaf: mesh dimensions "
            f"{[names[i] for i in rest]} outside axes {tuple(axes)} must "
            f"have size 1")
    return [int(r) for r in
            mesh.mesh.permute(top_down + rest).reshape(-1).tolist()]


class GroupComm:
    """The collectives of one sync group (``ranks`` its members in leaf
    order), in the form :data:`COLLECTIVE_FORMS` gives the group's
    backend.  Gathers collect by group rank (new groups number their
    members in ascending global rank); row gathers then reorder to leaf
    order, while chunks stay on group ranks (chunk i on group rank i), as
    reduce-scatter places them."""

    def __init__(self, group, ranks: Sequence[int]):
        backend = str(dist.get_backend(group))
        if backend not in COLLECTIVE_FORMS:
            raise ValueError(
                f"the mesh backend runs on {sorted(COLLECTIVE_FORMS)} "
                f"process groups, got {backend!r}")
        self.group, self.size = group, len(ranks)
        self.native = COLLECTIVE_FORMS[backend] == "native"
        # gloo reduces CPU tensors for any op; nccl only card tensors
        self.check_device = "cuda" if backend == "nccl" else "cpu"
        self.grank = dist.get_group_rank(group, dist.get_rank())
        # the group rank of each leaf position (None: the same order)
        order = [dist.get_group_rank(group, r) for r in ranks]
        self.order = None if order == list(range(self.size)) else \
            torch.as_tensor(order)

    def _gather(self, x: Tensor) -> Tensor:
        """(1, k) on every member -> (G, k), rows by group rank."""
        out = torch.zeros((self.size,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        if self.native:
            dist.all_gather_into_tensor(out, x.contiguous(),
                                        group=self.group)
        else:
            out[self.grank] = x[0]
            dist.all_reduce(out, group=self.group)
        return out

    def gather_rows(self, x: Tensor) -> Tensor:
        """(1, k) on every member -> (G, k), rows in leaf order."""
        out = self._gather(x)
        return out if self.order is None else out[self.order.to(out.device)]

    def gather_chunks(self, sh: Tensor) -> Tensor:
        """(1, p) chunk on every member -> (1, G p), chunks by group rank."""
        return self._gather(sh).reshape(1, -1)

    def reduce_scatter(self, x: Tensor) -> Tensor:
        """(1, G p) on every member -> this rank's (1, p) chunk of the
        group's sum."""
        p = x.shape[-1] // self.size
        if self.native:
            out = torch.empty((p,), dtype=x.dtype, device=x.device)
            dist.reduce_scatter_tensor(out, x.reshape(-1).contiguous(),
                                       group=self.group)
            return out[None]
        buf = x.clone()
        dist.all_reduce(buf, group=self.group)
        return buf[:, self.grank * p:(self.grank + 1) * p]

    def all_reduce(self, x: Tensor) -> Tensor:
        """The group's elementwise sum, on every member (a new tensor)."""
        buf = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(buf, group=self.group)
        return buf

    def chunk(self, x: Tensor, p: int) -> Tensor:
        """This rank's (1, p) chunk of a group-uniform (1, d) vector,
        zero-padded to G p (no collective)."""
        pad = self.size * p - x.shape[-1]
        xp = torch.nn.functional.pad(x, (0, pad)) if pad else x
        return xp[:, self.grank * p:(self.grank + 1) * p]

    def all_max(self, x: Tensor) -> Tensor:
        """The elementwise max over the group (a small check tensor)."""
        buf = x.to(self.check_device).clone()
        dist.all_reduce(buf, op=dist.ReduceOp.MAX, group=self.group)
        return buf.cpu()


def _build_groups(ranks: List[int], sizes: List[int], timeout
                  ) -> List[GroupComm]:
    """One :class:`GroupComm` per depth: depth d's groups are runs of
    ``sizes[d]`` consecutive leaves.  Every rank creates every group."""
    comms = []
    for g_size in sizes:
        runs = [ranks[i:i + g_size] for i in range(0, len(ranks), g_size)]
        group, _ = dist.new_subgroups_by_enumeration(runs, timeout=timeout)
        mine = next(r for r in runs if dist.get_rank() in r)
        comms.append(GroupComm(group, mine))
    return comms


# ---------------------------------------------------------------------------
# the executor
# ---------------------------------------------------------------------------
class MeshExecutor(HostExecutor):
    """One rank's share of a plan: the host executor's tick loop on this
    rank's leaf (``rows``), with each depth's group sum a collective.

    The interface is the host executor's, on global operands: ``prepare
    (X, y)`` keeps this rank's block, ``init(X, alpha0, w0)``, ``step(
    data, keys (S, n, 2), state, participation (S, n), steps (S, n,
    h_max), lm[, acceleration])`` and ``finalize(state) -> (alpha (m,),
    w (d,))`` on every rank (leaf 0's w, as the host returns); a batched
    executor puts a leading config axis on them as the host's does."""

    def __init__(self, plan: TreePlan, comms: List[GroupComm], leaf: int, *,
                 loss: Loss, use_kernel: bool, sync: str, device,
                 batched: bool = False, accelerated: bool = False):
        super().__init__(plan, loss=loss,
                         backend="cuda" if use_kernel else "torch",
                         device=device, batched=batched,
                         accelerated=accelerated,
                         rows=slice(leaf, leaf + 1))
        self.leaf, self.sync, self.comms = leaf, sync, comms
        self.world = comms[0]                     # the root group: all
        self.group_sizes = [c.size for c in comms]

    @property
    def writer(self) -> bool:
        """Whether this rank writes what the run saves (the first leaf)."""
        return self.leaf == 0

    def barrier(self) -> None:
        """Wait for every rank of the mesh."""
        self.world.all_max(torch.zeros(1))

    # ---- data and state ----------------------------------------------
    def prepare(self, X: Tensor, y: Tensor):
        """This rank's block of the global (m, d) / (m,) data: views of
        its rows, and their norms."""
        n, m_b = self.plan.n_leaves, self.plan.m_b
        R = self.rows
        Xb = X.contiguous().view(n, m_b, X.shape[1])[R]
        yb = y.contiguous().view(n, m_b)[R]
        return BlockedData(Xb, yb, torch.sum(Xb * Xb, dim=-1))

    def _pads(self, d: int) -> List[int]:
        """The per-depth chunk length ``ceil(d / G_d)``."""
        return [-(-d // g) for g in self.group_sizes]

    def _init_one(self, X: Tensor, alpha0: Tensor, w0: Tensor) -> ExecState:
        n, m_b, D = self.plan.n_leaves, self.plan.m_b, self.plan.depth
        d = X.shape[-1]
        a = alpha0.to(X.dtype).reshape(n, m_b)[self.rows].clone()
        w = w0.to(X.dtype).reshape(1, d).clone()
        res = tuple(torch.zeros((1, d), dtype=torch.float32,
                                device=w.device) for _ in self.res_slot)
        if self.sync == "psum":
            anchors = ((w,) * D, (a,) * D) if self.accelerated else ((), ())
            return ExecState(a, w, (a,) * D, (w,) * D, (w,) * D, res,
                             *anchors)
        # reduce_scatter: the servers are this rank's chunks, the
        # snapshots of w are the servers (no snapW)
        srv = tuple(c.chunk(w, p) for c, p in zip(self.comms, self._pads(d),
                                                   strict=True))
        anchors = (srv, (a,) * D) if self.accelerated else ((), ())
        return ExecState(a, w, (a,) * D, (), srv, res, *anchors)

    def gather_leaves(self, x: Tensor) -> Tensor:
        """(1, k) per rank -> (n, k) in leaf order, on every rank."""
        return self.world.gather_rows(x.reshape(1, -1))

    def finalize(self, state: ExecState) -> Tuple[Tensor, Tensor]:
        """The global (alpha, w) on every rank (one all-gather): (m,) and
        (d,), or (B, m) and (B, d) for a batched executor."""
        m_b = self.plan.m_b
        a, w = (state.a, state.w) if self.batched else \
            (state.a[None], state.w[None])
        B, d = a.shape[0], w.shape[-1]
        rows = self.gather_leaves(torch.cat(
            [a.reshape(B, m_b), w.reshape(B, d)], dim=1))
        rows = rows.view(-1, B, m_b + d)
        alpha = rows[:, :, :m_b].transpose(0, 1).reshape(B, -1)
        w_out = rows[0, :, m_b:].clone()
        if self.batched:
            return alpha, w_out
        return alpha[0], w_out[0]

    # ---- syncs ---------------------------------------------------------
    def _group_sum(self, dd: int, contrib: Tensor) -> Tensor:
        """The psum lowering: the group's weighted deltas gathered in leaf
        order and summed as the host sums a group (one reduction over
        the group's leaf axis), so the total is the host's bit for bit."""
        rows = self.comms[dd].gather_rows(contrib)
        return rows.view(1, *rows.shape).sum(1)

    def _sync(self, s: int, c, part: Tensor, one: Tensor,
              acc: Optional[float], acc_on: Optional[Tensor]) -> None:
        if self.sync == "psum":
            return super()._sync(s, c, part, one, acc, acc_on)
        self._sync_rs(s, c, acc, acc_on)

    def _sync_rs(self, s: int, c, acc: Optional[float],
                 acc_on: Optional[Tensor]) -> None:
        """Tick ``s``'s syncs under the reduce_scatter lowering, bottom-up
        (full participation: every leaf attends, every gate is 1)."""
        D, R = self.plan.depth, self.rows
        a, w = c.a, c.w
        d = w.shape[-1]
        pads = self._pads(d)
        for dd in range(D - 1, -1, -1):
            if not self.events[s, dd]:
                continue
            comm, p = self.comms[dd], pads[dd]
            snap = comm.gather_chunks(c.srvW[dd])[:, :d]
            delta = w - snap
            ri = self.res_slot.get(dd)
            if ri is not None:
                target = delta.float() + c.res[ri]
                approx = self.roundtrip(dd, target)
                c.res[ri] = target - approx
                delta = approx.to(w.dtype)
            contrib = self.wcoef[dd][R][:, None] * delta
            pad = comm.size * p - d
            if pad:
                contrib = torch.nn.functional.pad(contrib, (0, pad))
            base_sh = c.srvW[dd] + comm.reduce_scatter(contrib)
            base_a = (c.snapA[dd] + self.ascale[dd][R][:, None]
                      * (a - c.snapA[dd]))
            if acc is not None:
                ext_sh = base_sh + acc * (base_sh - c.srvP[dd])
                new_sh = torch.where(acc_on, ext_sh, base_sh)
                ext_a = base_a + acc * (base_a - c.srvA[dd])
                a = torch.where(acc_on, ext_a, base_a)
                c.srvP[dd], c.srvA[dd] = base_sh, base_a
            else:
                new_sh, a = base_sh, base_a
            w = comm.gather_chunks(new_sh)[:, :d]
            # this depth and every deeper one rebase on the new w; deeper
            # momentum anchors restart there (zero velocity)
            for d2 in range(dd, D):
                c.snapA[d2] = a
                c.srvW[d2] = self.comms[d2].chunk(w, pads[d2])
                if acc is not None and d2 > dd:
                    c.srvP[d2], c.srvA[d2] = c.srvW[d2], a
        c.a, c.w = a, w


def _config_hash(key) -> float:
    """A float64-exact digest of an executor key (48 bits), for the
    every-rank-agrees check."""
    text = repr(tuple(k for f, k in zip(MESH_KEY_FIELDS, key, strict=True)
                      if f not in ("mesh", "device")))
    return float(int(hashlib.sha1(text.encode()).hexdigest()[:12], 16))


def get_mesh_executor(
    plan: TreePlan,
    mesh,
    *,
    axes: Sequence[str] = (),
    loss: Loss,
    use_kernel: bool = True,
    carry_state: bool = False,
    sync: str = "psum",
    batched: bool = False,
    accelerated: bool = False,
    device=None,
) -> MeshExecutor:
    """Build (or fetch from cache) this rank's :class:`MeshExecutor` for
    ``plan`` on ``mesh`` (a ``DeviceMesh`` with one rank per leaf; its
    buffers on ``device``, by default the mesh's device type).

    ``use_kernel`` solves leaves with the ``sdca_block`` kernel (its plain
    version on CPU tensors) or, when False, with the plain version; ``sync``
    picks the lowering (``"psum"``, bit for bit the host backend, or
    ``"reduce_scatter"``, full participation only); ``batched`` adds the
    leading config axis of a sweep (one launch per solve tick for every
    config, the syncs config by config) and ``accelerated`` the
    ``sdca_acc`` momentum anchors (``step`` then takes ``acceleration``).
    Every executor carries state (``init`` / ``step`` / ``finalize``), so
    ``carry_state`` is accepted for parity with the reference and changes
    nothing.  A collective: every rank must call it with the same
    arguments (checked)."""
    if mesh is None or not axes:
        raise ValueError("the mesh backend needs mesh= (a DeviceMesh with "
                         "one rank per leaf) and its axes=, innermost "
                         "first")
    _check_plan_mesh(plan, mesh, axes)
    if sync not in SYNC_MODES:
        raise ValueError(f"sync must be one of {SYNC_MODES}, got {sync!r}")
    _comp_specs(plan)
    dev = torch.device(mesh.device_type if device is None else device)
    cache_key = (plan.fingerprint, loss.name, loss.gamma, tuple(axes), mesh,
                 bool(use_kernel), bool(carry_state), sync, bool(batched),
                 bool(accelerated), str(dev))
    ex = _MESH_EXEC_CACHE.get(cache_key)
    if ex is not None:
        _MESH_CACHE_STATS["hits"] += 1
        _MESH_EXEC_CACHE.move_to_end(cache_key)
        return ex
    ranks = leaf_ranks(mesh, axes)
    L = plan.depth
    ks = [plan.levels[d].group_size for d in range(L)]
    comms = _build_groups(ranks, [math.prod(ks[d:]) for d in range(L)],
                          GROUP_TIMEOUT)
    h = _config_hash(cache_key)
    seen = comms[0].all_max(torch.tensor([h, -h], dtype=torch.float64))
    if float(seen[0]) != h or float(seen[1]) != -h:
        raise RuntimeError(
            "the ranks built different mesh executors (plan, loss or "
            "flags differ): every rank must make the same Session calls")
    ex = MeshExecutor(plan, comms, ranks.index(dist.get_rank()), loss=loss,
                      use_kernel=use_kernel, sync=sync, device=dev,
                      batched=batched, accelerated=accelerated)
    _MESH_CACHE_STATS["misses"] += 1
    _MISS_LOG.append({"backend": "mesh", "key": _named_key(cache_key)})
    del _MISS_LOG[:-_MISS_LOG_MAX]
    _MESH_EXEC_CACHE[cache_key] = ex
    while len(_MESH_EXEC_CACHE) > _MESH_EXEC_CACHE_MAX:
        _MESH_EXEC_CACHE.popitem(last=False)
    return ex


def execute_plan_mesh(
    plan: TreePlan,
    tree: TreeNode,
    X: Tensor,
    y: Tensor,
    mesh,
    *,
    axes: Sequence[str],
    loss: Loss,
    lam: float,
    key=None,
    use_kernel: bool = True,
    alpha0: Optional[Tensor] = None,
    w0: Optional[Tensor] = None,
    participation=None,
    steps=None,
    sync: str = "psum",
) -> Tuple[Tensor, Tensor]:
    """Run the plan on ``mesh`` from (alpha0, w0) (zeros by default) under
    the (S, n) participation and (S, n, h_max) step masks (all ones by
    default); ``X`` / ``y`` are the global data on this rank's device.
    Returns the global (alpha (m,), w (d,)) on every rank."""
    n, m_b = plan.n_leaves, plan.m_b
    m, d_feat = X.shape
    if n * m_b != m:
        raise ValueError(f"{n} leaves of {m_b} rows != {m} rows")
    dev = X.device
    ex = get_mesh_executor(plan, mesh, axes=axes, loss=loss,
                           use_kernel=use_kernel, sync=sync, device=dev)
    keys = key_plan(tree, plan, key)                        # (S, n, 2)
    if participation is None:
        participation = full_participation(plan)
    if steps is None:
        steps = full_steps(plan)
    if alpha0 is None:
        alpha0 = torch.zeros(m, dtype=X.dtype, device=dev)
    if w0 is None:
        w0 = torch.zeros(d_feat, dtype=X.dtype, device=dev)
    return ex(ex.prepare(X, y), prng.as_key(keys).to(dev), alpha0, w0,
              torch.as_tensor(participation, dtype=X.dtype, device=dev),
              torch.as_tensor(np.asarray(steps), dtype=X.dtype, device=dev),
              regularizer_scale(lam, plan.m_total))


def tree_from_mesh_axes(
    mesh,
    axes: Sequence[str],
    rounds: Sequence[int],
    *,
    local_steps: int,
    m_leaf: int,
) -> TreeNode:
    """The tree whose recursion IS the mesh-axis hierarchy: ``axes`` are
    listed innermost (leaf level) first, so the root fans out over
    ``axes[-1]`` and runs ``rounds[-1]`` rounds."""
    sizes = [axis_size(mesh, a) for a in axes]
    return balanced_tree(
        list(reversed(sizes)), list(reversed(rounds)),
        local_steps=local_steps, m_leaf=m_leaf)


__all__ = ["COLLECTIVE_FORMS", "GROUP_TIMEOUT", "GroupComm",
           "MESH_KEY_FIELDS", "MeshExecutor", "SYNC_MODES",
           "execute_plan_mesh", "get_mesh_executor", "leaf_ranks",
           "mesh_executor_cache_keys", "mesh_executor_cache_stats",
           "mesh_state_floats", "tree_from_mesh_axes"]
