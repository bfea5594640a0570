"""Host executor: run a :class:`~repro_torch.core.engine.plan.TreePlan`
tick by tick on one device.

Per tick: a batched leaf solve (the CUDA ``sdca_block`` kernel, or its
plain-torch version), then the tick's sync events bottom-up (per-leaf
alpha rescale against the depth snapshot and a segment-summed weighted
w-average), then snapshot refreshes -- the JAX package's
``core/engine/host.py`` tick body, written as a Python loop over the
static plan instead of one ``lax.scan``.  Whether a tick solves or syncs
at all is read from the plan on the host, so idle work is skipped rather
than masked.

Runtime operands, as in the reference: a ``(S, n)`` participation mask
(a leaf whose mask is 0 is absent from that tick's syncs: present
children's weights are renormalized and a per-depth server ``w`` carry
lets it re-join later; all ones = the synchronous schedule, bit for bit)
and a ``(S, n, h_max)`` step mask (draws always cover each leaf's H
capacity, the mask zeroes trailing steps; all ones = the static-H
schedule, bit for bit).

Segment sums run over the contiguous leaf ranges of each group (a
reshape-sum when the groups tile the leaves evenly), so a run is
reproducible on the card: no atomics decide a summation order.

Edge compression with error feedback: a compressed depth carries an
``(n, d)`` float32 residual per leaf; at each of its sync events a leaf's
message is ``delta_w + residual`` through its edge's roundtrip
(``core/compression.py``; leaves grouped by (kind, frac)), and the
residual advances to what the roundtrip dropped, for the leaves that
attend.  The residuals outlive a root round, so compressed sessions
thread the executor's full state (:class:`ExecState`: ``init`` ->
``step`` per root round -> ``finalize``) instead of the flat
``(alpha, w)`` pair.  A plan with no compressed depth runs the
uncompressed tick, and ``forward`` is ``finalize(step(init(...)))``.

Flavors (``get_host_executor(batched=, accelerated=)``):

* ``batched=True`` puts a leading config axis B on the state, the keys,
  the step masks and ``lm`` (a sweep's lambda x local-H x seed grid);
  X, y and the participation mask are shared.  Each solve tick is ONE
  ``sdca_block`` launch over all B x n leaves (the ``"torch"`` backend
  runs its plain version config by config); the syncs then run config
  by config on that config's slice, the same ops on the same shapes as
  an unbatched run, so every member equals its standalone run bit for
  bit (a reduction over a batched shape may sum in another order).
* ``accelerated=True`` (the ``sdca_acc`` method) adds per-depth momentum
  anchors (``srvP`` for the server w, ``srvA`` for alpha) and
  extrapolates both sides of the primal-dual pair at every sync, ``x =
  base + acceleration * (base - prev)``; ``acceleration`` is a runtime
  float of ``step``, and a zero coefficient selects the base out of a
  ``torch.where`` (not a multiply), so it is plain SDCA bit for bit.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.core import compression as comp_mod
from repro_torch.core import instrument
from repro_torch.core import prng
from repro_torch.core.dual import Loss
from repro_torch.core.engine.plan import (TreePlan, full_participation,
                                          full_steps)
from repro_torch.kernels.prng import kernel as prng_kernel
from repro_torch.kernels.prng import ref as prng_ref
from repro_torch.kernels.sdca import kernel as sdca_kernel
from repro_torch.kernels.sdca.ref import sdca_steps_ref_batched

Tensor = torch.Tensor

BACKENDS = ("cuda", "torch")


def regularizer_scale(lam: float, m_total: int) -> float:
    """lambda * m computed in double precision and rounded once to
    float32: the runtime scalar the leaf solve divides by (the value the
    reference's executors receive)."""
    return float(np.float32(float(lam) * m_total))


class BlockedData(NamedTuple):
    """A problem in the executor's blocked layout: ``Xb`` (n, m_b, d) and
    ``yb`` (n, m_b), smaller leaves zero-padded, and the row norms
    ``sqnorm = sum(Xb**2, -1)`` the leaf solve divides by lambda*m."""
    Xb: Tensor
    yb: Tensor
    sqnorm: Tensor


class ExecState(NamedTuple):
    """The executor's full blocked carry between root rounds: ``a`` (n,
    m_b), ``w`` (n, d), one snapshot of each per internal depth (``snapA``
    (n, m_b), ``snapW`` (n, d)), the per-depth group servers ``srvW`` (n,
    d), one float32 error-feedback residual (n, d) per compressed depth,
    shallowest first (``res``; empty for an uncompressed plan), and, for
    an accelerated executor, the per-depth momentum anchors ``srvP`` (n,
    d) and ``srvA`` (n, m_b) (empty otherwise).  A batched executor's
    state carries a leading config axis B on every tensor."""
    a: Tensor
    w: Tensor
    snapA: Tuple[Tensor, ...]
    snapW: Tuple[Tensor, ...]
    srvW: Tuple[Tensor, ...]
    res: Tuple[Tensor, ...] = ()
    srvP: Tuple[Tensor, ...] = ()
    srvA: Tuple[Tensor, ...] = ()


class _Segments:
    """Sums over the contiguous leaf ranges of one depth's groups (or
    children), indexed like the plan's ``group_ids`` / ``child_ids``."""

    def __init__(self, ids: np.ndarray, member: np.ndarray, count: int):
        n = len(ids)
        self.ranges: List[Tuple[int, int]] = []
        for g in range(count):
            pos = np.nonzero((ids == g) & member)[0]
            if len(pos) == 0:
                self.ranges.append((0, 0))
                continue
            lo, hi = int(pos[0]), int(pos[-1]) + 1
            if hi - lo != len(pos):
                raise ValueError(f"segment {g} is not a contiguous leaf range")
            self.ranges.append((lo, hi))
        b = self.ranges[0][1] - self.ranges[0][0]
        tiled = b > 0 and count * b == n and all(
            r == (i * b, (i + 1) * b) for i, r in enumerate(self.ranges))
        self.block = b if tiled else 0

    def sum(self, v: Tensor) -> Tensor:
        if self.block:
            return v.reshape(len(self.ranges), self.block,
                             *v.shape[1:]).sum(1)
        return torch.stack([v[lo:hi].sum(0) for lo, hi in self.ranges])


class _Carry:
    """One config's mutable view of the state inside :meth:`HostExecutor.
    step`: ``a``, ``w`` and per-depth lists of the other fields."""

    def __init__(self, state: ExecState, b: int):
        self.a, self.w = state.a[b], state.w[b]
        self.snapA = [t[b] for t in state.snapA]
        self.snapW = [t[b] for t in state.snapW]
        self.srvW = [t[b] for t in state.srvW]
        self.res = [t[b] for t in state.res]
        self.srvP = [t[b] for t in state.srvP]
        self.srvA = [t[b] for t in state.srvA]


def _stack_carries(a: Tensor, w: Tensor, carries: List[_Carry]) -> ExecState:
    def stack(field):
        return tuple(torch.stack([getattr(c, field)[i] for c in carries])
                     for i in range(len(getattr(carries[0], field))))
    return ExecState(a, w, stack("snapA"), stack("snapW"), stack("srvW"),
                     stack("res"), stack("srvP"), stack("srvA"))


def _map_state(state: ExecState, fn) -> ExecState:
    return ExecState(fn(state.a), fn(state.w),
                     *(tuple(fn(t) for t in field) for field in state[2:]))


class HostExecutor(nn.Module):
    """The compiled form of one plan on one device: static layout maps and
    per-tick masks as buffers, the tick loop in :meth:`step`.

    ``backend="cuda"`` solves leaves with the ``sdca_block`` kernel
    (CPU tensors take its plain version, as every kernel wrapper does),
    ``backend="torch"`` with the plain version everywhere.  ``batched``
    and ``accelerated`` select the flavors of the module docstring.

    ``rows`` are the leaves whose state the executor carries: all of them
    here, one per rank on the mesh (``core/engine/mesh.py``).  The sync
    gates are computed over every leaf from the plan and the (S, n)
    participation mask, then read at ``rows``; only the weighted group
    sum of the w-deltas (:meth:`_group_sum`) needs the other leaves'
    state."""

    def __init__(self, plan: TreePlan, *, loss: Loss, backend: str = "cuda",
                 device="cuda", batched: bool = False,
                 accelerated: bool = False, rows: slice = slice(None)):
        super().__init__()
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; use {BACKENDS}")
        self.plan, self.loss, self.backend = plan, loss, backend
        self.batched, self.accelerated = bool(batched), bool(accelerated)
        self.rows = rows
        n, m_b, m = plan.n_leaves, plan.m_b, plan.m_total
        D, h_max = plan.depth, plan.h_max
        dev = torch.device(device)

        def buf(name, arr, dtype):
            self.register_buffer(name, torch.as_tensor(
                np.asarray(arr), dtype=dtype, device=dev), persistent=False)

        # ---- static layout maps -------------------------------------------
        j = np.arange(m_b)
        offsets, sizes = plan.leaf_offsets, plan.leaf_sizes
        flat_map = np.concatenate([
            li * m_b + np.arange(int(sizes[li])) for li in range(n)])
        # equal, contiguous blocks: the blocked layout is a view of X
        self.congruent = bool((sizes == m_b).all())
        buf("gather_idx", np.minimum(offsets[:, None] + j[None, :], m - 1),
            torch.int64)
        buf("valid", j[None, :] < sizes[:, None], torch.float32)
        buf("flat_map", flat_map, torch.int64)
        buf("hmask", (np.arange(h_max)[None, :] < plan.leaf_h[:, None])[rows],
            torch.float32)
        buf("ascale", plan.alpha_scale, torch.float32)
        buf("wcoef", plan.w_coeff, torch.float32)
        buf("gids", plan.group_ids, torch.int64)
        buf("cids", plan.child_ids, torch.int64)
        buf("csize", plan.child_sizes, torch.float32)
        buf("solve_mask", plan.solve_mask, torch.float32)
        buf("sync_mask", plan.sync_mask, torch.float32)
        buf("refresh_mask", plan.refresh_mask, torch.float32)
        # the carried leaves' H capacities and block sizes, the draws'
        # operands; the draws are as wide as the one H, else h_max
        leaf_h = plan.leaf_h[rows]
        hs = {int(v) for v in leaf_h}
        self.draw_width = hs.pop() if len(hs) == 1 else h_max
        buf("draw_h", leaf_h, torch.int32)
        buf("draw_mb", sizes[rows], torch.int32)
        # the plain draws' grouping by H, built once (the kernel needs none)
        self.draw_groups = (None if dev.type == "cuda" else
                            prng_ref.h_groups(self.draw_h, self.draw_mb))
        member = plan.sync_mask.max(axis=0) > 0                  # (D, n)
        self.groups = [_Segments(plan.group_ids[dd], member[dd],
                                 plan.n_groups[dd]) for dd in range(D)]
        self.children = [_Segments(plan.child_ids[dd], member[dd],
                                   plan.n_children[dd]) for dd in range(D)]
        # host-side tick structure: which ticks solve, which depths sync
        self.solves = plan.solve_mask.max(axis=1) > 0            # (S,)
        self.events = plan.sync_mask.max(axis=2) > 0             # (S, D)
        # per tick, the depths that sync: the tick.sync range's argument,
        # which tells a root sync from a group sync in a trace viewer
        self.sync_depths = [",".join(str(dd) for dd in np.flatnonzero(ev))
                            for ev in self.events]
        # edge compression: per compressed depth, its residual slot and
        # its leaves grouped by (kind, frac), so each roundtrip is one
        # call over a row block (a row = one edge's message: all leaves
        # of a child subtree carry the child's delta)
        self.res_slot = {}
        self.comp_groups = {}
        if plan.has_compression:
            for dd in range(D):
                if not (plan.compress_kind[dd] != comp_mod.KIND_NONE).any():
                    continue
                self.res_slot[dd] = len(self.res_slot)
                kinds = plan.compress_kind[dd][rows]
                fracs = plan.compress_frac[dd][rows]
                groups = {}
                for li in np.nonzero(kinds != comp_mod.KIND_NONE)[0]:
                    key = (int(kinds[li]), float(fracs[li]))
                    groups.setdefault(key, []).append(int(li))
                self.comp_groups[dd] = [
                    (k, f, torch.as_tensor(rows, device=dev))
                    for (k, f), rows in sorted(groups.items())]
                buf(f"comp_mask{dd}", (kinds != comp_mod.KIND_NONE)[:, None],
                    torch.bool)

    # ------------------------------------------------------------------
    def prepare(self, X: Tensor, y: Tensor) -> BlockedData:
        """The blocked layout of flat (m, d) / (m,) data (a view when every
        leaf has m_b rows) and its row norms."""
        n, m_b = self.plan.n_leaves, self.plan.m_b
        if self.congruent:
            Xb = X.contiguous().view(n, m_b, X.shape[1])
            yb = y.contiguous().view(n, m_b)
        else:
            Xb = X[self.gather_idx] * self.valid[:, :, None]
            yb = y[self.gather_idx] * self.valid
        # one leaf at a time: no (n, m_b, d) temporary
        sqnorm = torch.stack([torch.sum(xb * xb, dim=-1) for xb in Xb])
        return BlockedData(Xb, yb, sqnorm)

    def draw_idx(self, keys_s: Tensor) -> Tensor:
        """A tick's coordinate draws from its (..., n, 2) keys: ``randint(
        key_l, (H_l,), 0, m_b_l)`` per leaf, exactly as the legacy
        recursion, as (..., n, h_max) int32 with zeros beyond each leaf's
        H ((..., n, H) when every leaf has the same H).  On the card one
        ``threefry_randint`` launch covers every config and leaf; CPU keys
        take its plain version, ``core/prng.py::randint`` per H, over the
        grouping by H built once in ``__init__``."""
        return prng_kernel.randint_rows(keys_s, self.draw_h, self.draw_mb,
                                        self.draw_width, self.draw_groups)

    def leaf_solve(self, data: BlockedData, a, w, xsq, idx, mk, lms):
        """One solve tick for B configs: ``a`` (B, n, m_b), ``w`` (B, n,
        d), ``xsq`` (B, n, m_b), ``idx`` / ``mk`` (B, n, h_max), ``lms``
        the B values of lambda * m; returns (delta_a, delta_w)."""
        if self.backend == "cuda":
            return sdca_kernel.sdca_block_launch_batched(
                data.Xb, data.yb, a, w, xsq, idx, loss=self.loss, lms=lms,
                step_mask=mk)
        return sdca_steps_ref_batched(data.Xb, data.yb, a, w, xsq, idx,
                                      loss=self.loss, lms=lms, step_mask=mk)

    def roundtrip(self, dd: int, target: Tensor) -> Tensor:
        """The receiver's view of depth ``dd``'s per-edge messages: each
        compressed leaf row through its edge's quantize + dequantize (or
        top-k), uncompressed rows as they are."""
        approx = target.clone()
        for kind, frac, rows in self.comp_groups[dd]:
            sub = target[rows]
            if kind == comp_mod.KIND_INT8:
                rt = comp_mod.int8_roundtrip(sub, keep_leading=1)
            else:
                rt = comp_mod.topk_roundtrip(
                    sub, comp_mod.topk_count(sub.shape[-1], frac))
            approx[rows] = rt
        return approx

    # ------------------------------------------------------------------
    def _init_one(self, X: Tensor, alpha0: Tensor, w0: Tensor) -> ExecState:
        n, m_b, D = self.plan.n_leaves, self.plan.m_b, self.plan.depth
        d = X.shape[-1]
        a = torch.zeros(n * m_b, dtype=X.dtype, device=alpha0.device)
        a[self.flat_map] = alpha0.to(X.dtype)
        a = a.view(n, m_b)
        w = w0.to(X.dtype).expand(n, d).contiguous()
        res = tuple(torch.zeros((n, d), dtype=torch.float32,
                                device=w.device) for _ in self.res_slot)
        # the momentum anchors start at the run-start state: a run's first
        # sync extrapolates along its own first combination delta
        anchors = ((w,) * D, (a,) * D) if self.accelerated else ((), ())
        return ExecState(a, w, (a,) * D, (w,) * D, (w,) * D, res, *anchors)

    def init(self, X: Tensor, alpha0: Tensor, w0: Tensor) -> ExecState:
        """The blocked run-start state from flat ``alpha0`` (m,) and ``w0``
        (d,) -- (B, m) and (B, d) for a batched executor -- in the dtype of
        ``X`` (the flat (m, d) data or its blocked layout): snapshots,
        group servers and momentum anchors at the start state, zero
        residuals."""
        if not self.batched:
            return self._init_one(X, alpha0, w0)
        one = [self._init_one(X, alpha0[b], w0[b])
               for b in range(alpha0.shape[0])]
        return ExecState(*(
            torch.stack([s[i] for s in one]) if i < 2 else
            tuple(torch.stack([s[i][j] for s in one])
                  for j in range(len(one[0][i])))
            for i in range(len(ExecState._fields))))

    def finalize(self, state: ExecState) -> Tuple[Tensor, Tensor]:
        """The flat (alpha (m,), w (d,)) of a state at a root-round
        boundary (where every leaf's w is the root's); (B, m) and (B, d)
        for a batched executor."""
        if self.batched:
            B = state.a.shape[0]
            return state.a.reshape(B, -1)[:, self.flat_map], state.w[:, 0]
        return state.a.reshape(-1)[self.flat_map], state.w[0]

    def step(self, data: BlockedData, keys: Tensor, state: ExecState,
             participation: Tensor, steps: Tensor, lm,
             acceleration: Optional[float] = None) -> ExecState:
        """One pass over the plan's S ticks from ``state``.  ``keys`` is
        the (S, n, 2) per-solve key plan, ``steps`` the (S, n, h_max) step
        mask and ``lm`` the float32 lambda*m (:func:`regularizer_scale`);
        a batched executor takes (B, S, n, 2) keys, (B, S, n, h_max) steps
        and B values of ``lm``.  ``participation`` (S, n) is shared.  An
        accelerated executor needs the momentum coefficient
        ``acceleration`` (a runtime float), and no other takes one."""
        if self.accelerated:
            if acceleration is None:
                raise ValueError("an accelerated executor's step needs "
                                 "acceleration=")
            acc = float(np.float32(acceleration))
        elif acceleration is not None:
            raise ValueError("acceleration= needs an accelerated executor "
                             "(get_host_executor(accelerated=True))")
        else:
            acc = None
        if self.batched:
            # once a root round, before the tick loop: B host floats
            if isinstance(lm, Tensor):
                instrument.count("host_syncs")
            lms = lm.tolist() if isinstance(lm, Tensor) else lm  # analysis: allow(host-sync-in-tick) read once per step, not per tick
            return self._run(data, keys, state, participation, steps,
                             [float(v) for v in lms], acc)
        out = self._run(data, keys[None], _map_state(state, lambda t: t[None]),
                        participation, steps[None], [float(lm)], acc)
        return _map_state(out, lambda t: t[0])

    def _lm_on(self, lm_host: List[float], device) -> Tensor:
        """The kernel's (B,) ``lm`` operand on ``device``, copied there once
        per set of values: every step of a run reuses it, so a step makes
        no host-to-device copy (which strict mode's sync guard refuses)."""
        key = (tuple(lm_host), str(device))
        if getattr(self, "_lm_key", None) != key:
            self._lm_dev = sdca_kernel.lm_array(lm_host, device)
            self._lm_key = key
            instrument.count_h2d(lm_host, self._lm_dev)
        return self._lm_dev

    def _run(self, data: BlockedData, keys: Tensor, state: ExecState,
             participation: Tensor, steps: Tensor, lm_host: List[float],
             acc: Optional[float]) -> ExecState:
        """:meth:`step` over a leading config axis (B = 1 unbatched)."""
        plan = self.plan
        B = len(lm_host)
        dev = state.a.device
        # each config's ||x||^2 / lm, divided as a one-config run divides
        xsq = torch.stack([data.sqnorm / v for v in lm_host])
        lms = lm_host if self.backend == "torch" else \
            self._lm_on(lm_host, data.Xb.device)
        a, w = state.a, state.w
        R = self.rows
        carries = [_Carry(state, b) for b in range(B)]
        one = torch.ones((), dtype=w.dtype, device=dev)
        acc_on = None if acc is None else torch.full(
            (), acc != 0.0, dtype=torch.bool, device=dev)
        for s in range(plan.n_ticks):
            if self.solves[s]:
                with instrument.span("tick.draw", device=dev, tick=s):
                    idx = self.draw_idx(keys[:, s, R].contiguous())
                with instrument.span("tick.solve", tick=s):
                    # the static per-leaf H gate x the solve slot x the
                    # runtime step mask; all-ones steps multiply by 1.0
                    mk = self.hmask * self.solve_mask[s][R, None] * \
                        steps[:, s, R]
                    da, dw = self.leaf_solve(data, a, w, xsq, idx, mk, lms)
                    a = a + da
                    w = w + dw
            if not self.events[s].any():
                continue
            with instrument.span("tick.sync", tick=s,
                                 depth=self.sync_depths[s]):
                # the syncs config by config, on each config's own slice
                for b, c in enumerate(carries):
                    c.a, c.w = a[b], w[b]
                    self._sync(s, c, participation[s], one, acc, acc_on)
                a = torch.stack([c.a for c in carries])
                w = torch.stack([c.w for c in carries])
        return _stack_carries(a, w, carries)

    def _sync(self, s: int, c: _Carry, part: Tensor, one: Tensor,
              acc: Optional[float], acc_on: Optional[Tensor]) -> None:
        """Tick ``s``'s sync events bottom-up, the server rebase and the
        snapshot refresh, for one config (``c``, updated in place)."""
        D, R = self.plan.depth, self.rows
        a, w = c.a, c.w
        act_of: List[Optional[Tensor]] = [None] * D
        # leaves that attended a deeper sync earlier in this tick: they now
        # hold that group's server state, whose baseline at this depth is
        # this depth's server, not a snapshot from before an absence
        deeper: Optional[Tensor] = None
        for dd in range(D - 1, -1, -1):
            if not self.events[s, dd]:
                continue
            ev = self.sync_mask[s, dd]
            e = ev * part                                 # participants
            wc = self.wcoef[dd]
            seg, gid = self.groups[dd], self.gids[dd]
            absent_g = seg.sum((ev - e) * wc)
            present_g = seg.sum(e * wc)
            # exactly 1.0 under full participation: x / 1.0 == x
            denom_g = torch.where(
                absent_g == 0, one,
                torch.where(present_g > 0, present_g, one))
            denom = denom_g[gid][R]
            act = ((ev > 0) & (present_g > 0)[gid])[R]   # group live
            eb = (e[R] > 0)[:, None]                      # leaf attends
            base_a = (c.snapA[dd] + (self.ascale[dd][R] / denom)[:, None]
                      * (a - c.snapA[dd]))
            if acc is not None:
                # extrapolate alpha along its own combined sequence with
                # the coefficient of the server w below: w is the linear
                # image X^T alpha / (lambda m) of alpha, so one shared
                # extrapolation keeps the primal-dual pair consistent
                ext_a = base_a + acc * (base_a - c.srvA[dd])
                new_a = torch.where(acc_on, ext_a, base_a)
                c.srvA[dd] = torch.where(eb, base_a, c.srvA[dd])
                a = torch.where(eb, new_a, a)
            else:
                a = torch.where(eb, base_a, a)
            # a partially present child is represented by its surviving
            # leaves: their weights scale by |child| / |present|
            cnt_c = self.children[dd].sum(e)
            corr = (self.csize[dd] / torch.clamp(cnt_c, min=1.0)[
                self.cids[dd]])[R]
            # the fast-forward the snapshot refresh applies after a tick
            # whose shallower depths do not sync, applied here before a
            # shallower sync of the same tick: a leaf re-joining after an
            # absence would otherwise re-deliver the server progress it
            # missed (the reference uses the stale snapshot here, see
            # ROADMAP queue C).  Every other leaf's snapshot equals its
            # server row at this point, so the select changes no bit.
            snap_w = c.snapW[dd] if deeper is None else torch.where(
                deeper[:, None], c.srvW[dd], c.snapW[dd])
            delta_w = w - snap_w
            ri = self.res_slot.get(dd)
            if ri is not None:
                # error feedback: the message is delta + residual; the
                # residual advances only for leaves that deliver now
                target = delta_w.float() + c.res[ri]
                approx = self.roundtrip(dd, target)
                c.res[ri] = torch.where(eb, target - approx, c.res[ri])
                delta_w = torch.where(getattr(self, f"comp_mask{dd}"),
                                      approx.to(w.dtype), delta_w)
            contrib = (((wc[R] * e[R]) / denom) * corr)[:, None] * delta_w
            srv_base = c.srvW[dd] + self._group_sum(dd, contrib)
            if acc is not None:
                # server momentum along the un-extrapolated combination
                # sequence (kept in srvP); a zero coefficient selects
                # srv_base itself (a where, not a multiply)
                srv_ext = srv_base + acc * (srv_base - c.srvP[dd])
                srv_new = torch.where(acc_on, srv_ext, srv_base)
                c.srvP[dd] = torch.where(act[:, None], srv_base, c.srvP[dd])
            else:
                srv_new = srv_base
            c.srvW[dd] = torch.where(act[:, None], srv_new, c.srvW[dd])
            w = torch.where(eb, srv_new, w)
            act_of[dd] = act
            deeper = eb[:, 0] if deeper is None else deeper | eb[:, 0]
        # deeper servers (and momentum anchors: zero velocity after a
        # rebase) restart from the shallowest live sync's result
        for dd in range(D - 1, -1, -1):
            if act_of[dd] is None:
                continue
            live = act_of[dd][:, None]
            for d2 in range(dd + 1, D):
                c.srvW[d2] = torch.where(live, c.srvW[dd], c.srvW[d2])
                if acc is not None:
                    c.srvP[d2] = torch.where(live, c.srvW[dd], c.srvP[d2])
                    c.srvA[d2] = torch.where(live, a, c.srvA[d2])
        # snapshot refresh for participants; depths above a leaf's
        # shallowest attended sync fast-forward to the server state
        refb = ((self.refresh_mask[s] * part[None, :]) > 0)[:, R]  # (D, rows)
        attended = ((self.sync_mask[s].amax(dim=0) * part) > 0)[R]
        for dd in range(D):
            r = refb[dd][:, None]
            ffwd = (~refb[dd] & attended)[:, None]
            c.snapA[dd] = torch.where(r, a, c.snapA[dd])
            c.snapW[dd] = torch.where(
                r, w, torch.where(ffwd, c.srvW[dd], c.snapW[dd]))
        c.a, c.w = a, w

    def _group_sum(self, dd: int, contrib: Tensor) -> Tensor:
        """Each carried leaf's group total of the weighted w-deltas at
        depth ``dd``: a segment sum over the group's leaf range."""
        return self.groups[dd].sum(contrib)[self.gids[dd]]

    def forward(self, data: BlockedData, keys: Tensor, alpha0: Tensor,
                w0: Tensor, participation: Tensor, steps: Tensor,
                lm, acceleration: Optional[float] = None
                ) -> Tuple[Tensor, Tensor]:
        """One pass over the plan's S ticks from flat (alpha0, w0):
        ``finalize(step(init(...)))``.  Returns the flat (alpha, w)."""
        state = self.init(data.Xb, alpha0, w0)
        return self.finalize(self.step(data, keys, state, participation,
                                       steps, lm, acceleration))


# Executors are cached per (plan structure, loss, flags, device), so
# repeated solves on one topology reuse one built executor; lambda, the
# step and participation masks and the momentum coefficient are runtime
# operands (a whole grid shares one executor).  LRU-bounded: schedule
# sweeps still build a plan per configuration.  An executor holds no
# per-run state (``Session.run`` threads ``init`` / ``step`` / ``finalize``
# state explicitly; ``_lm_on`` keeps a device copy of lambda * m keyed by
# its values), so two sessions may share one.
_EXEC_CACHE: OrderedDict = OrderedDict()
_EXEC_CACHE_MAX = 32
# field names of the cache-key tuple, in order: the reference's, less its
# ``record_history`` (the port's executors record no history), plus the
# device the buffers live on -- the trace guard's miss diffs name them
EXEC_KEY_FIELDS = ("plan_fingerprint", "loss", "gamma", "backend",
                   "carry_state", "batched", "accelerated", "device")
_EXEC_CACHE_STATS = {"hits": 0, "misses": 0}
# per-backend breakdown (the port's "cuda" / "torch" host backends; the
# mesh and LM caches report their own columns through
# executor_cache_stats)
_BACKEND_STATS = {b: {"hits": 0, "misses": 0} for b in BACKENDS}
# bounded log of recent host misses: {"backend", "key"} entries
_MISS_LOG: list = []
_MISS_LOG_MAX = 64


def _named_key(key) -> dict:
    return dict(zip(EXEC_KEY_FIELDS, key, strict=True))


def get_host_executor(plan: TreePlan, *, loss: Loss, backend: str = "cuda",
                      device="cuda", carry_state: bool = False,
                      batched: bool = False,
                      accelerated: bool = False) -> HostExecutor:
    """Build (or fetch from the cache) the executor for ``plan`` on
    ``device`` (see :class:`HostExecutor`), batched over a leading config
    axis and / or accelerated as asked.  Every executor carries state:
    ``init(X, alpha0, w0) -> state``, ``step(data, keys, state,
    participation, steps, lm[, acceleration]) -> state`` and
    ``finalize(state) -> (alpha, w)`` are its methods, so ``carry_state``
    (the reference's flag for that triple) builds the same executor; it
    is kept in the cache key, as the reference keys it."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; use {BACKENDS}")
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    # loss keyed by (name, gamma): names encode their parameters, so
    # per-call constructed losses still hit
    key = (plan.fingerprint, loss.name, loss.gamma, backend,
           bool(carry_state), bool(batched), bool(accelerated), str(dev))
    ex = _EXEC_CACHE.get(key)
    if ex is not None:
        _EXEC_CACHE_STATS["hits"] += 1
        _BACKEND_STATS[backend]["hits"] += 1
        _EXEC_CACHE.move_to_end(key)
        return ex
    ex = HostExecutor(plan, loss=loss, backend=backend, device=dev,
                      batched=batched, accelerated=accelerated)
    # counted once the build succeeded, so a failing configuration's
    # retries add no misses that never filled the cache
    _EXEC_CACHE_STATS["misses"] += 1
    _BACKEND_STATS[backend]["misses"] += 1
    _MISS_LOG.append({"backend": backend, "key": _named_key(key)})
    del _MISS_LOG[:-_MISS_LOG_MAX]
    _EXEC_CACHE[key] = ex
    while len(_EXEC_CACHE) > _EXEC_CACHE_MAX:
        _EXEC_CACHE.popitem(last=False)
    return ex


def host_executor_cache_stats() -> dict:
    """The host cache's own counters: {hits, misses, size}."""
    return dict(_EXEC_CACHE_STATS, size=len(_EXEC_CACHE))


def host_executor_miss_log() -> list:
    """The host cache's newest misses (the trace guard reads each cache's
    log on its own)."""
    return list(_MISS_LOG)


def executor_cache_stats() -> dict:
    """Cumulative counters of every engine executor cache: top-level
    ``{hits, misses, size}`` sum the host, mesh and LM caches, and
    ``by_backend`` breaks hits and misses down per backend, so a strict
    session or a benchmark can hold a miss budget for the backend it runs
    on.  The columns are ``"cuda"`` (the host executor with the
    ``sdca_block`` kernel; the reference's ``"pallas"``), ``"torch"``
    (the host executor with its plain version; the reference's
    ``"vmap"``), ``"mesh"`` and ``"lm"``."""
    from repro_torch.core.engine import lm as lm_mod
    from repro_torch.core.engine import mesh as mesh_mod
    mesh_stats = mesh_mod.mesh_executor_cache_stats()
    lm_stats = lm_mod.lm_executor_cache_stats()
    by_backend = {k: dict(v) for k, v in _BACKEND_STATS.items()}
    by_backend["mesh"] = {"hits": mesh_stats["hits"],
                          "misses": mesh_stats["misses"]}
    by_backend["lm"] = {"hits": lm_stats["hits"],
                        "misses": lm_stats["misses"]}
    return {
        "hits": sum(v["hits"] for v in by_backend.values()),
        "misses": sum(v["misses"] for v in by_backend.values()),
        "size": len(_EXEC_CACHE) + mesh_stats["size"] + lm_stats["size"],
        "by_backend": by_backend,
    }


def executor_cache_keys() -> list:
    """The host cache's current keys as named dicts (see
    ``EXEC_KEY_FIELDS``): what the trace guard diffs a miss against."""
    return [_named_key(k) for k in _EXEC_CACHE]


def executor_miss_log() -> list:
    """Recent misses of the host and mesh caches, newest last (each
    bounded at 64): ``{"backend": ..., "key": {field: value}}``."""
    from repro_torch.core.engine import mesh as mesh_mod
    return list(_MISS_LOG) + list(mesh_mod._MISS_LOG)


def clear_executor_cache() -> None:
    """Empty the host cache and zero its counters (the mesh and LM caches
    have their own)."""
    _EXEC_CACHE.clear()
    _EXEC_CACHE_STATS.update(hits=0, misses=0)
    for v in _BACKEND_STATS.values():
        v.update(hits=0, misses=0)
    _MISS_LOG.clear()


def execute_plan(
    plan: TreePlan,
    X: Tensor,
    y: Tensor,
    keys,
    *,
    loss: Loss,
    lam: float,
    backend: str = "cuda",
    alpha0: Optional[Tensor] = None,
    w0: Optional[Tensor] = None,
    participation=None,
    steps=None,
) -> Tuple[Tensor, Tensor]:
    """Build the executor on ``X``'s device and run it once from (alpha0,
    w0) (zeros by default) under the given masks (all ones by default);
    ``keys`` is the (S, n, 2) key plan (``plan.key_plan``)."""
    dev = X.device
    ex = get_host_executor(plan, loss=loss, backend=backend, device=dev)
    if alpha0 is None:
        alpha0 = torch.zeros(plan.m_total, dtype=X.dtype, device=dev)
    if w0 is None:
        w0 = torch.zeros(X.shape[1], dtype=X.dtype, device=dev)
    if participation is None:
        participation = full_participation(plan)
    if steps is None:
        steps = full_steps(plan)
    return ex(ex.prepare(X, y), prng.as_key(keys).to(dev), alpha0, w0,
              torch.as_tensor(participation, dtype=X.dtype, device=dev),
              torch.as_tensor(steps, dtype=X.dtype, device=dev),
              regularizer_scale(lam, plan.m_total))
