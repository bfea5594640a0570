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

Not ported yet: the batched and accelerated flavors (they need
``api/sweep.py`` and ``core/engine/method.py``); asking for them raises
``NotImplementedError``.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.core import compression as comp_mod
from repro_torch.core import prng
from repro_torch.core.dual import Loss
from repro_torch.core.engine.plan import (TreePlan, full_participation,
                                          full_steps)
from repro_torch.kernels.sdca import kernel as sdca_kernel
from repro_torch.kernels.sdca.ref import sdca_steps_ref

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
    d), and one float32 error-feedback residual (n, d) per compressed
    depth, shallowest first (``res``; empty for an uncompressed plan)."""
    a: Tensor
    w: Tensor
    snapA: Tuple[Tensor, ...]
    snapW: Tuple[Tensor, ...]
    srvW: Tuple[Tensor, ...]
    res: Tuple[Tensor, ...] = ()


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


class HostExecutor(nn.Module):
    """The compiled form of one plan on one device: static layout maps and
    per-tick masks as buffers, the tick loop in :meth:`forward`.

    ``backend="cuda"`` solves leaves with the ``sdca_block`` kernel
    (CPU tensors take its plain version, as every kernel wrapper does),
    ``backend="torch"`` with the plain version everywhere."""

    def __init__(self, plan: TreePlan, *, loss: Loss, backend: str = "cuda",
                 device="cuda"):
        super().__init__()
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; use {BACKENDS}")
        self.plan, self.loss, self.backend = plan, loss, backend
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
        buf("hmask", np.arange(h_max)[None, :] < plan.leaf_h[:, None],
            torch.float32)
        buf("ascale", plan.alpha_scale, torch.float32)
        buf("wcoef", plan.w_coeff, torch.float32)
        buf("gids", plan.group_ids, torch.int64)
        buf("cids", plan.child_ids, torch.int64)
        buf("csize", plan.child_sizes, torch.float32)
        buf("solve_mask", plan.solve_mask, torch.float32)
        buf("sync_mask", plan.sync_mask, torch.float32)
        buf("refresh_mask", plan.refresh_mask, torch.float32)
        # leaves grouped by H capacity: each group draws its exact randint
        # shape (the legacy draw has no prefix property)
        self.h_groups = []
        for h in sorted({int(v) for v in plan.leaf_h}):
            rows = np.nonzero(plan.leaf_h == h)[0]
            self.h_groups.append((
                h, torch.as_tensor(rows, device=dev),
                torch.as_tensor(sizes[rows], dtype=torch.int64, device=dev)))
        member = plan.sync_mask.max(axis=0) > 0                  # (D, n)
        self.groups = [_Segments(plan.group_ids[dd], member[dd],
                                 plan.n_groups[dd]) for dd in range(D)]
        self.children = [_Segments(plan.child_ids[dd], member[dd],
                                   plan.n_children[dd]) for dd in range(D)]
        # host-side tick structure: which ticks solve, which depths sync
        self.solves = plan.solve_mask.max(axis=1) > 0            # (S,)
        self.events = plan.sync_mask.max(axis=2) > 0             # (S, D)
        # edge compression: per compressed depth, its residual slot and
        # its leaves grouped by (kind, frac), so each roundtrip is one
        # call over a row block (a row = one edge's message: all leaves
        # of a child subtree carry the child's delta)
        self.res_slot = {}
        self.comp_groups = {}
        if plan.has_compression:
            for dd in range(D):
                kinds = plan.compress_kind[dd]
                if not (kinds != comp_mod.KIND_NONE).any():
                    continue
                self.res_slot[dd] = len(self.res_slot)
                groups = {}
                for li in np.nonzero(kinds != comp_mod.KIND_NONE)[0]:
                    key = (int(kinds[li]), float(plan.compress_frac[dd, li]))
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
        """The tick's (n, h_max) coordinate draws: ``randint(key_l,
        (H_l,), 0, m_b_l)`` per leaf, exactly as the legacy recursion."""
        if len(self.h_groups) == 1:
            h, _, mb = self.h_groups[0]
            return prng.randint(keys_s, (h,), 0, mb)
        idx = torch.zeros((self.plan.n_leaves, self.plan.h_max),
                          dtype=torch.int32, device=keys_s.device)
        for h, rows, mb in self.h_groups:
            idx[rows, :h] = prng.randint(keys_s[rows], (h,), 0, mb)
        return idx

    def leaf_solve(self, data: BlockedData, a, w, xsq, idx, mk, lm):
        if self.backend == "cuda":
            return sdca_kernel.sdca_block_launch(
                data.Xb, data.yb, a, w, xsq, idx, loss=self.loss, lm=lm,
                step_mask=mk)
        return sdca_steps_ref(data.Xb, data.yb, a, w, xsq, idx,
                              loss=self.loss, lm=lm, step_mask=mk)

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
    def init(self, X: Tensor, alpha0: Tensor, w0: Tensor) -> ExecState:
        """The blocked run-start state from flat (alpha0 (m,), w0 (d,)) in
        the dtype of ``X`` (the flat (m, d) data or its blocked layout):
        snapshots and group servers at the start state, zero residuals."""
        n, m_b, D = self.plan.n_leaves, self.plan.m_b, self.plan.depth
        d = X.shape[-1]
        a = torch.zeros(n * m_b, dtype=X.dtype, device=alpha0.device)
        a[self.flat_map] = alpha0.to(X.dtype)
        a = a.view(n, m_b)
        w = w0.to(X.dtype).expand(n, d).contiguous()
        res = tuple(torch.zeros((n, d), dtype=torch.float32,
                                device=w.device) for _ in self.res_slot)
        return ExecState(a, w, (a,) * D, (w,) * D, (w,) * D, res)

    def finalize(self, state: ExecState) -> Tuple[Tensor, Tensor]:
        """The flat (alpha (m,), w (d,)) of a state at a root-round
        boundary (where every leaf's w is the root's)."""
        return state.a.reshape(-1)[self.flat_map], state.w[0]

    def step(self, data: BlockedData, keys: Tensor, state: ExecState,
             participation: Tensor, steps: Tensor, lm: float) -> ExecState:
        """One pass over the plan's S ticks from ``state``; ``keys`` is the
        (S, n, 2) per-solve key plan, ``lm`` the float32 lambda*m
        (:func:`regularizer_scale`)."""
        plan = self.plan
        D = plan.depth
        xsq = data.sqnorm / lm
        a, w = state.a, state.w
        snapA, snapW, srvW = list(state.snapA), list(state.snapW), \
            list(state.srvW)
        res = list(state.res)
        one = torch.ones((), dtype=w.dtype, device=w.device)
        for s in range(plan.n_ticks):
            if self.solves[s]:
                idx = self.draw_idx(keys[s])
                # the static per-leaf H gate x the solve slot x the runtime
                # step mask; all-ones steps multiply by exactly 1.0
                mk = self.hmask * self.solve_mask[s][:, None] * steps[s]
                da, dw = self.leaf_solve(data, a, w, xsq, idx, mk, lm)
                a = a + da
                w = w + dw
            if not self.events[s].any():
                continue
            part = participation[s]
            act_of: List[Optional[Tensor]] = [None] * D
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
                denom = denom_g[gid]
                act = (ev > 0) & (present_g > 0)[gid]         # group live
                eb = (e > 0)[:, None]                         # leaf attends
                base_a = (snapA[dd] + (self.ascale[dd] / denom)[:, None]
                          * (a - snapA[dd]))
                a = torch.where(eb, base_a, a)
                # a partially present child is represented by its surviving
                # leaves: their weights scale by |child| / |present|
                cnt_c = self.children[dd].sum(e)
                corr = self.csize[dd] / torch.clamp(cnt_c, min=1.0)[
                    self.cids[dd]]
                delta_w = w - snapW[dd]
                ri = self.res_slot.get(dd)
                if ri is not None:
                    # error feedback: the message is delta + residual; the
                    # residual advances only for leaves that deliver now
                    target = delta_w.float() + res[ri]
                    approx = self.roundtrip(dd, target)
                    res[ri] = torch.where(eb, target - approx, res[ri])
                    delta_w = torch.where(getattr(self, f"comp_mask{dd}"),
                                          approx.to(w.dtype), delta_w)
                contrib = (((wc * e) / denom) * corr)[:, None] * delta_w
                srv_new = srvW[dd] + seg.sum(contrib)[gid]
                srvW[dd] = torch.where(act[:, None], srv_new, srvW[dd])
                w = torch.where(eb, srv_new, w)
                act_of[dd] = act
            # deeper servers restart from the shallowest live sync's result
            for dd in range(D - 1, -1, -1):
                if act_of[dd] is None:
                    continue
                for d2 in range(dd + 1, D):
                    srvW[d2] = torch.where(act_of[dd][:, None], srvW[dd],
                                           srvW[d2])
            # snapshot refresh for participants; depths above a leaf's
            # shallowest attended sync fast-forward to the server state
            refb = (self.refresh_mask[s] * part[None, :]) > 0     # (D, n)
            attended = (self.sync_mask[s].amax(dim=0) * part) > 0
            for dd in range(D):
                r = refb[dd][:, None]
                ffwd = (~refb[dd] & attended)[:, None]
                snapA[dd] = torch.where(r, a, snapA[dd])
                snapW[dd] = torch.where(
                    r, w, torch.where(ffwd, srvW[dd], snapW[dd]))
        return ExecState(a, w, tuple(snapA), tuple(snapW), tuple(srvW),
                         tuple(res))

    def forward(self, data: BlockedData, keys: Tensor, alpha0: Tensor,
                w0: Tensor, participation: Tensor, steps: Tensor,
                lm: float) -> Tuple[Tensor, Tensor]:
        """One pass over the plan's S ticks from flat (alpha0 (m,), w0
        (d,)): ``finalize(step(init(...)))``.  Returns the flat (alpha
        (m,), w (d,))."""
        state = self.init(data.Xb, alpha0, w0)
        return self.finalize(self.step(data, keys, state, participation,
                                       steps, lm))


def get_host_executor(plan: TreePlan, *, loss: Loss, backend: str = "cuda",
                      device="cuda", carry_state: bool = False,
                      batched: bool = False,
                      accelerated: bool = False) -> HostExecutor:
    """Build the executor for ``plan`` on ``device`` (see
    :class:`HostExecutor`).  Every executor carries state: ``init(X,
    alpha0, w0) -> state``, ``step(data, keys, state, participation,
    steps, lm) -> state`` and ``finalize(state) -> (alpha, w)`` are its
    methods, so ``carry_state`` (the reference's flag for that triple) is
    accepted only for parity with the reference's signature and changes
    nothing."""
    del carry_state
    if batched:
        raise NotImplementedError(
            "batched executors (a leading config axis) serve api/sweep.py, "
            "which is not ported yet (ROADMAP A5)")
    if accelerated:
        raise NotImplementedError(
            "accelerated executors need the sdca_acc method of "
            "core/engine/method.py, which is not ported yet (ROADMAP A5)")
    return HostExecutor(plan, loss=loss, backend=backend, device=device)


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
