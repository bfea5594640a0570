"""Sweeps: a declarative config grid over (lambda, seed, schedule,
local-H) axes, run as batched executors.

The paper's experiments (Figs. 3-5) and its eq. (11)-(12) analysis are
grids -- over regularization, H and delay regimes.  A :class:`Sweep`
names the axes once; :meth:`Session.sweep` (or the one-shot
:func:`sweep`) runs every config and returns a :class:`RunSet`:

    rs = Session.compile(prob, topo).sweep(
        lams=np.logspace(-3, 0, 8), seeds=[0, 1, 2])
    rs.gaps            # (B, T) batched history
    best = rs.best()   # the member with the smallest final duality gap

How it runs:

  * lambda and the local-iteration schedule are runtime inputs of the
    executor (``lm`` and the step mask), so every lambda and every H up
    to the compiled capacity share one plan;
  * the whole (lambda x local-H x seed) batch of one schedule runs
    through the ``batched=True`` executor (``core/engine/host.py``): ONE
    ``sdca_block`` launch per solve tick for all B configs, with
    per-config state, key plans, step masks and ``lm``; compressed and
    accelerated groups carry their residuals and momentum anchors in the
    same batched state;
  * a ``local_hs`` axis needs a plan whose H capacity covers it: compile
    the session with ``Schedule(h_cap=max(hs))``;
  * a ``schedules`` axis changes the plan, so each schedule compiles its
    own session and its sub-batch fuses as above;
  * ``continuation=True`` runs one batched stage per lambda (descending)
    over the other axes: stage k+1 warm-starts from stage k's duals with
    the primal rebuilt per member (``w = X^T alpha / (lam m)``).

Every member equals the corresponding standalone ``Session.run`` bit for
bit, histories included: each member's objective is evaluated by the same
function on the same values as the single run's, and all of them reach
the host in one transfer at the end.

``checkpoint=`` makes a fleet resumable (``Sweep(resume=<dir>)``): a
``fleet.json`` spec record at the root, one stacked ``group_<i>/`` (or
``group_base/``) snapshot per fused group of a stateless plan, and
per-member ``member_<i>/`` snapshots for compressed, accelerated and
continuation groups, which then run member at a time through
``Session.run`` (their residuals and anchors do not fit a stacked (a, w)
file).  On the mesh backend (``Session.compile(backend="mesh")``) a
group runs through the batched mesh executor: on every rank, one
``sdca_block`` launch per solve tick covers the rank's leaf for all B
configs, and the syncs run config by config, so each member equals its
standalone mesh run bit for bit; fleet files are written by the first
leaf's rank.  The LM learning-rate axis (``lrs=``) belongs to the LM
sweep (``api/lm.py::LMSession.sweep``: B members on each rank, one
batched executor, one data draw a step for all of them); an SDCA sweep
refuses it.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import os
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.api.schedule import Schedule
from repro_torch.core import dual as dual_mod
from repro_torch.core import instrument
from repro_torch.core import prng
from repro_torch.core.engine import host as host_mod
from repro_torch.core.engine import plan as plan_mod
from repro_torch.core.instrument import (SolveResult, history_row,
                                         record_round, stack_histories)

Tensor = torch.Tensor

_MAXIMIZE = {"dual"}          # every other metric is minimized


@dataclasses.dataclass(frozen=True)
class SweepPoint:
    """One resolved config of a :class:`Sweep` (its position on each
    axis); ``schedule`` is an index into ``Sweep.schedules`` (``None`` =
    the session's own schedule), ``seed`` an int or a PRNG key (``None`` =
    the default key, as in ``Session.run``), ``local_h`` the runtime
    local-iteration count (scalar or per-leaf; ``None`` = the session
    schedule's own H), ``lr`` an LM sweep's learning rate."""
    index: int
    lam: float
    seed: Optional[object] = None
    schedule: Optional[int] = None
    local_h: Optional[object] = None
    lr: Optional[float] = None

    def key(self) -> Tensor:
        if self.seed is None:
            return prng.PRNGKey(0)
        if isinstance(self.seed, (int, np.integer)):
            return prng.PRNGKey(int(self.seed))
        return prng.as_key(self.seed)

    def to_dict(self) -> dict:
        seed = self.seed
        if isinstance(seed, np.integer):
            seed = int(seed)              # np.int64 is not JSON-serializable
        elif seed is not None and not isinstance(seed, int):
            seed = prng.as_key(seed).cpu().tolist()
        h = self.local_h
        if h is not None:
            h = int(h) if np.ndim(h) == 0 else \
                [int(v) for v in np.asarray(h).reshape(-1)]
        out = {"lam": float(self.lam), "seed": seed,
               "schedule": self.schedule, "local_h": h}
        if self.lr is not None:        # LM-only axis; SDCA dicts unchanged
            out["lr"] = float(self.lr)
        return out


@dataclasses.dataclass(frozen=True)
class Sweep:
    """A declarative config grid.

    * ``lams`` -- regularization values (default: the problem's lambda);
    * ``seeds`` -- RNG seeds (ints) or PRNG keys (default: the session's
      default key);
    * ``schedules`` -- ``Schedule`` objects (default: the session's);
    * ``local_hs`` -- runtime local-iteration counts (scalars or per-leaf
      sequences; default: the schedule's own H); compile the session with
      a covering ``Schedule(h_cap=...)``;
    * ``lrs`` -- learning rates, an LM sweep's axis
      (``api/lm.py::LMSession.sweep``; an SDCA sweep refuses it);
    * ``mode`` -- ``"grid"``: the cartesian product of the given axes
      (schedules outermost, then lams, then lrs, then local_hs, then
      seeds);
      ``"zip"``: elementwise (all given axes of one length);
    * ``continuation=True`` -- a warm-started regularization path over
      the lambda axis (descending), per (schedule, local_h, seed) chain;
    * ``resume=`` -- a fleet checkpoint directory a previous
      ``run_sweep(..., checkpoint=...)`` of the SAME spec wrote (checked
      against its ``fleet.json``): completed members restore, interrupted
      ones continue from their newest snapshot, untouched ones run from
      scratch -- every member bit for bit its uninterrupted run.
    """
    lams: Optional[Sequence[float]] = None
    seeds: Optional[Sequence] = None
    schedules: Optional[Sequence[Schedule]] = None
    local_hs: Optional[Sequence] = None
    lrs: Optional[Sequence[float]] = None
    mode: str = "grid"
    continuation: bool = False
    resume: Optional[Union[str, os.PathLike]] = None

    def __post_init__(self):
        if self.mode not in ("grid", "zip"):
            raise ValueError(f"mode must be 'grid' or 'zip', got "
                             f"{self.mode!r}")
        if all(ax is None for ax in (self.lams, self.seeds,
                                     self.schedules, self.local_hs,
                                     self.lrs)):
            raise ValueError("a Sweep needs at least one axis: lams=, "
                             "seeds=, schedules=, local_hs=, or lrs=")
        for name, ax in (("lams", self.lams), ("seeds", self.seeds),
                         ("schedules", self.schedules),
                         ("local_hs", self.local_hs), ("lrs", self.lrs)):
            if ax is not None and len(ax) == 0:
                raise ValueError(f"{name} must be non-empty when given")
        if self.mode == "zip":
            sizes = {len(ax) for ax in (self.schedules, self.lams,
                                        self.lrs, self.local_hs, self.seeds)
                     if ax is not None}
            if len(sizes) > 1:
                raise ValueError(
                    f"mode='zip' needs equal-length axes, got lengths "
                    f"{sorted(sizes)}")
        if self.continuation:
            if self.lams is None:
                raise ValueError("continuation=True needs a lams= axis "
                                 "to chain over")
            if self.mode != "grid":
                raise ValueError("continuation=True needs mode='grid' so "
                                 "every (schedule, seed) chain covers the "
                                 "full lambda path")

    @property
    def shape(self) -> Tuple[int, ...]:
        """Lengths of the given axes, (schedules, lams, lrs, local_hs,
        seeds) order for ``"grid"``; the common length for ``"zip"``."""
        sizes = [len(ax) for ax in (self.schedules, self.lams, self.lrs,
                                    self.local_hs, self.seeds)
                 if ax is not None]
        if self.mode == "zip":
            return (sizes[0],)
        return tuple(sizes)

    def expand(self, default_lam: float) -> List[SweepPoint]:
        """Resolve the axes into the flat config list (B points)."""
        if self.mode == "zip":
            return [
                SweepPoint(
                    index=i,
                    lam=float(self.lams[i]) if self.lams is not None
                    else float(default_lam),
                    seed=self.seeds[i] if self.seeds is not None else None,
                    schedule=i if self.schedules is not None else None,
                    local_h=(self.local_hs[i]
                             if self.local_hs is not None else None),
                    lr=(float(self.lrs[i])
                        if self.lrs is not None else None))
                for i in range(self.shape[0])
            ]
        scheds = (range(len(self.schedules))
                  if self.schedules is not None else [None])
        lams = ([float(v) for v in self.lams]
                if self.lams is not None else [float(default_lam)])
        lrs = ([float(v) for v in self.lrs]
               if self.lrs is not None else [None])
        hs = list(self.local_hs) if self.local_hs is not None else [None]
        seeds = list(self.seeds) if self.seeds is not None else [None]
        return [
            SweepPoint(index=i, lam=lam, seed=seed, schedule=si, local_h=h,
                       lr=lr)
            for i, (si, lam, lr, h, seed) in enumerate(
                itertools.product(scheds, lams, lrs, hs, seeds))
        ]


@dataclasses.dataclass
class RunSet:
    """The result of a sweep: stacked ``(B, ...)`` iterates, one batched
    history (``(B, T)`` arrays, NaN-padded where members recorded fewer
    rounds), and per-config :class:`SolveResult` views (``rs[i]``)."""
    points: List[SweepPoint]
    alphas: Tensor                            # (B, m)
    ws: Tensor                                # (B, d)
    history: Optional[Dict[str, np.ndarray]]  # {field: (B, T)} or None
    next_keys: List
    shape: Tuple[int, ...]

    def __len__(self) -> int:
        return len(self.points)

    def __iter__(self):
        return (self[i] for i in range(len(self)))

    def __getitem__(self, i: int) -> SolveResult:
        """Member ``i`` as a standalone :class:`SolveResult` view."""
        hist = [] if self.history is None else history_row(self.history, i)
        return SolveResult(alpha=self.alphas[i], w=self.ws[i],
                           history=hist, next_key=self.next_keys[i],
                           lam=self.points[i].lam)

    # ---- batched history accessors ----------------------------------
    def _field(self, name: str) -> np.ndarray:
        if self.history is None:
            raise ValueError("this sweep ran with record_history=False")
        return self.history[name]

    @property
    def times(self) -> np.ndarray:
        return self._field("time")

    @property
    def duals(self) -> np.ndarray:
        return self._field("dual")

    @property
    def primals(self) -> np.ndarray:
        return self._field("primal")

    @property
    def gaps(self) -> np.ndarray:
        return self._field("gap")

    def final(self, metric: str = "gap") -> np.ndarray:
        """Each member's last recorded value of ``metric`` (B,)."""
        series = self._field(metric)
        out = np.full((len(self),), np.nan)
        for b in range(len(self)):
            finite = np.nonzero(np.isfinite(series[b]))[0]
            if len(finite):
                out[b] = series[b, finite[-1]]
        return out

    def best_index(self, metric: str = "gap") -> int:
        """Index of the best member by final ``metric`` (gap/primal/time
        minimized, dual maximized)."""
        vals = self.final(metric)
        if not np.isfinite(vals).any():
            raise ValueError(f"no member recorded a finite {metric!r}")
        if metric in _MAXIMIZE:
            return int(np.nanargmax(vals))
        return int(np.nanargmin(vals))

    def best(self, metric: str = "gap") -> SolveResult:
        return self[self.best_index(metric)]

    def to_dict(self) -> dict:
        """JSON-serializable form: configs, final metrics, the batched
        history (NaN -> None), and the stacked iterates."""
        def _clean(arr):
            return [[None if not np.isfinite(v) else float(v) for v in row]
                    for row in np.asarray(arr)]
        out = {
            "shape": list(self.shape),
            "configs": [p.to_dict() for p in self.points],
            "alphas": self.alphas.detach().cpu().tolist(),
            "ws": self.ws.detach().cpu().tolist(),
        }
        if self.history is not None:
            out["history"] = {f: _clean(a) for f, a in self.history.items()}
            out["final_gap"] = [None if not np.isfinite(v) else float(v)
                                for v in self.final("gap")]
        return out


# ---------------------------------------------------------------------------
# execution
# ---------------------------------------------------------------------------
def _session_for(session, spec: Sweep, schedule_index):
    """The (sub)session a schedule group runs through: the caller's own
    session for ``None``, else a fresh compile of that Schedule on the
    same backend, device and mesh."""
    if schedule_index is None:
        return session
    from repro_torch.api.session import Session
    return Session.compile(session.problem, session.topology,
                           spec.schedules[schedule_index],
                           backend=session.backend, device=session.device,
                           **session.mesh_options)


def _steps_for_point(gsess, pt: SweepPoint) -> np.ndarray:
    """The (S, n, h_max) runtime step mask member ``pt`` runs: its own
    ``local_h`` on an H axis, else the schedule's runtime H, else the
    full compiled capacity."""
    plan = gsess.plan
    h = pt.local_h if pt.local_h is not None else gsess.resolved.runtime_h
    return plan_mod.full_steps(plan) if h is None else \
        plan_mod.steps_for_h(plan, h)


def _fleet_every(policy, resolved) -> int:
    """Resolve a fleet policy's ``every`` against a group's schedule."""
    every = policy.every
    if every == "auto":
        every = getattr(resolved, "ckpt_every", None)
        if every is None:
            raise ValueError(
                "CheckpointPolicy(every='auto') needs a schedule compiled "
                "with DelayModel(mtbf=..., ckpt_write=...)")
    return int(every)


def _run_group_batched(gsess, pts: List[SweepPoint], rounds, record_history,
                       history_every, fleet=None, warm=None
                       ) -> List[SolveResult]:
    """The fused path: a schedule group's (lambda x local-H x seed)
    configs through ONE batched executor -- lambda enters as the
    per-config ``lm``, the H axis as the per-config step mask, and each
    solve tick is one ``sdca_block`` launch for all of them.  ``warm`` is
    an optional stacked warm start ``(alphas (B, m), ws (B, d))`` (the
    continuation path's stage hand-off).

    ``fleet`` is ``(policy, group_dir, resuming)`` when the sweep
    checkpoints: the group snapshots its stacked ``(B, m)`` / ``(B, d)``
    iterates at root-round boundaries (ONE file per group: the members
    advance in lockstep), and a resume restores the stack, re-derives
    each member's key plan from the (checked identical) spec and
    continues the loop mid-run bit for bit.  Only stateless groups take
    this path with a fleet."""
    from repro_torch.api.session import _objective
    from repro_torch.core.engine.method import get_method
    from repro_torch.runtime.fault import _np_dtype
    prob, plan, resolved = gsess.problem, gsess.plan, gsess.resolved
    X, y, loss, dev = prob.X, prob.y, prob.loss, gsess.device
    m = prob.m
    accelerated = gsess.acceleration is not None
    T = resolved.rounds if rounds is None else int(rounds)
    every = int(history_every)
    if every < 1:
        raise ValueError(f"history_every must be >= 1, got {every}")
    chunk = resolved.chunk_tree
    K_root = len(chunk.children)
    # each member's simulated round time charges its own runtime H, as
    # its standalone run does
    dts = [resolved.round_time_for(
        pt.local_h if pt.local_h is not None else resolved.runtime_h)
        for pt in pts]
    B = len(pts)

    instrument.begin_run()
    raw_keys = [pt.key().cpu() for pt in pts]
    with instrument.span("key_plan"):
        keys_np = np.stack([plan_mod.chunked_key_plan(chunk, plan, k, T)
                            for k in raw_keys])
        keys_all = prng.as_key(keys_np).to(dev)          # (B, T, S, n, 2)
    instrument.count_h2d(keys_np, keys_all)
    with instrument.span("step_mask"):
        steps_np = np.stack([_steps_for_point(gsess, pt) for pt in pts])
        steps = torch.as_tensor(steps_np, device=dev)
    instrument.count_h2d(steps_np, steps)
    lms = [host_mod.regularizer_scale(pt.lam, m) for pt in pts]
    acc_args = (float(gsess.acceleration),) if accelerated else ()
    method = get_method("sdca_acc" if accelerated else "sdca")
    ex = method.executor(plan=plan, loss=loss, backend=gsess.backend,
                         device=dev, batched=True,
                         **gsess.executor_options())
    part_np = plan_mod.full_participation(plan)
    part = torch.as_tensor(part_np, device=dev)
    instrument.count_h2d(part_np, part)
    if warm is not None:
        a = torch.as_tensor(warm[0], dtype=X.dtype, device=dev)
        w = torch.as_tensor(warm[1], dtype=X.dtype, device=dev)
        instrument.count_h2d(warm[0], a)
        instrument.count_h2d(warm[1], w)
    else:
        a = torch.zeros((B, m), dtype=X.dtype, device=dev)
        w = torch.zeros((B, prob.d), dtype=X.dtype, device=dev)

    mgr, ck_every, t0 = None, 0, 0
    hist_prefix: List[List[dict]] = [[] for _ in pts]
    if fleet is not None:
        from repro_torch.runtime.checkpoint import CheckpointManager
        policy, gdir, resuming = fleet
        mgr = CheckpointManager(directory=str(gdir), keep=policy.keep,
                                async_save=policy.async_save)
        ck_every = _fleet_every(policy, resolved)
        if resuming and mgr.latest_step() is not None:
            meta = mgr.metadata()
            if meta.get("plan") != plan.fingerprint:
                raise ValueError(
                    "fleet group checkpoint was written under a different "
                    "plan; resume with the identical spec and session")
            if int(meta["rounds_total"]) != T:
                raise ValueError(
                    f"fleet group was launched for {meta['rounds_total']} "
                    f"rounds, this resume asks for {T}")
            dt = _np_dtype(X.dtype)
            template = {"a": np.zeros((B, m), dt),
                        "w": np.zeros((B, prob.d), dt)}
            t0, payload = mgr.restore(template)
            a = torch.as_tensor(payload["a"], device=dev)
            w = torch.as_tensor(payload["w"], device=dev)
            instrument.count_h2d(payload["a"], a)
            instrument.count_h2d(payload["w"], w)
            hist_prefix = [list(h) for h in meta.get(
                "histories", [[] for _ in pts])]

    # the objective of each member queued as device scalars, by the
    # function the single run records with, on a fresh copy of its alpha
    # (the single run's alpha is a fresh tensor too), and pulled to the
    # host once at the end
    recorded: List[tuple] = []

    def rec(t, a_batch):
        with instrument.span("record"):
            recorded.append((t, [
                _objective(a_batch[b].clone(), X, y, loss, float(pt.lam))
                for b, pt in enumerate(pts)]))

    def hists_now() -> List[List[dict]]:
        out = [list(h) for h in hist_prefix]
        if not recorded:
            return out
        with instrument.span("record"):
            instrument.count("host_syncs")
            vals = torch.stack([torch.stack([torch.stack(v) for v in row])
                                for _, row in recorded]).tolist()
            for (t_r, _), vrow in zip(recorded, vals, strict=True):
                for b, (dv, pv) in enumerate(vrow):
                    record_round(out[b], t_r, t_r * dts[b], float(dv),
                                 float(pv))
        return out

    state = ex.init(X, a, w)
    if record_history and t0 == 0:
        rec(0, a)
    for t in range(t0 + 1, T + 1):
        instrument.at_round(t)
        state = ex.step(gsess.data, keys_all[:, t - 1], state, part, steps,
                        lms, *acc_args)
        if record_history and (t % every == 0 or t == T):
            rec(t, ex.finalize(state)[0])
        if mgr is not None and (t % ck_every == 0 or t == T):
            af, wf = ex.finalize(state)
            if gsess.writer:
                mgr.save(t, {"a": af, "w": wf},
                         {"round": t, "rounds_total": T,
                          "plan": plan.fingerprint,
                          "histories": hists_now()})
    if mgr is not None:
        if gsess.writer:
            mgr.wait()
        gsess.barrier()
    a, w = ex.finalize(state)
    histories = hists_now()
    return [SolveResult(alpha=a[b], w=w[b], history=histories[b],
                        next_key=plan_mod.advance_root_key(
                            raw_keys[b], T, K_root),
                        lam=pts[b].lam)
            for b in range(B)]


def _run_group_continuation(gsess, pts: List[SweepPoint], rounds,
                            record_history, history_every
                            ) -> List[SolveResult]:
    """The fused regularization path: one batched stage per lambda value
    (descending), over the other (local-H x seed) chain axes.  Stage k+1
    warm-starts every chain from stage k's duals, with the primal rebuilt
    per member under the new lambda (``w = X^T alpha / (lam m)``) by the
    same ``w_of_alpha`` a standalone warm-started run would be handed, so
    each member equals its sequential chain bit for bit."""
    X = gsess.problem.X
    stages: Dict[float, List[SweepPoint]] = {}
    for pt in pts:
        stages.setdefault(float(pt.lam), []).append(pt)

    def chain_key(p: SweepPoint):
        return (repr(p.local_h), repr(p.seed))

    results: Dict[int, SolveResult] = {}
    prev: Optional[List[SolveResult]] = None
    for lam in sorted(stages, reverse=True):
        # grid expansion gives every lambda stage the same chain set;
        # sorting by chain key aligns stage b with its warm-start source
        spts = sorted(stages[lam], key=chain_key)
        warm = None
        if prev is not None:
            warm = (torch.stack([r.alpha for r in prev]),
                    torch.stack([dual_mod.w_of_alpha(r.alpha.clone(), X, lam)
                                 for r in prev]))
        stage_res = _run_group_batched(gsess, spts, rounds, record_history,
                                       history_every, warm=warm)
        for pt, res in zip(spts, stage_res, strict=True):
            results[pt.index] = res
        prev = stage_res
    return [results[pt.index] for pt in pts]


def _member_result(gsess, pt: SweepPoint, rounds, record_history,
                   history_every, warm, fleet) -> SolveResult:
    """One sequential member, through its own checkpoint directory
    (``member_<index>`` under the fleet root) when the fleet checkpoints:
    on resume a completed member restores, an interrupted one continues
    mid-run and an untouched one runs from scratch -- each bit for bit
    its uninterrupted run."""
    if fleet is None:
        return gsess.run(rounds, key=pt.key(), lam=pt.lam,
                         local_h=pt.local_h, warm_start=warm,
                         record_history=record_history,
                         history_every=history_every, _defer_history=True)
    policy, root, resuming = fleet
    mp = dataclasses.replace(
        policy, directory=str(Path(root) / f"member_{pt.index:04d}"))
    if resuming:
        try:
            return gsess.resume(mp, record_history=record_history,
                                history_every=history_every, lam=pt.lam,
                                local_h=pt.local_h)
        except FileNotFoundError:
            pass                      # never started: run from scratch
    return gsess.run(rounds, key=pt.key(), lam=pt.lam, local_h=pt.local_h,
                     warm_start=warm, record_history=record_history,
                     history_every=history_every, checkpoint=mp,
                     _defer_history=True)


def _run_group_sequential(gsess, pts: List[SweepPoint], rounds,
                          record_history, history_every, continuation,
                          fleet=None) -> List[SolveResult]:
    """Member at a time through ``Session.run`` (each member IS its
    standalone run): the path of checkpointed fleets whose members carry
    per-member snapshot state (continuation chains, compressed and
    accelerated carries), and the plain version the fused runners are
    held against.  Histories stay deferred inside each run and reach the
    host after the member loop."""
    from repro_torch.api.session import materialize_history
    X = gsess.problem.X
    results: Dict[int, SolveResult] = {}

    def member(pt, warm):
        return _member_result(gsess, pt, rounds, record_history,
                              history_every, warm, fleet)

    if continuation:
        # per-seed chains over the lambda path, strongest regularization
        # first; each member warm-starts from the previous one's dual
        # iterate with its own key, the primal rebuilt under the new lambda
        chains: Dict[object, List[SweepPoint]] = {}
        for pt in pts:
            chains.setdefault((repr(pt.seed), repr(pt.local_h)),
                              []).append(pt)
        for chain in chains.values():
            prev = None
            for pt in sorted(chain, key=lambda p: -p.lam):
                warm = None if prev is None else (
                    prev.alpha,
                    dual_mod.w_of_alpha(prev.alpha.clone(), X, pt.lam))
                results[pt.index] = prev = member(pt, warm)
    else:
        for pt in pts:
            results[pt.index] = member(pt, None)
    for res in results.values():
        materialize_history(res.history)
    return [results[pt.index] for pt in pts]


def _fleet_policy(checkpoint, spec: Sweep):
    """Normalize ``run_sweep``'s ``checkpoint=`` / ``Sweep.resume`` pair
    into one ``runtime/fault.py::CheckpointPolicy`` rooted at the fleet
    directory (``None`` when the sweep does not checkpoint)."""
    from repro_torch.runtime.fault import CheckpointPolicy
    if isinstance(checkpoint, (str, os.PathLike)):
        checkpoint = CheckpointPolicy(directory=str(checkpoint))
    if spec.resume is None:
        return checkpoint
    if checkpoint is not None and \
            str(checkpoint.directory) != str(spec.resume):
        raise ValueError(
            f"Sweep(resume={str(spec.resume)!r}) and checkpoint directory "
            f"{str(checkpoint.directory)!r} disagree; point both at the "
            "interrupted fleet")
    if checkpoint is None:
        checkpoint = CheckpointPolicy(directory=str(spec.resume))
    return checkpoint


def run_sweep(session, spec: Sweep, *, rounds=None, record_history=True,
              history_every=1, checkpoint=None) -> RunSet:
    """Execute ``spec`` through ``session`` (the engine behind
    ``Session.sweep``); see the module docstring for the batching rules.

    ``checkpoint`` (a directory or ``runtime/fault.py::CheckpointPolicy``)
    makes the fleet resumable: the root holds a ``fleet.json`` spec
    record, fused groups snapshot their stacked iterates under
    ``group_<i>/``, sequential members under ``member_<i>/``.  A later
    ``Sweep(resume=<dir>)`` of the identical spec (checked) continues the
    interrupted fleet with every member bit for bit its uninterrupted
    run."""
    if spec.lrs is not None:
        raise ValueError(
            "lrs= is an LM-training axis (the optimizer step size); SDCA "
            "has no learning rate -- sweep lams= instead, or compile an "
            "LM session (Problem.lm) and sweep through it")
    points = spec.expand(float(session.problem.lam))
    policy = _fleet_policy(checkpoint, spec)
    resuming = spec.resume is not None
    fleet_root = None
    if policy is not None:
        fleet_root = Path(str(policy.directory))
        fleet_root.mkdir(parents=True, exist_ok=True)
        cfg = {"points": [p.to_dict() for p in points],
               "rounds": None if rounds is None else int(rounds)}
        cfg_path = fleet_root / "fleet.json"
        if resuming and cfg_path.exists():
            old = json.loads(cfg_path.read_text())
            if old != cfg:
                raise ValueError(
                    "fleet.json mismatch: this Sweep's (points, rounds) "
                    "differ from the interrupted fleet's; resume with the "
                    "identical spec")
        elif session.writer:
            cfg_path.write_text(json.dumps(cfg))

    groups: Dict[Optional[int], List[SweepPoint]] = {}
    for pt in points:
        groups.setdefault(pt.schedule, []).append(pt)

    results: List[Optional[SolveResult]] = [None] * len(points)
    for sidx in sorted(groups, key=lambda s: (s is not None, s)):
        pts = groups[sidx]
        gsess = _session_for(session, spec, sidx)
        # a checkpointed fleet whose members carry per-member state (a
        # continuation chain, residuals or momentum anchors) runs member
        # at a time; every other group fuses
        use_state = (gsess.plan.has_compression
                     or gsess.acceleration is not None)
        fuse = policy is None or not (spec.continuation or use_state)
        gfleet = None
        if policy is not None:
            gname = f"group_{sidx}" if sidx is not None else "group_base"
            gdir = fleet_root / gname if fuse else fleet_root
            gfleet = (policy, gdir, resuming)
        if fuse and spec.continuation:
            group_res = _run_group_continuation(
                gsess, pts, rounds, record_history, history_every)
        elif fuse:
            group_res = _run_group_batched(
                gsess, pts, rounds, record_history, history_every,
                fleet=gfleet)
        else:
            group_res = _run_group_sequential(
                gsess, pts, rounds, record_history, history_every,
                spec.continuation, fleet=gfleet)
        for pt, res in zip(pts, group_res, strict=True):
            results[pt.index] = res

    history = None
    if record_history:
        history = stack_histories([r.history for r in results])
    return RunSet(
        points=points,
        alphas=torch.stack([r.alpha for r in results]),
        ws=torch.stack([r.w for r in results]),
        history=history,
        next_keys=[r.next_key for r in results],
        shape=spec.shape,
    )


def sweep(
    problem,
    topology,
    spec: Optional[Sweep] = None,
    schedule: Optional[Schedule] = None,
    *,
    backend: str = "cuda",
    device="cuda",
    lams: Optional[Sequence[float]] = None,
    seeds: Optional[Sequence] = None,
    schedules: Optional[Sequence[Schedule]] = None,
    local_hs: Optional[Sequence] = None,
    mode: str = "grid",
    continuation: bool = False,
    rounds: Optional[int] = None,
    record_history: bool = True,
    history_every: int = 1,
    checkpoint=None,
) -> RunSet:
    """One-shot convenience: ``Session.compile(...).sweep(...)``.

    ``schedule`` is the baseline schedule configs default to; a
    ``schedules`` axis (or ``spec.schedules``) overrides it per config."""
    from repro_torch.api.session import Session
    sess = Session.compile(problem, topology, schedule, backend=backend,
                           device=device)
    # Session.sweep raises if a spec AND inline axes are both given --
    # forward everything so the one-shot path validates identically
    return sess.sweep(spec, lams=lams, seeds=seeds, schedules=schedules,
                      local_hs=local_hs, mode=mode,
                      continuation=continuation,
                      rounds=rounds, record_history=record_history,
                      history_every=history_every, checkpoint=checkpoint)
