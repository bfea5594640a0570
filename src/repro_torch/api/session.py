"""The :class:`Session` object: Problem x Topology x Schedule -> executor.

``Session.compile`` lowers the topology once (the chunk plan: the full
tree with the root pinned to one round), moves the problem to ``device``,
lays it out in the executor's blocked form and builds the executor.
``Session.run`` then drives that executor once per root round:

  * any number of root rounds from one compiled plan;
  * warm restarts (``warm_start=`` a previous result or an ``(alpha, w)``
    pair) that reproduce one longer run bit for bit when continued with
    the returned ``next_key``, the history's round/time axes continuing
    where the previous run stopped;
  * streamed history (``on_round=`` fires after every recorded round).

A run threads the executor's full state (``init`` once, ``step`` per
root round, ``finalize`` where it records): compressed plans carry their
error-feedback residuals across root rounds, and for an uncompressed
plan, whose root sync refreshes every snapshot, the threaded state equals
a restart from (alpha, w), so (alpha, w, RNG chain) is a complete carry
between runs.  ``Schedule(rounds="auto")`` plans the
per-level H with the paper's eq. (12) at compile time, and
``DelayModel(C="auto")`` first fits the improvement constant from a
pilot run on the session's own backend and device.  Backends: ``"cuda"``
(the ``sdca_block`` kernel, the default) and ``"torch"`` (its plain
version).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple, Union

import torch

from repro_torch.api.problem import Problem
from repro_torch.api.schedule import ResolvedSchedule, Schedule
from repro_torch.api.topology import Topology
from repro_torch.core import dual as dual_mod
from repro_torch.core import prng
from repro_torch.core.delay import fit_C
from repro_torch.core.engine import host as host_mod
from repro_torch.core.engine import plan as plan_mod
from repro_torch.core.instrument import SolveResult, record_round

Tensor = torch.Tensor

BACKENDS = host_mod.BACKENDS


def _objective(alpha: Tensor, X: Tensor, y: Tensor, loss, lam: float):
    """(dual, primal) of ``alpha`` as host floats."""
    w = dual_mod.w_of_alpha(alpha, X, lam)
    return (float(dual_mod.dual_value(alpha, X, y, loss, lam)),
            float(dual_mod.primal_value(w, X, y, loss, lam)))


class Session:
    """A compiled (problem, topology, schedule, backend, device) binding;
    construct with :meth:`compile`."""

    def __init__(self, problem: Problem, topology: Topology,
                 resolved: ResolvedSchedule, backend: str, plan,
                 executor: host_mod.HostExecutor):
        self.problem = problem
        self.topology = topology
        self.resolved = resolved
        self.backend = backend
        self.plan = plan
        self.executor = executor
        self.device = problem.device
        self.fitted_C = None        # set when DelayModel(C="auto") calibrated
        # the problem in the executor's blocked layout (a view of X when
        # every leaf holds m_b rows)
        self.data = executor.prepare(problem.X, problem.y)

    @classmethod
    def compile(cls, problem: Problem, topology: Topology,
                schedule: Optional[Schedule] = None, *,
                backend: str = "cuda", device="cuda") -> "Session":
        """Lower ``topology`` under ``schedule`` and bind the ``backend``
        executor on ``device``.  A ``rounds="auto"`` schedule whose
        DelayModel has ``C="auto"`` first runs the calibration pilot
        (:func:`_calibrate_C`) on the same backend and device."""
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; use {BACKENDS}")
        schedule = schedule or Schedule()
        if problem.m != topology.m_total:
            raise ValueError(
                f"problem has m={problem.m} examples but the topology "
                f"assigns {topology.m_total}")
        problem = problem.to(device)
        fitted_C = None
        if (schedule.rounds == "auto" and schedule.delay is not None
                and schedule.delay.C == "auto"):
            # only rounds="auto" reads the DelayModel: an explicit-rounds
            # schedule would ignore the fitted C, so it pays no pilot
            schedule, fitted_C = _calibrate_C(problem, topology, schedule,
                                              backend)
        resolved = schedule.resolve(topology)
        plan = plan_mod.compile_tree(resolved.chunk_tree,
                                     weighting=resolved.weighting,
                                     compression=resolved.compression)
        ex = host_mod.get_host_executor(plan, loss=problem.loss,
                                        backend=backend,
                                        device=problem.device)
        sess = cls(problem, topology, resolved, backend, plan, ex)
        sess.fitted_C = fitted_C
        return sess

    @property
    def level_plan(self):
        """The eq.-(12) planner's per-level rows when the schedule was
        ``"auto"`` (else ``None``)."""
        return self.resolved.level_plan

    @property
    def bytes_per_round(self) -> float:
        """Simulated uplink bytes one root round ships under this plan's
        per-edge compression (``core/engine/plan.py::
        plan_bytes_per_round``); compare with an uncompressed session of
        the same topology for the wire saving."""
        return plan_mod.plan_bytes_per_round(
            self.plan, self.problem.d,
            dtype_bytes=self.problem.X.element_size())

    @property
    def default_rounds(self) -> int:
        return self.resolved.rounds

    # ------------------------------------------------------------------
    def run(
        self,
        rounds: Optional[int] = None,
        *,
        key=None,
        warm_start: Union[SolveResult, Tuple[Tensor, Tensor], None] = None,
        record_history: bool = True,
        history_every: int = 1,
        on_round: Optional[Callable[[dict], None]] = None,
        lam: Optional[float] = None,
        local_h=None,
    ) -> SolveResult:
        """Run ``rounds`` root rounds (default: the schedule's).

        ``warm_start`` continues from a previous state; a previous
        :class:`SolveResult` also continues its RNG chain (``next_key``)
        unless ``key`` overrides it, and its history axes.
        ``history_every=k`` records every k-th round (plus round 0 of a
        cold start and always the last).  ``lam`` overrides the problem's
        regularization for this run; a warm start from a result under
        another lambda rebuilds ``w = X^T alpha / (lam m)``.  ``local_h``
        (scalar or per-leaf) runs that many local steps through the step
        mask, clamped to the compiled capacity (``Schedule(h_cap=)``)."""
        T = self.resolved.rounds if rounds is None else int(rounds)
        if T < 0:
            raise ValueError(f"rounds must be >= 0, got {T}")
        every = int(history_every)
        if every < 1:
            raise ValueError(f"history_every must be >= 1, got {every}")
        X, y, loss = self.problem.X, self.problem.y, self.problem.loss
        lam = self.problem.lam if lam is None else float(lam)
        m, plan, dev = self.problem.m, self.plan, self.device
        lm = host_mod.regularizer_scale(lam, m)

        alpha, w, k = self._start_state(warm_start, key, lam)
        chunk_tree = self.resolved.chunk_tree
        K_root = len(chunk_tree.children)
        h_run = local_h if local_h is not None else self.resolved.runtime_h
        dt = self.resolved.round_time_for(h_run)
        t0_round, t0_time, record_initial = 0, 0.0, True
        if isinstance(warm_start, SolveResult) and warm_start.history:
            t0_round = int(warm_start.history[-1]["round"])
            t0_time = float(warm_start.history[-1]["time"])
            record_initial = False

        history: list = []
        ex = self.executor
        state = ex.init(X, alpha, w)

        def record(t: int, a_flat: Tensor):
            if not record_history:
                return
            dv, pv = _objective(a_flat, X, y, loss, lam)
            record_round(history, t0_round + t, t0_time + t * dt, dv, pv)
            if on_round is not None:
                on_round(history[-1])

        part = torch.as_tensor(plan_mod.full_participation(plan), device=dev)
        steps = plan_mod.full_steps(plan) if h_run is None else \
            plan_mod.steps_for_h(plan, h_run)
        steps = torch.as_tensor(steps, device=dev)
        # every round's keys from one walk of the equivalent monolithic
        # tree (the legacy chain), moved to the device once
        keys_all = prng.as_key(
            plan_mod.chunked_key_plan(chunk_tree, plan, k, T)).to(dev)
        if record_initial:
            record(0, alpha)
        for t in range(1, T + 1):
            state = ex.step(self.data, keys_all[t - 1], state, part, steps,
                            lm)
            if record_history and (t % every == 0 or t == T):
                record(t, ex.finalize(state)[0])
        alpha, w = ex.finalize(state)
        next_key = plan_mod.advance_root_key(k, T, K_root)
        return SolveResult(alpha=alpha, w=w, history=history,
                           next_key=next_key, lam=lam)

    # ------------------------------------------------------------------
    def _start_state(self, warm_start, key, lam_run):
        X, dev = self.problem.X, self.device
        k = None if key is None else prng.as_key(key)
        if warm_start is None:
            alpha = torch.zeros(self.problem.m, dtype=X.dtype, device=dev)
            w = torch.zeros(self.problem.d, dtype=X.dtype, device=dev)
        elif isinstance(warm_start, SolveResult):
            alpha, w = warm_start.alpha, warm_start.w
            if (warm_start.lam is not None
                    and float(warm_start.lam) != float(lam_run)):
                # the carried w satisfies w = X^T a / (lam_old m); under
                # another lambda it must be rebuilt from the dual
                w = dual_mod.w_of_alpha(
                    torch.as_tensor(alpha, device=dev), X, float(lam_run))
            if k is None and warm_start.next_key is not None:
                k = prng.as_key(warm_start.next_key)
        else:
            alpha, w = warm_start
        if k is None:
            k = prng.PRNGKey(0)
        alpha = torch.as_tensor(alpha, dtype=X.dtype, device=dev)
        w = torch.as_tensor(w, dtype=X.dtype, device=dev)
        if tuple(alpha.shape) != (self.problem.m,):
            raise ValueError(f"warm-start alpha must be ({self.problem.m},),"
                             f" got {tuple(alpha.shape)}")
        if tuple(w.shape) != (self.problem.d,):
            raise ValueError(f"warm-start w must be ({self.problem.d},), "
                             f"got {tuple(w.shape)}")
        return alpha, w, k.cpu()


def _calibrate_C(problem: Problem, topology: Topology, schedule: Schedule,
                 backend: str):
    """Resolve ``DelayModel(C="auto")``: run ``pilot_rounds`` root rounds
    under the topology's default schedule on ``backend`` and the
    problem's device, fit eq. (11)'s improvement constant from the
    observed per-root-round gap contractions (``core/delay.py::fit_C``),
    and return (the schedule with the fitted C, the fitted C)."""
    dm = schedule.delay
    pilot = Session.compile(problem, topology,
                            Schedule(weighting=schedule.weighting),
                            backend=backend, device=problem.device)
    res = pilot.run(rounds=int(dm.pilot_rounds), key=prng.PRNGKey(0))
    plan = pilot.plan
    # one root round of the pilot, seen as eq. (11)'s star round: K = the
    # root's fan-out, H = the coordinate steps one leaf runs per root
    # round, delta = one coordinate's share of a leaf block (the planner's
    # own delta when the DelayModel pins it).  The clip is the smallest
    # group size over the sync levels: the planner checks the same C
    # against every level's K.
    K = len(topology.tree.children)
    h_eff = int(plan.solve_mask[:, 0].sum()) * int(plan.leaf_h[0])
    delta = (dm.delta if dm.delta is not None
             else 1.0 / max(int(plan.leaf_sizes[0]), 1))
    c_max = min(lvl.group_size for lvl in topology.sync_levels())
    C = fit_C(res.history, K=K, H=h_eff, delta=delta, c_max=c_max)
    return dataclasses.replace(
        schedule, delay=dataclasses.replace(dm, C=C)), C


def solve(
    problem: Problem,
    topology: Topology,
    schedule: Optional[Schedule] = None,
    *,
    backend: str = "cuda",
    device="cuda",
    key=None,
    rounds: Optional[int] = None,
    warm_start: Union[SolveResult, Tuple[Tensor, Tensor], None] = None,
    record_history: bool = True,
    history_every: int = 1,
    on_round: Optional[Callable[[dict], None]] = None,
    lam: Optional[float] = None,
    local_h=None,
) -> SolveResult:
    """One-shot convenience: ``Session.compile(...).run(...)`` with the
    whole ``run`` surface of this package."""
    sess = Session.compile(problem, topology, schedule, backend=backend,
                           device=device)
    return sess.run(rounds, key=key, warm_start=warm_start,
                    record_history=record_history,
                    history_every=history_every, on_round=on_round,
                    lam=lam, local_h=local_h)
