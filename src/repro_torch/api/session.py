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
  * streamed history (``on_round=`` fires after every recorded round);
  * straggler-adaptive async execution (``straggler=`` a
    ``runtime/straggler.py::StragglerPolicy``): per chunk, sampled per-leaf
    link delays decide which leaves the barrier drops; dropped leaves keep
    solving on stale snapshots and re-join later (participation masks),
    and the history records the simulated async wall-clock next to the
    synchronous one;
  * server momentum (``Schedule(acceleration=)``, the ``sdca_acc``
    method; ``run(acceleration=)`` overrides the coefficient per run);
  * sweeps (:meth:`Session.sweep`, ``api/sweep.py``): a lambda x seed x
    local-H grid through one batched executor, one kernel launch per
    solve tick for every config;
  * checkpoints (``checkpoint=`` a ``runtime/fault.py::CheckpointPolicy``
    or a directory) and :meth:`Session.resume`, which continues a
    checkpointed solve bit for bit, from this package's files or the JAX
    package's.

A run threads the executor's full state (``init`` once, ``step`` per
root round, ``finalize`` where it records): compressed plans carry their
error-feedback residuals across root rounds, accelerated ones their
momentum anchors, straggler runs their absent leaves' stale replicas; for
an uncompressed plan, whose root sync refreshes every snapshot, the
threaded state equals a restart from (alpha, w), so (alpha, w, RNG chain)
is a complete carry between runs.  ``Schedule(rounds="auto")`` plans the
per-level H with the paper's eq. (12) at compile time, and
``DelayModel(C="auto")`` first fits the improvement constant from a
pilot run on the session's own backend and device.  Every compiled plan
passes the plan verifier (``analysis/plan_check.py::verify_plan``) before
an executor is built against it.  Backends: ``"cuda"``
(the ``sdca_block`` kernel, the default), ``"torch"`` (its plain
version) and ``"mesh"`` (``core/engine/mesh.py``: one ``torch.distributed``
rank per leaf, every rank making the same ``compile`` / ``run`` calls on
the same global problem; see :meth:`Session.compile`).  History values
are recorded as device scalars and pulled to the host in one transfer
(:func:`materialize_history`) at stream points and at the end of a run.
"""
from __future__ import annotations

import dataclasses
import contextlib
import math
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.analysis import plan_check
from repro_torch.analysis import trace_guard as guard_mod
from repro_torch.api.problem import Problem
from repro_torch.api.schedule import (ResolvedSchedule, Schedule,
                                      leaf_h_spec, runtime_tree)
from repro_torch.api.topology import Topology
from repro_torch.core import dual as dual_mod
from repro_torch.core import instrument
from repro_torch.core import prng
from repro_torch.core import tree as tree_mod
from repro_torch.core.delay import fit_C
from repro_torch.core.engine import host as host_mod
from repro_torch.core.engine import mesh as mesh_mod
from repro_torch.core.engine import plan as plan_mod
from repro_torch.core.engine.method import get_method
from repro_torch.core.instrument import SolveResult, record_round

Tensor = torch.Tensor

BACKENDS = host_mod.BACKENDS + ("mesh",)

# the DeviceMesh each (device type, fan-outs) builds when compile gets no
# mesh: init_device_mesh creates process groups, so it runs once
_DEFAULT_MESHES: Dict[tuple, object] = {}


def _objective(alpha: Tensor, X: Tensor, y: Tensor, loss, lam: float):
    """(dual, primal) of ``alpha`` as device scalars (no host sync)."""
    w = dual_mod.w_of_alpha(alpha, X, lam)
    return (dual_mod.dual_value(alpha, X, y, loss, lam),
            dual_mod.primal_value(w, X, y, loss, lam))


def materialize_history(history) -> None:
    """Pull a deferred history's objective values to the host in ONE
    transfer: ``Session.run`` records device scalars and calls this at
    stream points and at the end of a run; the sweep layer defers further
    and materializes every member's history together."""
    pending = [e for e in history if not isinstance(e["dual"], float)]
    if not pending:
        return
    instrument.count("host_syncs")
    vals = torch.stack([torch.stack([e["dual"], e["primal"]])
                        for e in pending]).tolist()
    for e, (dv, pv) in zip(pending, vals, strict=True):
        # the gap as a host float64 subtraction, as record_round takes it
        e["dual"], e["primal"] = float(dv), float(pv)
        e["gap"] = e["primal"] - e["dual"]


class Session:
    """A compiled (problem, topology, schedule, backend, device) binding;
    construct with :meth:`compile`."""

    def __init__(self, problem: Problem, topology: Topology,
                 resolved: ResolvedSchedule, backend: str, plan,
                 executor: host_mod.HostExecutor,
                 acceleration: Optional[float] = None,
                 mesh_options: Optional[dict] = None):
        self.problem = problem
        self.topology = topology
        self.resolved = resolved
        self.backend = backend
        self.plan = plan
        self.executor = executor
        self.device = problem.device
        self.fitted_C = None        # set when DelayModel(C="auto") calibrated
        # None = the plain "sdca" method; a float (0.0 included) = the
        # "sdca_acc" method with this default momentum coefficient
        self.acceleration = acceleration
        # the mesh keywords of compile this session was bound with: mesh,
        # mesh_axes, mesh_use_kernel, mesh_sync (empty off the mesh)
        self.mesh_options = dict(mesh_options or {})
        # the problem in the executor's blocked layout (a view of X when
        # every leaf holds m_b rows; on the mesh, this rank's block)
        self.data = executor.prepare(problem.X, problem.y)
        self._guard = None          # TraceGuard when compiled strict

    def executor_options(self) -> dict:
        """The mesh keywords of ``Method.executor`` (empty off the mesh)."""
        return _executor_kw(self.mesh_options)

    def _fetch_executor(self):
        """This session's executor from the cache (built on a miss)."""
        return _method_executor(self.problem, self.plan, self.backend,
                                self.acceleration, self.mesh_options)

    @staticmethod
    def cache_stats() -> dict:
        """Executor-cache counters of the engine: ``{hits, misses, size}``
        over the host, mesh and LM caches, and ``by_backend`` columns
        (``core/engine/host.py::executor_cache_stats``)."""
        return host_mod.executor_cache_stats()

    @property
    def writer(self) -> bool:
        """Whether this process writes the files a run saves: always off
        the mesh, the first leaf's rank on it."""
        return getattr(self.executor, "writer", True)

    def barrier(self) -> None:
        """Wait for every rank of the mesh (nothing off the mesh)."""
        if self.backend == "mesh":
            self.executor.barrier()

    @classmethod
    def compile(cls, problem: Problem, topology: Topology,
                schedule: Optional[Schedule] = None, *,
                backend: str = "cuda", device="cuda", mesh=None,
                mesh_axes: Optional[Sequence[str]] = None,
                mesh_use_kernel: bool = True,
                mesh_sync: str = "psum", strict=False) -> "Session":
        """Lower ``topology`` under ``schedule`` and bind the ``backend``
        executor on ``device``.  A ``rounds="auto"`` schedule whose
        DelayModel has ``C="auto"`` first runs the calibration pilot
        (:func:`_calibrate_C`) on the same backend and device;
        ``Schedule(acceleration=)`` binds the accelerated executor.  The
        plan verifier (``analysis/plan_check.py::verify_plan``) runs on
        every compiled plan and raises ``AnalysisError`` on a malformed
        one.

        ``backend="mesh"`` runs the plan with one ``torch.distributed``
        rank per leaf (``core/engine/mesh.py``), under a process group
        every rank has initialized; each rank makes the same calls with
        the same global problem and keeps its own block.  ``mesh`` is a
        ``DeviceMesh`` with ``mesh_axes`` its axes innermost (leaf level)
        first; without one, a mesh ``lvl0, lvl1, ...`` of the plan's
        per-depth fan-outs is built over the world, whose size must be
        their product.  ``mesh_use_kernel`` picks the ``sdca_block``
        kernel or its plain version at the leaves, ``mesh_sync`` the sync
        lowering: ``"psum"`` (replicated servers, the host backend bit for
        bit) or ``"reduce_scatter"`` (each depth's server sharded over its
        group; full participation only).

        An :class:`~repro_torch.api.problem.LMProblem` (``Problem.lm``)
        compiles to an :class:`~repro_torch.api.lm.LMSession` (mesh
        backend only; ``mesh`` a ``DeviceMesh`` with the sync axes, or
        ``make_host_mesh()``).  ``strict`` (bool or a
        ``analysis.TraceGuard``) turns on strict mode: host syncs inside
        an executor step raise (``torch.cuda.set_sync_debug_mode``), and
        with ``sanitize`` the state is checked for NaN/Inf every round."""
        if getattr(problem, "method", "sdca") not in ("sdca", None):
            from repro_torch.api.lm import LMSession
            return LMSession.compile(problem, topology, schedule,
                                     backend=backend, mesh=mesh,
                                     strict=strict, device=device)
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
            schedule, fitted_C = _calibrate_C(
                problem, topology, schedule, backend,
                dict(mesh=mesh, mesh_axes=mesh_axes,
                     mesh_use_kernel=mesh_use_kernel, mesh_sync=mesh_sync))
        resolved = schedule.resolve(topology)
        acceleration = schedule.acceleration
        plan = plan_mod.compile_tree(resolved.chunk_tree,
                                     weighting=resolved.weighting,
                                     compression=resolved.compression)
        # geometry, schedule coherence, aggregation convexity, compression
        # specs, RNG schedule independence and fingerprint soundness,
        # checked before an executor is built against the plan
        plan_check.verify_plan(plan)
        mesh_kw: dict = {}
        if backend == "mesh":
            mesh, mesh_axes = _bind_mesh(plan, resolved, mesh, mesh_axes,
                                         mesh_sync, problem.device)
            mesh_kw = dict(mesh=mesh, mesh_axes=mesh_axes,
                           mesh_use_kernel=mesh_use_kernel,
                           mesh_sync=mesh_sync)
        ex = _method_executor(problem, plan, backend, acceleration, mesh_kw)
        sess = cls(problem, topology, resolved, backend, plan, ex,
                   acceleration=acceleration, mesh_options=mesh_kw)
        sess.fitted_C = fitted_C
        sess._guard = guard_mod.as_trace_guard(strict)
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
        straggler=None,
        lam: Optional[float] = None,
        local_h=None,
        acceleration: Optional[float] = None,
        checkpoint=None,
        _ef_state=None,
        _history_prefix=(),
        _final_save: bool = True,
        _defer_history: bool = False,
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
        mask, clamped to the compiled capacity (``Schedule(h_cap=)``).

        ``straggler`` (a ``runtime/straggler.py::StragglerPolicy``)
        switches the run to straggler-adaptive async execution: each
        chunk, the policy samples per-leaf sync delays around the
        topology's nominal ones and drops straggling leaves from the
        barrier (bounded consecutive skips; dropped leaves keep solving on
        stale snapshots and re-join with renormalized weights).  The
        history's ``time`` accrues the simulated async wall-clock, with
        the synchronous one in ``time_sync`` and the participant count in
        ``participants``; the final chunk runs a full barrier, so the
        returned iterates satisfy ``w = A alpha``, and an
        always-participate policy gives the synchronous run bit for bit.
        An ``adaptive=AdaptiveSchedule`` policy's replanned H feeds the
        NEXT chunk's step mask (clamped to the compiled capacity), each
        chunk's H recorded as ``"h"``.

        ``checkpoint`` (a directory or a ``runtime/fault.py::
        CheckpointPolicy``) snapshots the carry every ``policy.every``
        root rounds on the global round cursor, and always the final
        round: flat (alpha, w), the advanced root RNG key, any
        error-feedback residuals, and the metadata (plan fingerprint,
        round and time cursors, lambda, local_h, the recorded history)
        with which :meth:`resume` continues the run bit for bit.  The
        snapshot is cloned on the device and written one period later
        (or at the end of the run), so the host transfer does not stall
        the rounds in between.  Checkpoints compose with compression but
        not with ``straggler=`` (absent leaves' divergent replicas are not
        in the flat payload).

        ``acceleration`` overrides the momentum coefficient for this run
        (sessions compiled with ``Schedule(acceleration=...)`` only; a
        value in [0, 1], 0 giving plain SDCA bit for bit); accelerated
        runs do not compose with ``straggler=`` or ``checkpoint=``.
        ``_ef_state`` / ``_history_prefix`` / ``_final_save`` are
        :meth:`resume`'s restore hooks; ``_defer_history`` leaves the
        recorded objective values as device scalars for the caller to
        pull in one batch (:func:`materialize_history`; the sweep layer's
        path)."""
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

        accelerated = self.acceleration is not None
        if acceleration is not None and not accelerated:
            raise ValueError(
                "this session runs the plain 'sdca' method; compile with "
                "Schedule(acceleration=...) to bind the accelerated "
                "executors (the coefficient itself is then a runtime "
                "operand)")
        acc_run = self.acceleration if acceleration is None \
            else float(acceleration)
        if accelerated and not 0.0 <= float(acc_run) <= 1.0:
            raise ValueError(
                f"acceleration must be in [0, 1], got {acc_run}")
        if accelerated and straggler is not None:
            raise ValueError(
                "acceleration does not compose with straggler=: a skipped "
                "sync leaves the momentum anchors extrapolating against "
                "stale combination states, which breaks the paired "
                "primal-dual consistency; run accelerated sessions "
                "synchronously")
        if accelerated and checkpoint is not None:
            raise ValueError(
                "acceleration does not compose with checkpoint=: the "
                "per-depth momentum anchors are part of the chunk carry "
                "but not of the flat (alpha, w, residuals) snapshot "
                "payload, so a resumed run would diverge")
        ckpt_mgr, ck_every, ckpt_pending, k_lag = None, 0, None, 0
        if checkpoint is not None:
            if straggler is not None:
                raise ValueError(
                    "checkpoint= does not compose with straggler=: a "
                    "mid-run blocked state under skipped syncs holds "
                    "divergent per-leaf replicas and stale snapshots the "
                    "flat chunk-carry payload cannot represent; checkpoint "
                    "synchronous (or compressed) runs only")
            from repro_torch.runtime import fault as fault_mod
            _, ckpt_mgr, ck_every = fault_mod.bind_policy(
                checkpoint, self.resolved)
            h_meta = None if local_h is None else \
                np.asarray(local_h).tolist()
        if (straggler is not None
                and self.mesh_options.get("mesh_sync") == "reduce_scatter"):
            raise ValueError(
                "mesh_sync='reduce_scatter' assumes full participation "
                "(the sharded-server sync has no per-leaf gating); use "
                "mesh_sync='psum' for straggler-adaptive runs")
        acc_args = (float(acc_run),) if accelerated else ()

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
        if straggler is not None:
            t_compute = tree_mod.strip_delays(
                runtime_tree(chunk_tree, h_run)).solve_time()
            t_lp = max(leaf.t_lp for leaf in chunk_tree.leaves())
            straggler.bind(self.topology.leaf_sync_delays(), t_compute,
                           t_lp=t_lp)

        guard = self._guard
        if guard is not None and guard.error_on_retrace:
            # strict revalidation: the executor this session bound at
            # compile time must still be in its cache -- the re-fetch has
            # a zero miss budget, so an eviction or a key that drifted
            # mid-session raises here
            with guard.retrace_region(0):
                self._fetch_executor()
        history: list = []
        clock = {"async": t0_time, "sync": t0_time}
        ex = self.executor
        state = ex.init(X, alpha, w)
        if _ef_state:
            # the restore path: the checkpointed error-feedback residuals,
            # the one part of the state that does not collapse into
            # (alpha, w) at a root-round boundary
            from repro_torch.runtime import fault as fault_mod
            state = fault_mod.with_ef_residuals(self, state, _ef_state)
        k_cur = k

        def record(t: int, a_flat: Tensor, extra: Optional[dict] = None):
            if not record_history:
                return
            with instrument.span("record"):
                dv, pv = _objective(a_flat, X, y, loss, lam)
                time = clock["async"] if straggler is not None else \
                    t0_time + t * dt
                record_round(history, t0_round + t, time, dv, pv)
                if extra:
                    history[-1].update(extra)
                if on_round is not None:
                    materialize_history(history)   # streaming needs floats
            if on_round is not None:
                on_round(history[-1])

        instrument.begin_run()
        part_np = plan_mod.full_participation(plan)
        part_ones = torch.as_tensor(part_np, device=dev)
        instrument.count_h2d(part_np, part_ones)

        def steps_dev(h):
            with instrument.span("step_mask"):
                arr = plan_mod.full_steps(plan) if h is None else \
                    plan_mod.steps_for_h(plan, h)
                out = torch.as_tensor(arr, device=dev)
            instrument.count_h2d(arr, out)
            return out

        def h_effective(h):
            """Per-leaf step counts a chunk actually runs (clamped to the
            compiled capacity, per-slot specs reduced to their max)."""
            if h is None:
                return plan.leaf_h.astype(np.int64)
            return np.minimum(leaf_h_spec(h, plan.n_leaves), plan.leaf_h)

        steps_now = steps_dev(h_run)
        h_eff_now = h_effective(h_run)
        h_now = int(h_eff_now.max())
        adaptive = straggler is not None and \
            getattr(straggler, "adaptive", None) is not None
        next_h = None
        # every round's keys from one walk of the equivalent monolithic
        # tree (the legacy chain), moved to the device once
        with instrument.span("key_plan"):
            keys_np = plan_mod.chunked_key_plan(chunk_tree, plan, k, T)
            keys_all = prng.as_key(keys_np).to(dev)
        instrument.count_h2d(keys_np, keys_all)
        if record_initial:
            record(0, alpha)
        for t in range(1, T + 1):
            instrument.at_round(t)
            prt, extra = part_ones, None
            # the last chunk's adaptive H suggestion feeds this chunk (a new
            # step mask only), compared on the effective per-leaf counts,
            # and the policy's compute clock is retimed to it
            if next_h is not None:
                eff_next = h_effective(next_h)
                if not np.array_equal(eff_next, h_eff_now):
                    h_eff_now = eff_next
                    h_now = int(eff_next.max())
                    steps_now = steps_dev(next_h)
                    straggler.retime(tree_mod.strip_delays(
                        runtime_tree(chunk_tree, next_h)).solve_time())
                next_h = None
            if straggler is not None:
                st = straggler.step(final=(t == T))
                part_np = plan_mod.chunk_participation(plan, st.mask)
                prt = torch.as_tensor(part_np, device=dev)
                instrument.count_h2d(part_np, prt)
                clock["async"] += st.dt_async
                clock["sync"] += st.dt_sync
                extra = {"time_sync": clock["sync"],
                         "participants": int(st.mask.sum())}
                if adaptive:
                    extra["h"] = h_now
                    if st.h_suggest is not None:
                        next_h = int(min(max(st.h_suggest, 1), plan.h_max))
            # strict mode: no host sync inside a step after the first (the
            # first builds the kernels)
            guard = self._guard
            with (guard.dispatch_region() if guard is not None and t > 1
                  else contextlib.nullcontext()):
                state = ex.step(self.data, keys_all[t - 1], state, prt,
                                steps_now, lm, *acc_args)
            if guard is not None and guard.sanitize:
                guard.check_carry(state, f"state@round{t}")
            if record_history and (t % every == 0 or t == T):
                record(t, ex.finalize(state)[0], extra)
            if ckpt_mgr is None:
                continue
            k_lag += 1
            # period alignment is on the GLOBAL round cursor, so a resumed
            # leg snapshots at the rounds the uninterrupted run would
            if (t0_round + t) % ck_every == 0 or (t == T and _final_save):
                # the RNG chain advances lazily, once per snapshot
                k_cur = plan_mod.advance_root_key(k_cur, k_lag, K_root)
                k_lag = 0
                af, wf = ex.finalize(state)
                # cloned on the device: the payload outlives this state
                # (the write lags one period) and finalize may give views
                payload = {
                    "alpha": af.clone(), "w": wf.clone(),
                    "key": k_cur.numpy().astype(np.uint32),
                    "res": [r.clone()
                            for r in fault_mod.ef_residuals(self, state)],
                }
                materialize_history(history)       # the metadata is JSON
                meta = {
                    "version": fault_mod.PAYLOAD_VERSION,
                    "round": t0_round + t,
                    "sim_time": t0_time + t * dt,
                    "rounds_total": t0_round + T,
                    "lam": float(lam),
                    "m": int(m), "d": int(self.problem.d),
                    "plan": plan.fingerprint,
                    "local_h": h_meta,
                    "history": list(_history_prefix) + history,
                }
                # the previous snapshot reaches the host now, a period
                # after it was taken (on the mesh, every rank gathers it
                # and the first leaf's rank writes it)
                if ckpt_pending is not None and self.writer:
                    ckpt_mgr.save(*ckpt_pending)
                ckpt_pending = (t0_round + t, payload, meta)
        if ckpt_mgr is not None:
            if self.writer:
                if ckpt_pending is not None:
                    ckpt_mgr.save(*ckpt_pending)
                ckpt_mgr.wait()   # surface async-save failures before exit
            # no rank returns (and may resume) before the files are out
            self.barrier()
        alpha, w = ex.finalize(state)
        next_key = plan_mod.advance_root_key(k, T, K_root)
        if not _defer_history:
            materialize_history(history)
        return SolveResult(alpha=alpha, w=w, history=history,
                           next_key=next_key, lam=lam)

    # ------------------------------------------------------------------
    def resume(
        self,
        checkpoint,
        *,
        rounds: Optional[int] = None,
        record_history: bool = True,
        history_every: int = 1,
        on_round: Optional[Callable[[dict], None]] = None,
        lam: Optional[float] = None,
        local_h=None,
        _final_save: bool = True,
    ) -> SolveResult:
        """Restart a checkpointed solve from its newest complete snapshot,
        bit for bit as the uninterrupted run.

        ``checkpoint`` is the directory (or ``runtime/fault.py::
        CheckpointPolicy``) a previous ``run(checkpoint=...)`` wrote, in
        this package or the JAX package (the formats are one).  The plan
        fingerprint and (m, d) are checked against this session's.  Runs
        the remaining rounds (``rounds_total - step``, or ``rounds=``),
        keeps checkpointing into the same directory, and returns a result
        whose history is the whole series from round 0.  ``lam`` /
        ``local_h`` default to the values recorded at save time."""
        from repro_torch.runtime import fault as fault_mod
        policy, mgr, _ = fault_mod.bind_policy(checkpoint, self.resolved)
        step = mgr.latest_step()
        if step is None:
            raise FileNotFoundError(
                f"no complete checkpoints under {policy.directory!r}")
        meta = mgr.metadata(step)
        if meta.get("plan") != self.plan.fingerprint:
            raise ValueError(
                "checkpoint was written under a different plan "
                "(topology/schedule/weighting/compression changed between "
                "save and resume); compile a matching session")
        m, d = self.problem.m, self.problem.d
        if int(meta["m"]) != m or int(meta["d"]) != d:
            raise ValueError(
                f"checkpoint is for an (m={meta['m']}, d={meta['d']}) "
                f"problem; this session has (m={m}, d={d})")
        template = fault_mod.payload_template(
            self.plan, m, d, self.problem.X.dtype)
        step, payload = mgr.restore(template, step)
        remaining = int(meta["rounds_total"]) - step if rounds is None \
            else int(rounds)
        if remaining < 0:
            raise ValueError(f"rounds must be >= 0, got {remaining}")
        lam_run = float(meta["lam"]) if lam is None else float(lam)
        h_run = meta.get("local_h") if local_h is None else local_h
        prefix = [dict(e) for e in meta.get("history", [])]
        # the warm-start anchor continues the round and time axes from the
        # restored cursor, not from the last recorded entry: decimation
        # may have skipped the snapshot's round
        anchor = {"round": step, "time": float(meta["sim_time"]),
                  "dual": float("nan"), "primal": float("nan"),
                  "gap": float("nan")}
        ws = SolveResult(
            alpha=torch.as_tensor(payload["alpha"], device=self.device),
            w=torch.as_tensor(payload["w"], device=self.device),
            history=[anchor], next_key=prng.as_key(payload["key"]),
            lam=lam_run)
        out = self.run(remaining, warm_start=ws,
                       record_history=record_history,
                       history_every=history_every, on_round=on_round,
                       lam=lam_run, local_h=h_run, checkpoint=policy,
                       _ef_state=list(payload["res"]),
                       _history_prefix=prefix, _final_save=_final_save)
        out.history = prefix + out.history
        return out

    # ------------------------------------------------------------------
    def straggler_policy(self, *, seed: int = 0, adaptive=None, **kw):
        """The ``runtime/straggler.py::StragglerPolicy`` this session's
        straggler-aware auto-schedule planned: the jointly optimized
        ``BoundedSkip`` threshold (``resolved.skip``) with the
        ``StragglerModel`` the planner was given.  Needs a schedule
        compiled with ``DelayModel(straggler=...)``; other keyword
        arguments go to the policy (``warmup=``, ``k_mad=``, ...)."""
        from repro_torch.runtime.straggler import StragglerPolicy
        r = self.resolved
        if r.skip is None or r.straggler_model is None:
            raise ValueError(
                "this session's schedule was not planned with "
                "DelayModel(straggler=StragglerModel(...)); construct a "
                "StragglerPolicy explicitly instead")
        return StragglerPolicy(model=r.straggler_model,
                               max_consecutive=int(r.skip), seed=seed,
                               adaptive=adaptive, **kw)

    # ------------------------------------------------------------------
    def sweep(
        self,
        spec=None,
        *,
        lams=None,
        seeds=None,
        schedules=None,
        local_hs=None,
        mode: str = "grid",
        continuation: bool = False,
        rounds: Optional[int] = None,
        record_history: bool = True,
        history_every: int = 1,
        checkpoint=None,
    ):
        """Run a config grid through this session and return an
        ``api/sweep.py::RunSet``.

        Pass a ``Sweep`` as ``spec``, or build one inline from ``lams=`` /
        ``seeds=`` / ``schedules=`` / ``local_hs=`` (``mode`` is
        ``"grid"`` -- the cartesian product -- or ``"zip"``;
        ``continuation=True`` warm-starts a regularization path over the
        lambda axis, solved in descending-lambda order).  A (lambda x
        local-H x seed) grid within one schedule runs through ONE batched
        executor: one ``sdca_block`` launch per solve tick for all its
        configs.  Each member equals the corresponding standalone
        :meth:`run` bit for bit."""
        from repro_torch.api.sweep import Sweep, run_sweep
        if spec is None:
            spec = Sweep(lams=lams, seeds=seeds, schedules=schedules,
                         local_hs=local_hs, mode=mode,
                         continuation=continuation)
        elif (any(a is not None for a in (lams, seeds, schedules,
                                          local_hs))
              or mode != "grid" or continuation):
            raise ValueError(
                "pass either a Sweep spec or inline axes/options (lams=/"
                "seeds=/schedules=/local_hs=/mode=/continuation=), not "
                "both")
        return run_sweep(self, spec, rounds=rounds,
                         record_history=record_history,
                         history_every=history_every,
                         checkpoint=checkpoint)

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
        src = (alpha, w)
        alpha = torch.as_tensor(alpha, dtype=X.dtype, device=dev)
        w = torch.as_tensor(w, dtype=X.dtype, device=dev)
        for v, t in zip(src, (alpha, w)):
            instrument.count_h2d(v, t)
        if tuple(alpha.shape) != (self.problem.m,):
            raise ValueError(f"warm-start alpha must be ({self.problem.m},),"
                             f" got {tuple(alpha.shape)}")
        if tuple(w.shape) != (self.problem.d,):
            raise ValueError(f"warm-start w must be ({self.problem.d},), "
                             f"got {tuple(w.shape)}")
        return alpha, w, k.cpu()


def _calibrate_C(problem: Problem, topology: Topology, schedule: Schedule,
                 backend: str, mesh_kw: dict):
    """Resolve ``DelayModel(C="auto")``: run ``pilot_rounds`` root rounds
    under the topology's default schedule on ``backend`` (with the mesh
    keywords ``mesh_kw`` on the mesh) and the problem's device, fit eq. (11)'s improvement constant from the
    observed per-root-round gap contractions (``core/delay.py::fit_C``),
    and return (the schedule with the fitted C, the fitted C)."""
    dm = schedule.delay
    pilot = Session.compile(problem, topology,
                            Schedule(weighting=schedule.weighting),
                            backend=backend, device=problem.device,
                            **(mesh_kw if backend == "mesh" else {}))
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
    straggler=None,
    lam: Optional[float] = None,
    local_h=None,
    mesh=None,
    mesh_axes: Optional[Sequence[str]] = None,
    mesh_use_kernel: bool = True,
    mesh_sync: str = "psum",
) -> SolveResult:
    """One-shot convenience: ``Session.compile(...).run(...)`` with the
    ``run`` surface of this package (``warm_start``, ``straggler`` and the
    ``lam`` / ``local_h`` overrides) and the mesh keywords of
    :meth:`Session.compile`."""
    sess = Session.compile(problem, topology, schedule, backend=backend,
                           device=device, mesh=mesh, mesh_axes=mesh_axes,
                           mesh_use_kernel=mesh_use_kernel,
                           mesh_sync=mesh_sync)
    return sess.run(rounds, key=key, warm_start=warm_start,
                    record_history=record_history,
                    history_every=history_every, on_round=on_round,
                    straggler=straggler, lam=lam, local_h=local_h)


def _method_executor(problem, plan, backend: str, acceleration, mesh_kw: dict):
    """The executor of a session's method (``sdca``, or ``sdca_acc`` with
    an acceleration) from the engine's cache, built on a miss: what
    :meth:`Session.compile` binds and a strict run re-fetches."""
    method = get_method("sdca_acc" if acceleration is not None else "sdca")
    return method.executor(plan=plan, loss=problem.loss, backend=backend,
                           device=problem.device, **_executor_kw(mesh_kw))


def _executor_kw(mesh_kw: dict) -> dict:
    """``Session.compile``'s mesh keywords under ``Method.executor``'s
    names."""
    names = {"mesh": "mesh", "mesh_axes": "axes",
             "mesh_use_kernel": "use_kernel", "mesh_sync": "sync"}
    return {names[k]: v for k, v in mesh_kw.items()}


def _bind_mesh(plan, resolved, mesh, mesh_axes, mesh_sync, device):
    """The mesh checks of :meth:`Session.compile` (the reference's, with
    its messages) and the ``(mesh, mesh_axes)`` to bind: the given pair,
    or the default ``lvl0, lvl1, ...`` mesh of the plan's fan-outs over
    the world."""
    if plan.levels is None:
        raise ValueError(
            "backend='mesh' needs a level-homogeneous topology "
            "(uniform per-depth fan-out/rounds, congruent leaves)")
    if resolved.weighting != "uniform":
        raise ValueError("backend='mesh' supports weighting='uniform'")
    if mesh_sync not in mesh_mod.SYNC_MODES:
        raise ValueError(f"unknown mesh_sync {mesh_sync!r}; use "
                         f"{mesh_mod.SYNC_MODES}")
    if mesh is not None:
        if mesh_axes is None:
            raise ValueError("pass mesh_axes (innermost level first) "
                             "together with an explicit mesh")
        return mesh, tuple(mesh_axes)
    import torch.distributed as dist
    sizes = [plan.levels[d].group_size for d in range(plan.depth)]
    names = tuple(f"lvl{d}" for d in range(plan.depth))
    need = math.prod(sizes)
    have = dist.get_world_size() if dist.is_initialized() else None
    if have != need:
        raise RuntimeError(
            f"backend='mesh' needs {need} ranks (one per leaf) for "
            f"fan-outs {sizes}, have "
            f"{'no process group' if have is None else f'world size {have}'}"
            f" (start {need} processes that each call torch.distributed."
            f"init_process_group(world_size={need}), or pass mesh=)")
    dev_type = torch.device(device).type
    key = (dev_type, tuple(sizes))
    if key not in _DEFAULT_MESHES:
        from torch.distributed.device_mesh import init_device_mesh
        _DEFAULT_MESHES[key] = init_device_mesh(
            dev_type, tuple(sizes), mesh_dim_names=names)
    return _DEFAULT_MESHES[key], tuple(reversed(names))
