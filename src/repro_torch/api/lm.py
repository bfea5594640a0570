"""Session-driven LM training: the second workload on the schedule engine
(the JAX package's ``api/lm.py``).

``Problem.lm(cfg, optimizer, batch=, seq=)`` + ``Session.compile(...,
backend="mesh")`` dispatch here: the same Schedule -> ResolvedSchedule ->
``compile_tree`` plan IR that drives SDCA is lowered through
``engine.plan.schedule_view`` into the method-agnostic schedule layer
(per-level periods, group sizes, per-edge codecs), and the
``"lm_treesync"`` Method (``engine.method`` / ``engine.lm``) supplies the
local step and the per-level combine.  Each ``torch.distributed`` rank
holds one replica (its leaf of the tree), trains on its rows of the
global batch, and takes the periods as a runtime operand, so

  * ``run(local_h=...)`` and straggler-adaptive eq.-(12) replanning
    change an input, never the executor;
  * ``run(straggler=StragglerPolicy(...))`` drops straggling replicas
    from the barrier through a participation mask (absentees keep their
    state and rejoin), decided identically on every rank from the
    policy's seed;
  * ``run(checkpoint=...)`` / ``resume`` snapshot the exact state at
    outer-round boundaries in the reference's file format (the first
    replica's rank writes the gathered (R, ...) state) and restart bit
    for bit: the data stream is a pure function of ``(seed, step)``.

A mesh with a ``model`` axis larger than 1 makes each replica that many
ranks (tensor parallelism inside it, ``engine.lm.ReplicaTP``): a rank
holds its shards of its replica's state, cut by the reference's
``replica_specs`` rules, and runs the sharded local step; all ranks of a
replica draw its rows, and ``consensus`` and checkpoints are whole.

Every rank makes the same calls in the same order (compile builds the
sync groups, a collective).  With no process group, ``make_host_mesh()``
is a one-rank mesh: one replica, no syncs.  Parameters are drawn from
``PRNGKey(problem.seed)`` (or a run's ``key=``) as the reference draws
them, within a few float32 ulp (``core/prng.py``).  ``sweep`` runs an
(lr x seed x local_h) grid as B members on each rank through one batched
executor, one data draw per step for all of them.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from math import prod
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.analysis import plan_check
from repro_torch.analysis import trace_guard as guard_mod
from repro_torch.api.schedule import Schedule
from repro_torch.api.topology import Topology
from repro_torch.core import prng
from repro_torch.core.engine import lm as lm_mod
from repro_torch.core.engine import plan as plan_mod
from repro_torch.core.engine.method import get_method
from repro_torch.data.lm import lm_batch
from repro_torch.launch.mesh import axis_size

PyTree = Any
TreeSyncState = lm_mod.TreeSyncState


@dataclasses.dataclass
class LMResult:
    """One LM run: this rank's final state plus the per-step history
    (``{"step", "loss", "sec"}``; straggler runs add ``"time"``,
    ``"time_sync"``, ``"participants"`` and, when the policy is adaptive,
    the executed ``"h"``)."""
    state: TreeSyncState
    history: List[dict]
    wall_s: float
    comm: Optional[lm_mod.LMComm] = None
    tp: Optional[lm_mod.ReplicaTP] = None

    @property
    def final_loss(self) -> Optional[float]:
        return self.history[-1]["loss"] if self.history else None

    def consensus(self) -> PyTree:
        """The fully-averaged model (what you checkpoint / serve), whole on
        every rank; a collective over all replicas (and ``model``)."""
        return lm_mod.consensus_params(self.state, self.comm, self.tp)


@dataclasses.dataclass
class LMRunSet:
    """An LM sweep on this rank: the members' configs (``points``), their
    final states (``states``, this rank's replica of each member), the
    (B, T) float32 loss history (each step's replica mean), the members'
    learning rates and the host seconds of each grid step (its data draw
    and every member's step and syncs)."""
    points: List[Any]
    states: List[TreeSyncState]
    losses: np.ndarray               # (B, T) float32
    lrs: List[Optional[float]]
    step_seconds: List[float] = dataclasses.field(default_factory=list)

    def __len__(self) -> int:
        return len(self.points)

    @property
    def final_losses(self) -> np.ndarray:
        return self.losses[:, -1]

    def best(self) -> int:
        """Index of the member with the lowest final loss."""
        return int(np.nanargmin(self.final_losses))

    def member_state(self, i: int) -> TreeSyncState:
        return self.states[i]


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class LMSession:
    """Compiled LM training program: (LMProblem, Topology, Schedule) on
    the mesh backend.  Mirrors :class:`repro_torch.api.session.Session`'s
    surface (``run`` / ``resume`` / ``sweep`` / ``cache_stats``)."""

    def __init__(self, problem, topology, resolved, plan, sview, mesh,
                 sync_axes: Tuple[str, ...], device):
        self.problem = problem
        self.topology = topology
        self.resolved = resolved
        self.plan = plan
        self.sview = sview
        self.backend = "mesh"
        self.device = device
        self._mesh = mesh
        self._sync_axes = sync_axes
        self._axes = lm_mod.present_axes(mesh, sync_axes)
        self._level_sizes = lm_mod.level_sizes_for(mesh, sync_axes)
        self._method = get_method(problem.method)
        self._guard = None          # TraceGuard when compiled strict
        self._built = set()         # executor variants already fetched
        # the LM combine compresses the outermost edge only (legacy
        # TreeSync semantics); schedule_view is bottom-up, so [-1] is the
        # up-link into the root
        comp = sview.compression
        if any(c != "none" for c in comp[:-1]):
            raise ValueError(
                f"LM training compresses the outermost (root) edge only; "
                f"schedule plans per-level codecs {comp} (bottom-up)")
        self._compression = comp[-1] if comp else "none"
        self.comm = lm_mod.get_comm(mesh, self._axes)
        self.replica = 0 if self.comm is None else self.comm.replica
        # a replica over the ranks of the model axis (None: one rank)
        self.tp = lm_mod.replica_tp(problem.cfg, problem.optimizer, mesh)
        self.last_executor = None
        # the data draws this session made
        self.draw_count = 0

    # ------------------------------------------------------------------
    @classmethod
    def compile(cls, problem, topology: Optional[Topology] = None,
                schedule: Optional[Schedule] = None, *,
                backend: str = "mesh", mesh=None,
                sync_axes: Sequence[str] = ("data", "pod"),
                strict=False, device="cuda") -> "LMSession":
        """Lower ``topology`` under ``schedule`` into the LM train
        program on ``device``.  ``topology`` defaults to
        ``Topology.from_mesh(mesh)`` (one leaf per replica, one level per
        present sync axis); an explicit topology must have the mesh's
        fan-outs.  ``mesh`` defaults to ``make_host_mesh()`` over the
        initialized world.  ``strict`` (bool or a ``TraceGuard``) makes an
        unexpected executor-cache miss raise."""
        if backend != "mesh":
            raise ValueError(
                "LM training is replica-stacked data-parallel: the replica "
                "dim is sharded over the sync axes and every combine is a "
                "mesh all-reduce; compile with backend='mesh' "
                f"(got {backend!r})")
        device = _device(device)
        if mesh is None:
            from repro_torch.launch.mesh import make_host_mesh
            mesh = make_host_mesh(device_type=device.type)
        axes = lm_mod.present_axes(mesh, tuple(sync_axes))
        sizes = tuple(axis_size(mesh, a) for a in axes)  # bottom-up
        if topology is None:
            topology = Topology.from_mesh(mesh, sync_axes=tuple(sync_axes))
        schedule = schedule or Schedule()
        resolved = schedule.resolve(topology)
        plan = plan_mod.compile_tree(resolved.chunk_tree,
                                     weighting=resolved.weighting,
                                     compression=resolved.compression)
        sview = plan_mod.schedule_view(plan)
        R = max(prod(sizes), 1)
        if prod(sview.group_sizes) != R or (
                len(axes) > 0 and sview.group_sizes != sizes):
            raise ValueError(
                f"topology fan-outs {sview.group_sizes} (bottom-up) do not "
                f"match the mesh's sync-axis sizes {sizes} over {axes}: one "
                "leaf per replica, one level per mesh axis "
                "(Topology.from_mesh builds a matching tree)")
        # the structural verifier runs on every compile
        plan_check.verify_plan(plan)
        sess = cls(problem, topology, resolved, plan, sview, mesh,
                   tuple(sync_axes), device)
        sess._guard = guard_mod.as_trace_guard(strict)
        return sess

    # ------------------------------------------------------------------
    @property
    def n_replicas(self) -> int:
        return max(prod(self._level_sizes), 1)

    @property
    def periods(self) -> Tuple[int, ...]:
        """Planned per-level periods, bottom-up (leaf H first)."""
        return self.sview.periods

    @property
    def steps_per_round(self) -> int:
        """Local steps per outer (root) round: prod(periods)."""
        return prod(self.sview.periods)

    @property
    def level_plan(self):
        """The eq.-(12) planner output when the schedule was ``"auto"``."""
        return self.resolved.level_plan

    @property
    def default_rounds(self) -> int:
        return self.resolved.rounds

    @property
    def writer(self) -> bool:
        """Whether this rank writes what a run saves (the first replica's
        first ``model`` rank)."""
        return self.replica == 0 and (self.tp is None
                                      or self.tp.model_rank == 0)

    def barrier(self) -> None:
        """Wait for every rank of the mesh (nothing with one rank)."""
        if self.comm is not None:
            self.comm.everyone.all_max(torch.zeros(1))
        elif self.tp is not None:
            self.tp.ctx.comms[("model",)].all_max(torch.zeros(1))

    def cache_stats(self) -> dict:
        """LM executor-cache counters (hits/misses/size)."""
        return self._method.cache_stats()

    def sync_seconds(self) -> List[float]:
        """Seconds spent in each level's syncs (bottom-up) by the executor
        of the last run, and ``sync_counts`` how many ran."""
        ex = self.last_executor
        return list(ex.sync_seconds) if ex is not None else []

    def sync_counts(self) -> List[int]:
        ex = self.last_executor
        return list(ex.sync_count) if ex is not None else []

    # ------------------------------------------------------------------
    def init_state(self, key=None, *, seed: Optional[int] = None
                   ) -> TreeSyncState:
        """This rank's replica of a fresh state on the session's device
        (its shards of it on a ``model`` axis), drawn as the reference's
        ``init_state``: from ``key`` (a port key or a jax key's two words;
        an int is a seed), else from ``PRNGKey(seed)``, by default
        ``PRNGKey(problem.seed)``."""
        key = prng.as_key(key if key is not None else (
            self.problem.seed if seed is None else int(seed)))
        return lm_mod.init_replica_state(
            self.problem.cfg, self.problem.optimizer, key,
            compression=self._compression, device=self.device,
            mesh=self._mesh)

    def _executor(self, *, masked: bool = False, with_lr: bool = False,
                  batched: bool = False):
        return self._method.executor(
            cfg=self.problem.cfg, optimizer=self.problem.optimizer,
            level_sizes=self._level_sizes, compression=self._compression,
            average_opt_state=self.problem.average_opt_state,
            masked=masked, with_lr=with_lr, batched=batched,
            mesh=self._mesh, axes=self._axes)

    def _run_periods(self, local_h) -> List[int]:
        ps = list(self.sview.periods)
        if local_h is not None:
            if int(local_h) < 1:
                raise ValueError(f"local_h must be >= 1, got {local_h}")
            ps[0] = int(local_h)
        return ps

    def _batch_at(self, step: int):
        p = self.problem
        rows = lm_mod.replica_rows(p.batch, self.n_replicas, self.replica)
        self.draw_count += 1
        return lm_batch(p.cfg, p.batch, p.seq, step, seed=p.seed, rows=rows,
                        device=self.device)

    # ------------------------------------------------------------------
    def run(
        self,
        rounds: Optional[int] = None,
        *,
        steps: Optional[int] = None,
        key=None,
        warm_start: Optional[TreeSyncState] = None,
        local_h=None,
        lr: Optional[float] = None,
        straggler=None,
        checkpoint=None,
        record_history: bool = True,
        on_step=None,
        on_state=None,
        _history_prefix: Sequence[dict] = (),
        _final_save: bool = True,
    ) -> LMResult:
        """Run ``rounds`` outer rounds (default: the schedule's), each
        ``prod(periods)`` local steps; ``steps=`` overrides with an exact
        local-step count (the final round truncates).

        ``local_h`` overrides the leaf period for this run; under an
        adaptive ``straggler`` policy the replanned eq.-(12) H feeds the
        NEXT round's periods operand.  ``warm_start`` continues from a
        previous result's state (copied: the step updates its state in
        place; the data stream continues from ``state.step``).
        ``checkpoint`` snapshots the exact state every ``policy.every``
        outer rounds; see :meth:`resume`.  ``lr`` overrides the
        optimizer's step size (a runtime operand).  ``on_step(entry)`` sees
        each history entry; ``on_state(step, state)`` sees this rank's
        live state after each step, syncs included (a hook for checks: the
        state is updated in place by the next step)."""
        p = self.problem
        R = self.n_replicas
        L = len(self._level_sizes)
        periods = self._run_periods(local_h)
        spr = prod(periods)

        if warm_start is not None:
            state = warm_start.state if isinstance(warm_start, LMResult) \
                else warm_start
            state = lm_mod.clone_state(state)
        else:
            state = self.init_state(key)
        start = int(state.step)
        if steps is not None:
            total = int(steps)
        else:
            T = self.resolved.rounds if rounds is None else int(rounds)
            if T < 0:
                raise ValueError(f"rounds must be >= 0, got {T}")
            total = T * spr

        ckpt_mgr, ck_every, ckpt_policy = None, 0, None
        if checkpoint is not None:
            if straggler is not None:
                raise ValueError(
                    "checkpoint= does not compose with straggler=: the "
                    "policy's sampled-delay RNG and skip counters are host "
                    "state the snapshot cannot capture, so a resumed run "
                    "would diverge; checkpoint synchronous runs only")
            from repro_torch.runtime import fault as fault_mod
            ckpt_policy, ckpt_mgr, ck_every = fault_mod.bind_policy(
                checkpoint, self.resolved)

        masked = straggler is not None
        if masked:
            n_leaves = self.plan.n_leaves
            if n_leaves != R:
                raise ValueError(
                    f"straggler= needs one topology leaf per replica "
                    f"(got {n_leaves} leaves for {R} replicas)")
            t_lp = self.topology.leaf_t_lp()
            straggler.bind(self.topology.leaf_sync_delays(),
                           t_compute=spr * t_lp, t_lp=t_lp)
        adaptive = masked and getattr(straggler, "adaptive", None) is not None

        # strict mode: fetching a variant this session has ALREADY built
        # must hit the cache (zero budget -- a cleared cache or a drifted
        # key raises); the first fetch of a variant is budgeted one build
        guard = self._guard

        def _retrace_ctx(budget=0):
            if guard is None or not guard.error_on_retrace:
                return contextlib.nullcontext()
            return guard.retrace_region(budget)

        variant = (masked, lr is not None)
        with _retrace_ctx(0 if variant in self._built else 1):
            exec_fn = self._executor(masked=masked, with_lr=lr is not None)
        self._built.add(variant)
        self.last_executor = exec_fn
        exec_fn.reset_timers()
        part = np.ones((R,), np.float32) if masked else None
        lr_arg = None if lr is None else float(lr)

        history: List[dict] = []
        clock = {"async": 0.0, "sync": 0.0}
        t_start = time.time()
        i, done = start, 0
        while done < total:
            n_this = min(spr, total - done)
            final = done + n_this >= total
            extra = None
            if masked:
                st = straggler.step(final=final)
                part = np.asarray(st.mask, np.float32)
                clock["async"] += st.dt_async
                clock["sync"] += st.dt_sync
                extra = {"time": clock["async"],
                         "time_sync": clock["sync"],
                         "participants": int(st.mask.sum())}
                if adaptive:
                    extra["h"] = periods[0]
            for _ in range(n_this):
                t0 = time.time()
                state, metrics = exec_fn(state, self._batch_at(i),
                                         periods[:L], part, lr_arg)
                i += 1
                done += 1
                if record_history:
                    entry = {"step": i, "loss": float(metrics["loss"]),
                             "sec": time.time() - t0}
                    if extra:
                        entry.update(extra)
                    history.append(entry)
                    if on_step is not None:
                        on_step(entry)
                if on_state is not None:
                    on_state(i, state)
            if guard is not None and guard.sanitize:
                guard.check_carry(state, f"state@step{i}")
            # eq.-(12) replanning feeds the NEXT round through the runtime
            # periods operand
            if adaptive and straggler.last_h_suggest is not None:
                h_new = max(int(straggler.last_h_suggest), 1)
                if h_new != periods[0]:
                    periods[0] = h_new
                    spr = prod(periods)
                    straggler.retime(spr * self.topology.leaf_t_lp())
            if ckpt_mgr is not None:
                r_no = (i - start + spr - 1) // spr
                if r_no % ck_every == 0 or (final and _final_save):
                    meta = {
                        "version": 1,
                        "step": i,
                        "steps_total": start + total,
                        "periods": list(periods),
                        "plan": self.plan.fingerprint,
                        "seed": int(p.seed),
                        "lr": None if lr is None else float(lr),
                        "history": list(_history_prefix) + history,
                    }
                    self._save(ckpt_mgr, i, state, meta)
        if ckpt_mgr is not None:
            ckpt_mgr.wait()
            self.barrier()
        return LMResult(state=state,
                        history=list(_history_prefix) + history,
                        wall_s=time.time() - t_start, comm=self.comm,
                        tp=self.tp)

    def _save(self, mgr, step: int, state: TreeSyncState, meta: dict):
        """Gather the replicas (each whole over ``model``) and let the
        first replica's first rank write."""
        from repro_torch.runtime import fault as fault_mod
        payload = fault_mod.lm_payload(state, self.comm, self.tp)
        if self.writer:
            mgr.save(step, payload, metadata=meta)

    # ------------------------------------------------------------------
    def resume(self, checkpoint, *, steps: Optional[int] = None,
               record_history: bool = True, on_step=None) -> LMResult:
        """Restart a checkpointed run from its newest snapshot, bit for bit
        with the uninterrupted run: the restored state is the complete
        carry and the data stream is a pure function of ``(seed,
        step)``.  Runs the remaining steps (``steps_total - step``, or
        ``steps=``) and keeps checkpointing into the same directory; the
        returned history is the full concatenated series."""
        from repro_torch.runtime import fault as fault_mod
        self.barrier()      # the writer's last snapshot is complete
        policy, mgr, _ = fault_mod.bind_policy(checkpoint, self.resolved)
        last = mgr.latest_step()
        if last is None:
            raise FileNotFoundError(
                f"no complete checkpoints under {policy.directory!r}")
        meta = mgr.metadata(last)
        if meta.get("plan") != self.plan.fingerprint:
            raise ValueError(
                "checkpoint was written under a different plan "
                "(topology/schedule/compression changed between save and "
                "resume); compile a matching session")
        if int(meta.get("seed", self.problem.seed)) != int(self.problem.seed):
            raise ValueError(
                f"checkpoint data stream has seed {meta['seed']}; this "
                f"problem uses seed {self.problem.seed}")
        # the file holds whole replicas: restore into a whole state, then cut
        whole = lm_mod.init_lm_state(
            self.problem.cfg, self.problem.optimizer, prng.PRNGKey(0),
            compression=self._compression, device=self.device)
        step, state = fault_mod.lm_restore(mgr, last, whole, self.replica)
        if self.tp is not None:
            state = self.tp.cut(state)
        remaining = int(meta["steps_total"]) - step if steps is None \
            else int(steps)
        if remaining < 0:
            raise ValueError(f"steps must be >= 0, got {remaining}")
        lr = meta.get("lr")
        periods = meta.get("periods")
        local_h = None
        if periods is not None and tuple(periods) != self.sview.periods:
            local_h = int(periods[0])
        return self.run(steps=remaining, warm_start=state, local_h=local_h,
                        lr=lr, checkpoint=policy,
                        record_history=record_history, on_step=on_step,
                        _history_prefix=[dict(e)
                                         for e in meta.get("history", [])])

    # ------------------------------------------------------------------
    def sweep(self, spec=None, *, lrs=None, seeds=None, local_hs=None,
              rounds: Optional[int] = None, steps: Optional[int] = None,
              ) -> LMRunSet:
        """Run an (lr x seed x local_h) grid through ONE cached executor
        (the ``batched`` variant): B members on each rank, each with its
        own state, periods row and lr, one data draw per step shared by
        all of them (seeds vary the init key, as the reference's sweep
        does; the stream belongs to the problem).  Each member equals its
        standalone ``run(steps=, key=PRNGKey(seed), lr=, local_h=)`` bit
        for bit.  ``spec`` is an ``api/sweep.py::Sweep`` (axes ``lrs`` /
        ``seeds`` / ``local_hs``; ``lams`` / ``schedules`` are SDCA axes
        and refused here), or pass the axes directly."""
        from repro_torch.api.sweep import Sweep
        if spec is None:
            spec = Sweep(lrs=lrs, seeds=seeds, local_hs=local_hs)
        if spec.lams is not None or spec.schedules is not None:
            raise ValueError(
                "LM sweeps batch lrs=, seeds=, and local_hs= (runtime "
                "operands of one executor); lams= has no LM meaning and a "
                "schedules= axis changes the compiled program -- run one "
                "sweep per schedule")
        if spec.continuation or spec.resume is not None:
            raise ValueError(
                "continuation/resume are SDCA sweep features; LM sweeps "
                "run straight grids")
        points = spec.expand(0.0)
        B = len(points)
        L = len(self._level_sizes)
        spr = prod(self.sview.periods)
        if steps is not None:
            total = int(steps)
        else:
            T = self.resolved.rounds if rounds is None else int(rounds)
            total = T * spr

        # a member's seed is its init key (None: the problem's seed)
        states = [self.init_state(pt.seed) for pt in points]
        periods_b = [self._run_periods(pt.local_h)[:L] for pt in points]
        with_lr = spec.lrs is not None
        lr_b = [pt.lr for pt in points] if with_lr else None

        exec_fn = self._executor(with_lr=with_lr, batched=True)
        self.last_executor = exec_fn
        exec_fn.reset_timers()
        losses, seconds = [], []
        for i in range(total):
            t0 = time.perf_counter()
            states, metrics = exec_fn(states, self._batch_at(i), periods_b,
                                      None, lr_b)
            losses.append(metrics["loss"].float().cpu().numpy())
            seconds.append(time.perf_counter() - t0)
        return LMRunSet(points=points, states=states,
                        losses=np.stack(losses, axis=1) if losses
                        else np.zeros((B, 0), np.float32),
                        lrs=[pt.lr for pt in points], step_seconds=seconds)
