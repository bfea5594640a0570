"""The elasticity subsystem: checkpointed chunk carries, permanent
membership events and fault injection for tree-SDCA sessions, as in the
JAX package's ``runtime/fault.py``.

* **Checkpointed carries** -- :class:`CheckpointPolicy` drives
  ``Session.run(checkpoint=...)``.  At every root-round boundary under
  full participation the executor's blocked state collapses: the root
  sync refreshes every snapshot, so every leaf's ``w`` equals the root's
  and every snapshot equals the live state.  A complete carry is
  therefore ``{alpha (m,), w (d,), one error-feedback residual (n, d) per
  compressed depth, the root RNG key}`` plus scalar metadata, and a
  restore is ``init(X, alpha, w)`` with the residuals substituted
  (:func:`with_ef_residuals`).  The payload is the JAX package's, entry
  for entry (the key as two uint32 words), so a file written by either
  package resumes in the other.

* **Membership events** -- :class:`MembershipLog` records permanent
  ``leave(name, at_round)`` / ``join(name, X, y, at_round)`` events;
  :class:`ElasticSession` runs the solve in segments, splicing the data
  and dual rows on the device at each boundary, rebuilding ``w = X^T
  alpha / (lam m)`` (the eq.-(13) invariant survives any row deletion or
  insertion), re-weighting aggregation from the surviving leaves
  (``weighting="size"``, the imbalanced-data rule of arXiv:2308.14783)
  and recompiling against the edited topology (``plan_diff`` reports what
  each event changed).  A joining leaf enters with a zero dual block
  against the current global ``w``.

* **LM snapshots** -- :func:`lm_payload` / :func:`lm_restore` carry an
  LM TreeSync state (``core/engine/lm.py``) in the reference's file: the
  replica-stacked (R, ...) leaves under the names its
  ``tree_flatten_with_path`` gives a ``TreeSyncState`` (``None`` for
  the step, ``None/<path>`` for the params and the optimizer state), so
  either package resumes the other's snapshot.  Each rank holds one
  replica, so a save gathers the replicas in replica order and the first
  replica's rank writes; a restore reads the file on every rank and
  keeps its own row.

* **Fault injection** -- :class:`FaultModel` samples crash rounds and
  permanent-leave processes with ``np.random.default_rng(seed)`` (the
  reference's draws, so the same seed gives the same crashes);
  :func:`run_with_faults` drives simulated kill-and-resume runs whose
  final iterates equal the uninterrupted solve's bit for bit.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core import compression as comp_mod
from repro_torch.runtime.checkpoint import CheckpointManager

Tensor = torch.Tensor

PAYLOAD_VERSION = 1


# ---------------------------------------------------------------------------
# checkpoint policy
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class CheckpointPolicy:
    """How a session checkpoints: where, how often, how many to keep.

    ``every`` is the snapshot period in root rounds; ``"auto"`` uses the
    Young/Daly period the schedule planned (``resolved.ckpt_every``, set
    when the schedule was compiled with ``DelayModel(mtbf=...)``).  The
    final round is always snapshotted, so ``Session.resume`` of a
    completed run is a restore.  ``async_save`` moves the write off the
    round loop (one in flight at a time; a failed write surfaces on the
    next save or wait)."""
    directory: Union[str, os.PathLike]
    every: Union[int, str] = 1
    keep: int = 3
    async_save: bool = False

    def __post_init__(self):
        if isinstance(self.every, str):
            if self.every != "auto":
                raise ValueError(
                    f"every must be a positive int or 'auto', "
                    f"got {self.every!r}")
        elif int(self.every) < 1:
            raise ValueError(f"every must be >= 1, got {self.every}")

    def manager(self) -> CheckpointManager:
        return CheckpointManager(directory=str(self.directory),
                                 keep=self.keep, async_save=self.async_save)


def bind_policy(checkpoint, resolved=None):
    """Normalize ``Session.run(checkpoint=...)``'s argument (a directory
    path or a :class:`CheckpointPolicy`) into ``(policy, manager,
    every_int)``, resolving ``every="auto"`` against the schedule."""
    if isinstance(checkpoint, (str, os.PathLike)):
        checkpoint = CheckpointPolicy(directory=checkpoint)
    every = checkpoint.every
    if every == "auto":
        ck = getattr(resolved, "ckpt_every", None)
        if ck is None:
            raise ValueError(
                "CheckpointPolicy(every='auto') needs a schedule compiled "
                "with DelayModel(mtbf=..., ckpt_write=...): the Young/Daly "
                "period lives in resolved.ckpt_every")
        every = int(ck)
    return checkpoint, checkpoint.manager(), int(every)


# ---------------------------------------------------------------------------
# the LM TreeSync payload
# ---------------------------------------------------------------------------
def _lm_entries(state):
    """``(name, tensor)`` pairs of one replica's state under the
    reference's checkpoint names.  Its ``TreeSyncState`` fields flatten to
    the key ``None`` (jax names a dataclass field by neither key nor
    index), so the params and the optimizer state share the ``None/``
    prefix; the reference's residual would land on the params' names too
    (the later overwrites the earlier in its file), so the residual here
    goes under ``residual/`` instead."""
    from repro_torch.runtime.checkpoint import _paths
    out = [(f"None/{k}", v) for k, v in _paths(state.params)]
    out += [(f"None/{k}", v) for k, v in _paths(state.opt_state)]
    if state.residual is not None:
        out += [(f"residual/{k}", v) for k, v in _paths(state.residual)]
    return out


def lm_payload(state, comm, tp=None) -> dict:
    """The replica-stacked checkpoint payload of an LM state, gathered on
    every rank of ``comm`` (an ``engine.lm.LMComm``, None for one
    replica): ``{"None": int32 step, "None/<path>": (R, ...)}``.  Under
    ``tp`` (an ``engine.lm.ReplicaTP``) each replica's shards are first
    gathered whole over ``model``, so the file is the same whatever the
    ``model`` axis."""
    if tp is not None:
        state = tp.whole(state)
    payload = {"None": np.asarray(int(state.step), np.int32)}
    for name, t in _lm_entries(state):
        if comm is None:
            stacked = t.detach()[None]
        else:
            g, _ = comm.world
            flat = t.detach().reshape(1, -1)
            wide = flat.float() if flat.dtype == torch.bfloat16 else flat
            stacked = g.gather_rows(wide).to(t.dtype).reshape(
                (g.size,) + tuple(t.shape))
        payload[name] = stacked
    return payload


def lm_restore(mgr: CheckpointManager, step: int, state, replica: int):
    """Replica ``replica``'s row of a snapshot, written into ``state``'s
    tensors (a state of the same structure, e.g. a fresh ``init_state``);
    returns ``(step, state)``.  A file without ``residual/`` entries (the
    reference's) gives the residual what the reference's own restore
    gives it: the entries under the params' names."""
    pairs = _lm_entries(state)
    with np.load(mgr._path(step)) as z:
        files = set(z.files)
    template = {"None": np.zeros((), np.int32)}
    for name, t in pairs:
        if name in files:
            template[name] = torch.empty(0, dtype=t.dtype)
    arrays = mgr._read(step, template)
    with torch.no_grad():
        for name, t in pairs:
            src = arrays.get(name)
            if src is None:
                src = arrays["None/" + name[len("residual/"):]]
            t.copy_(torch.as_tensor(src)[replica].to(t.dtype))
    state.step = int(np.asarray(arrays["None"]))
    return state.step, state


# ---------------------------------------------------------------------------
# the chunk-carry payload (backend-portable)
# ---------------------------------------------------------------------------
def n_residuals(plan) -> int:
    """Per-compressed-depth error-feedback residual count of a plan."""
    return sum(
        1 for dd in range(plan.depth)
        if (plan.compress_kind[dd] != comp_mod.KIND_NONE).any())


def _np_dtype(dtype) -> np.dtype:
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).numpy().dtype
    return np.dtype(dtype)


def payload_template(plan, m: int, d: int, dtype):
    """The tree a checkpointed chunk carry restores into: flat dual,
    primal, per-compressed-depth EF residuals, raw root RNG key (two
    uint32 words).  ``dtype`` is the problem's (torch or numpy)."""
    dt = _np_dtype(dtype)
    return {
        "alpha": np.zeros((m,), dt),
        "w": np.zeros((d,), dt),
        "key": np.zeros((2,), np.uint32),
        "res": [np.zeros((plan.n_leaves, d), np.float32)
                for _ in range(n_residuals(plan))],
    }


def ef_residuals(session, state) -> List[Tensor]:
    """The per-compressed-depth ``(n, d)`` float32 error-feedback
    residuals of a live executor state (empty for an uncompressed plan):
    the one part of the blocked state that does not collapse into (alpha,
    w) at a root-round boundary.  Returned as the state's own device
    tensors; the caller clones them before the state moves on.  On the
    mesh each rank holds its leaf's row, and every rank gathers the (n,
    d) residuals (a collective)."""
    if state is None or not session.plan.has_compression:
        return []
    if session.backend == "mesh":
        return [session.executor.gather_leaves(r) for r in state.res]
    return list(state.res)


def with_ef_residuals(session, state, res: Sequence):
    """Substitute restored EF residuals (host arrays) into a freshly
    ``init``-ed executor state, on the session's device; on the mesh,
    each rank's own leaf row."""
    res = tuple(res)
    if not res:
        return state
    n_res = n_residuals(session.plan)
    if len(res) != n_res:
        raise ValueError(
            f"checkpoint carries {len(res)} EF residuals but the plan "
            f"compresses {n_res} depths -- was the schedule's compression "
            "changed between save and resume?")
    from repro_torch.runtime.elastic import remesh_state, replicated
    host = tuple(np.asarray(r, np.float32) for r in res)
    if session.backend == "mesh":
        leaf = session.executor.leaf
        host = tuple(r[leaf:leaf + 1] for r in host)
    sub = remesh_state(host, replicated(session.device, host))
    return state._replace(res=tuple(sub))


# ---------------------------------------------------------------------------
# membership events (permanent leave / join)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class MembershipEvent:
    kind: str                 # "leave" | "join"
    name: str
    at_round: int
    X: Optional[Any] = None   # join only: the new leaf's data block
    y: Optional[Any] = None
    parent: Optional[str] = None  # join only: internal node (default root)

    def __post_init__(self):
        if self.kind not in ("leave", "join"):
            raise ValueError(f"unknown event kind {self.kind!r}")
        if self.at_round < 0:
            raise ValueError(f"at_round must be >= 0, got {self.at_round}")
        if self.kind == "join" and (self.X is None or self.y is None):
            raise ValueError("a join event needs the new leaf's (X, y)")


class MembershipLog:
    """An ordered log of permanent membership events, applied at root-round
    boundaries by :class:`ElasticSession` (an event ``at_round=t`` takes
    effect after round ``t`` completes; ``at_round=0`` before the first
    round)."""

    def __init__(self, events: Sequence[MembershipEvent] = ()):
        self.events: List[MembershipEvent] = list(events)

    def leave(self, name: str, *, at_round: int) -> "MembershipLog":
        self.events.append(MembershipEvent("leave", name, int(at_round)))
        return self

    def join(self, name: str, X, y, *, at_round: int,
             parent: Optional[str] = None) -> "MembershipLog":
        self.events.append(MembershipEvent(
            "join", name, int(at_round), X=X, y=y, parent=parent))
        return self

    def boundaries(self) -> List[int]:
        return sorted({e.at_round for e in self.events})

    def at(self, t: int) -> List[MembershipEvent]:
        return [e for e in self.events if e.at_round == t]

    def __len__(self) -> int:
        return len(self.events)


def _cut(pieces: List[Tensor], off: int, size: int) -> List[Tensor]:
    """The row views of ``cat(pieces)`` without rows ``[off, off+size)``."""
    out, start = [], 0
    for p in pieces:
        lo, hi = start, start + p.shape[0]
        start = hi
        if hi <= off or lo >= off + size:
            out.append(p)
            continue
        if lo < off:
            out.append(p[:off - lo])
        if hi > off + size:
            out.append(p[off + size - lo:])
    return out


def _insert(pieces: List[Tensor], off: int, block: Tensor) -> List[Tensor]:
    """The row views of ``cat(pieces)`` with ``block`` inserted at row
    ``off``."""
    out, start, done = [], 0, False
    for p in pieces:
        lo, hi = start, start + p.shape[0]
        start = hi
        if not done and lo <= off < hi:
            if off > lo:
                out.append(p[:off - lo])
            out.append(block)
            out.append(p[off - lo:])
            done = True
        else:
            out.append(p)
    if not done:
        out.append(block)
    return out


class ElasticSession:
    """A session whose leaf set changes mid-solve.

    Runs ``rounds`` root rounds against a :class:`MembershipLog`: at every
    event boundary the data and dual rows are spliced on the device (a
    leaving leaf's block is deleted, its dual mass leaves with it; a
    joining leaf enters with a zero dual block) with one ``torch.cat`` per
    tensor, the primal is rebuilt as ``w = X^T alpha / (lam m)`` over the
    new data (``m`` changed, so ``w`` moves), and the session recompiles
    against the edited topology.  ``self.plan_diffs`` records what each
    event changed (``core/engine/plan.py::plan_diff``)."""

    def __init__(self, problem, topology, schedule=None, *,
                 backend: str = "cuda", device="cuda"):
        from repro_torch.api.schedule import Schedule
        self.schedule = schedule if schedule is not None \
            else Schedule(weighting="size")
        self.problem = problem
        self.topology = topology
        self.backend = backend
        self.device = device
        self.plan_diffs: List[dict] = []
        # post-run views (the final membership's problem / topology)
        self.current_problem = problem
        self.current_topology = topology

    def run(self, rounds: int, *, membership: Optional[MembershipLog] = None,
            key=None, lam: Optional[float] = None,
            record_history: bool = True, history_every: int = 1):
        from repro_torch.api.session import Session
        from repro_torch.core import dual as dual_mod
        from repro_torch.core.engine import plan as plan_mod
        from repro_torch.core.instrument import SolveResult

        T = int(rounds)
        events = list(membership.events) if membership is not None else []
        for e in events:
            if e.at_round >= T:
                raise ValueError(
                    f"event {e.kind}({e.name!r}) at round {e.at_round} "
                    f"never takes effect in a {T}-round run")
        boundaries = sorted({e.at_round for e in events})

        topo = self.topology
        sess = Session.compile(self.problem, topo, self.schedule,
                               backend=self.backend, device=self.device)
        prob = sess.problem                   # on the session's device
        lam_run = prob.lam if lam is None else float(lam)
        history: List[dict] = []
        diffs: List[dict] = []
        prev: Optional[SolveResult] = None
        cur = 0
        for b in boundaries + [T]:
            seg = b - cur
            if seg > 0:
                res = sess.run(
                    seg, key=(key if prev is None else None),
                    warm_start=prev, lam=lam_run,
                    record_history=record_history,
                    history_every=history_every)
                history += res.history
                prev = res
                cur = b
            if b == T:
                break

            # apply this boundary's events: splice rows by leaf NAME, as
            # views of the old tensors, then one cat each
            X, y = prob.X, prob.y
            if prev is not None:
                alpha, next_key = prev.alpha, prev.next_key
            else:
                alpha = torch.zeros((prob.m,), dtype=X.dtype,
                                    device=X.device)
                next_key = key
            px, py, pa = [X], [y], [alpha]
            old_plan = sess.plan
            for e in [ev for ev in events if ev.at_round == b]:
                if e.kind == "leave":
                    off, sz = topo.leaf_span(e.name)
                    topo = topo.without_leaf(e.name)
                    px, py, pa = (_cut(p, off, sz) for p in (px, py, pa))
                else:
                    Xn = torch.as_tensor(e.X, dtype=X.dtype,
                                         device=X.device)
                    yn = torch.as_tensor(e.y, dtype=y.dtype,
                                         device=y.device)
                    if Xn.dim() != 2 or Xn.shape[1] != X.shape[1]:
                        raise ValueError(
                            f"join {e.name!r}: X must be (k, {X.shape[1]}),"
                            f" got {tuple(Xn.shape)}")
                    topo = topo.with_leaf(e.name, parent=e.parent,
                                          data_size=len(yn))
                    off, _ = topo.leaf_span(e.name)
                    px = _insert(px, off, Xn)
                    py = _insert(py, off, yn)
                    pa = _insert(pa, off, torch.zeros(
                        len(yn), dtype=alpha.dtype, device=alpha.device))
            prob = dataclasses.replace(prob, X=torch.cat(px),
                                       y=torch.cat(py))
            alpha = torch.cat(pa)
            del px, py, pa, X, y
            sess = Session.compile(prob, topo, self.schedule,
                                   backend=self.backend, device=self.device)
            diffs.append({"round": b,
                          **plan_mod.plan_diff(old_plan, sess.plan)})
            # m changed: the eq.-(13) primal is rebuilt, and a joining
            # leaf's zero dual block sees the warm global w
            w = dual_mod.w_of_alpha(alpha, prob.X, lam_run)
            anchor = history[-1] if history else \
                {"round": 0, "time": 0.0, "dual": float("nan"),
                 "primal": float("nan"), "gap": float("nan")}
            prev = SolveResult(alpha=alpha, w=w, history=[dict(anchor)],
                               next_key=next_key, lam=lam_run)

        self.plan_diffs = diffs
        self.current_problem = prob
        self.current_topology = topo
        if prev is None:    # T == 0 with no events
            prev = SolveResult(
                alpha=torch.zeros((prob.m,), dtype=prob.X.dtype,
                                  device=prob.device),
                w=torch.zeros((prob.d,), dtype=prob.X.dtype,
                              device=prob.device),
                history=[], next_key=key, lam=lam_run)
        return SolveResult(alpha=prev.alpha, w=prev.w, history=history,
                           next_key=prev.next_key, lam=lam_run)


# ---------------------------------------------------------------------------
# fault injection
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class FaultModel:
    """Stochastic fault processes for simulated runs.

    ``crash_prob`` is the per-root-round probability the coordinator dies
    (kill-and-resume via :func:`run_with_faults`); ``leave_prob`` the
    per-round per-leaf probability of permanent loss (a
    :class:`MembershipLog` for :class:`ElasticSession`, never shrinking
    below ``min_leaves``).  ``straggler`` optionally carries the transient
    delay layer (a ``core/delay.py::StragglerModel`` for a
    ``StragglerPolicy``): stragglers skip syncs and re-join, faults here
    never come back."""
    crash_prob: float = 0.0
    leave_prob: float = 0.0
    min_leaves: int = 2
    straggler: Optional[Any] = None

    def __post_init__(self):
        for nm in ("crash_prob", "leave_prob"):
            v = getattr(self, nm)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{nm} must be in [0, 1], got {v}")
        if self.min_leaves < 1:
            raise ValueError(
                f"min_leaves must be >= 1, got {self.min_leaves}")

    def sample_crashes(self, rounds: int, seed: int = 0) -> List[int]:
        """Rounds (1..rounds-1) after which the coordinator dies."""
        rng = np.random.default_rng(seed)
        return [t for t in range(1, int(rounds))
                if rng.random() < self.crash_prob]

    def sample_leaves(self, leaf_names: Sequence[str], rounds: int,
                      seed: int = 0) -> MembershipLog:
        """A permanent-loss :class:`MembershipLog` over ``rounds``."""
        rng = np.random.default_rng(seed)
        log = MembershipLog()
        alive = list(leaf_names)
        for t in range(1, int(rounds)):
            for nm in list(alive):
                if len(alive) <= self.min_leaves:
                    break
                if rng.random() < self.leave_prob:
                    log.leave(nm, at_round=t)
                    alive.remove(nm)
        return log


def run_with_faults(session, rounds: Optional[int] = None, *, checkpoint,
                    fault: FaultModel, key=None, seed: int = 0,
                    lam: Optional[float] = None, local_h=None,
                    record_history: bool = True, history_every: int = 1):
    """Drive a simulated kill-and-resume run: at every sampled crash round
    the in-memory state is discarded (the kill) and the solve restarts
    from the newest complete checkpoint through ``Session.resume`` -- the
    production restart path, so the result equals an uninterrupted
    checkpointed run bit for bit.  Returns ``(result, report)``; the
    report lists each crash and restart (``resumed_from`` < the crash
    round when the crash out-ran the checkpoint period: that work is
    recomputed)."""
    T = session.resolved.rounds if rounds is None else int(rounds)
    policy, mgr, _ = bind_policy(checkpoint, session.resolved)
    crashes = fault.sample_crashes(T, seed)
    kw = dict(lam=lam, local_h=local_h, record_history=record_history,
              history_every=history_every)
    stops = crashes + [T]
    restarts = []
    result = None
    for i, stop in enumerate(stops):
        # a leg that ends in a crash dies WITHOUT the forced final-round
        # save: only period-aligned checkpoints survive the kill, so the
        # resume recomputes the rounds the crash out-ran
        is_crash = i < len(crashes)
        if i == 0:
            result = session.run(stop, key=key, checkpoint=policy,
                                 _final_save=not is_crash, **kw)
        else:
            step = mgr.latest_step()
            if step is None:       # crashed before the first save: scratch
                step = 0
                result = session.run(stop, key=key, checkpoint=policy,
                                     _final_save=not is_crash, **kw)
            else:
                result = session.resume(policy, rounds=stop - step,
                                        _final_save=not is_crash, **kw)
            restarts.append({"crash_at": int(crashes[i - 1]),
                             "resumed_from": int(step),
                             "ran_to": int(stop)})
        if is_crash:
            result = None                          # the simulated kill
    return result, {"rounds": T, "crashes": [int(c) for c in crashes],
                    "restarts": restarts}
