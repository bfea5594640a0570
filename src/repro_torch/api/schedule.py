"""The :class:`Schedule` object: *how many* rounds at every tree level.

The paper's central knob is the local/global iteration trade-off (eq.
(9)-(12)): more local steps H amortize a slow link but dilute each
aggregation.  A Schedule either pins the knob explicitly (``rounds``,
``level_rounds``, ``local_steps``) or delegates it to the paper's eq.-(12)
planner with ``rounds="auto"``: at compile time
``core/delay.py::plan_hierarchical_h`` is run over the topology's
link-delay structure (:meth:`Topology.sync_levels`) and picks the
per-level H, with the root round count set by the :class:`DelayModel`'s
simulated-time budget.

* ``local_steps`` also accepts a per-leaf spec -- a ``{leaf_name: H}``
  dict or a left-to-right sequence;
* ``h_cap=`` compiles the plan with a larger per-leaf H *capacity* and
  turns the actual H into a runtime input of the executor (a step mask,
  ``core/engine/plan.py::steps_for_h``): ``Session.run(local_h=...)``
  then runs any H schedule up to the cap through the same executor;
* ``compression=`` compresses the up-link syncs (one spec, a per-depth
  list, or ``"auto"`` under ``rounds="auto"``, where the eq.-(12)
  machinery picks per level), and the simulated clocks charge the
  compressed link delays;
* ``DelayModel(straggler=StragglerModel(...))`` makes ``rounds="auto"``
  plan H jointly with the ``BoundedSkip`` threshold over the topology's
  per-leaf delays (``core/delay.py::optimal_h_bounded_skip``); the
  threshold is ``resolved.skip`` and ``Session.straggler_policy()``
  builds the policy that runs it;
* ``acceleration=`` selects the accelerated ``sdca_acc`` method (server
  momentum, the coefficient a runtime scalar of the executor).

The JAX package's ``api/schedule.py``.  ``resolved.ckpt_every`` (the
Young/Daly period of ``DelayModel(mtbf=, ckpt_write=)``) is what
``CheckpointPolicy(every="auto")`` runs (``runtime/fault.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from repro_torch.api.topology import Topology
from repro_torch.core import compression as comp_mod
from repro_torch.core.delay import (StragglerModel, checkpoint_period,
                                    choose_compression, plan_hierarchical_h)
from repro_torch.core.tree import TreeNode


@dataclasses.dataclass(frozen=True)
class DelayModel:
    """Parameters of the paper's SS6 delay-aware bound (eq. (11)-(12)).

    ``t_total`` is the simulated wall-clock budget the auto-planner
    optimizes for; ``delta`` defaults to 1/m_leaf (one coordinate's share of
    a leaf block); ``t_cp`` defaults to the topology's own per-aggregation
    cost (``Topology.internal_t_cp``); ``h_max`` caps the per-level H
    search.

    ``C="auto"`` calibrates the improvement constant from a short pilot
    run instead of taking it as given: ``Session.compile`` runs
    ``pilot_rounds`` root rounds under the topology's default schedule on
    the session's own backend and device, fits C from the observed
    per-round gap contractions (``core/delay.py::fit_C``), and plans with
    the fitted value (inspectable as ``session.fitted_C``).

    ``straggler`` (a ``core/delay.py::StragglerModel``) switches the
    planner to the straggler-aware variant: the innermost level's H is
    optimized jointly with the bounded-skip threshold (``0..skip_max``)
    over the topology's per-leaf sync delays
    (``core/delay.py::optimal_h_bounded_skip``) -- dropping stragglers
    shrinks the effective barrier delay but dilutes eq. (11)'s per-round
    improvement by the participation fraction.

    ``mtbf`` (mean time between failures, simulated seconds) together
    with ``ckpt_write`` (the cost of one checkpoint write) makes the
    round-time model fault-aware: the resolved schedule carries the
    Young/Daly-optimal checkpoint period
    (``core/delay.py::checkpoint_period``) as ``resolved.ckpt_every``,
    and ``rounds="auto"``'s time budget charges the amortized
    write cost (``t_round + ckpt_write / period`` per root round)."""
    t_total: float
    C: Union[float, str] = 0.5
    delta: Optional[float] = None
    t_cp: Optional[float] = None
    h_max: int = 10**6
    pilot_rounds: int = 8
    straggler: Optional[StragglerModel] = None
    skip_max: int = 3
    ckpt_write: float = 0.0
    mtbf: Optional[float] = None

    def __post_init__(self):
        if isinstance(self.C, str) and self.C != "auto":
            raise ValueError(
                f"C must be a float or the string 'auto', got {self.C!r}")
        # pilot_rounds only matters when a pilot will actually run
        if self.C == "auto" and self.pilot_rounds < 2:
            raise ValueError(
                f"pilot_rounds must be >= 2 (fit_C needs at least two "
                f"observations), got {self.pilot_rounds}")
        if self.skip_max < 0:
            raise ValueError(
                f"skip_max must be >= 0, got {self.skip_max}")
        if self.ckpt_write < 0:
            raise ValueError(
                f"ckpt_write must be >= 0, got {self.ckpt_write}")
        if self.mtbf is not None and not self.mtbf > 0:
            raise ValueError(f"mtbf must be > 0, got {self.mtbf}")


@dataclasses.dataclass(frozen=True)
class ResolvedSchedule:
    """A Schedule bound to one Topology: concrete per-depth round counts.

    ``chunk_tree`` is the full tree with the root pinned to ONE round --
    the unit :class:`~repro_torch.api.session.Session` compiles and then
    iterates ``rounds`` times.

    ``runtime_h`` (set iff the schedule declared an ``h_cap``) is the
    per-leaf local-H the session should EXECUTE at runtime via step masks;
    the ``chunk_tree`` leaves then carry the (larger) compiled H capacity.
    ``skip`` / ``straggler_model`` carry the straggler-aware planner's
    jointly optimized bounded-skip threshold (``rounds="auto"`` with
    ``DelayModel(straggler=...)``).

    ``compression`` is the resolved TOP-DOWN per-depth edge-compression
    spec tuple (entry ``d`` compresses the up-links into depth-``d``
    nodes -- the form ``core/engine/plan.py::compile_tree`` consumes) or
    ``None``;
    the simulated clocks (``per_round_time``/``round_time_for``) charge
    the COMPRESSED link delays (each edge's ``up_delay`` scaled by its
    spec's wire ratio).

    ``ckpt_every`` (set iff the schedule's :class:`DelayModel` declared an
    ``mtbf``) is the Young/Daly-optimal checkpoint period in root rounds
    (``core/delay.py::checkpoint_period``)."""
    chunk_tree: TreeNode
    rounds: int                      # default root-round count for run()
    weighting: str
    per_round_time: float            # simulated seconds per root round
    level_plan: Optional[List[dict]]  # eq.-(12) output when rounds="auto"
    runtime_h: Optional[tuple] = None  # per-leaf runtime H under h_cap
    skip: Optional[int] = None         # planned BoundedSkip threshold
    straggler_model: Optional[StragglerModel] = None
    compression: Optional[tuple] = None  # top-down per-depth specs
    ckpt_every: Optional[int] = None   # Young/Daly period (root rounds)

    @property
    def full_tree(self) -> TreeNode:
        """The equivalent monolithic tree (root runs all ``rounds``)."""
        return dataclasses.replace(self.chunk_tree, rounds=self.rounds)

    def round_time_for(self, local_h=None) -> float:
        """Simulated seconds of one root round under runtime local-H
        ``local_h`` (scalar or per-leaf; ``None`` -> the schedule's own
        per-round time).  Runtime H is clamped to the compiled per-leaf
        capacity, exactly as the executors' step masks clamp it."""
        if local_h is None:
            return self.per_round_time
        t = runtime_tree(self.chunk_tree, local_h)
        return compressed_time_tree(t, self.compression).solve_time()


def leaf_h_spec(h, n_leaves: int) -> np.ndarray:
    """Normalize a runtime local-H spec -- a scalar, a per-leaf ``(n,)``
    vector, or a per-slot ``(S, n)`` array -- to per-leaf ``(n,)`` counts
    (per-slot specs reduce to their per-leaf MAX, the slot that binds the
    round's compute), as the session's simulated clock reads them."""
    arr = np.asarray(h, np.int64)
    if arr.ndim == 2:
        arr = arr.max(axis=0)
    return np.broadcast_to(arr, (n_leaves,))


def runtime_tree(chunk_tree: TreeNode, h) -> TreeNode:
    """The chunk tree with its leaves clamped to the RUNTIME local-H
    schedule ``h`` (scalar, per-leaf, or per-slot; ``None`` = the
    compiled tree itself) -- the tree whose compute time the simulated
    clocks charge when step masks gate trailing iterations off.  Runtime
    H never exceeds a leaf's compiled capacity."""
    if h is None:
        return chunk_tree
    leaves = chunk_tree.leaves()
    hs = leaf_h_spec(h, len(leaves))
    hs = [min(int(v), int(l.rounds)) for v, l in zip(hs, leaves, strict=True)]
    return _apply_rounds(chunk_tree, 0, [0],
                         leaf_steps_of=lambda i, name: hs[i],
                         rounds_of_depth=lambda d: None)


def compressed_time_tree(tree: TreeNode,
                         level_spec: Optional[Sequence]) -> TreeNode:
    """A copy of ``tree`` with every up-link delay scaled by its edge's
    compression wire ratio -- what the simulated clocks should charge when
    deltas ship compressed.  ``level_spec`` is the top-down per-depth
    default (entry ``d`` = up-links into depth-``d`` nodes, the
    ``compile_tree`` convention); a node's own ``up_compress`` overrides
    it, exactly as plan compilation does.  Treats the whole ``up_delay``
    as bandwidth-bound (the ``core/delay.py::FixedLevel`` default
    view -- ``TreeNode.up_delay`` does not split latency out)."""
    def visit(node: TreeNode, depth: int) -> TreeNode:
        kids = tuple(visit(c, depth + 1) for c in node.children)
        if kids != node.children:
            node = dataclasses.replace(node, children=kids)
        if depth == 0:
            return node
        spec = node.up_compress or (
            level_spec[depth - 1]
            if level_spec is not None and depth - 1 < len(level_spec)
            else None)
        if not spec:
            return node
        kind, frac = comp_mod.parse_spec(spec)
        ratio = comp_mod.wire_ratio(kind, frac)
        if ratio == 1.0:
            return node
        return dataclasses.replace(node, up_delay=node.up_delay * ratio)
    return visit(tree, 0)


def _leaf_steps_resolver(tree: TreeNode, local_steps):
    """Normalize a ``local_steps`` spec -- ``None``, an int, a ``{leaf
    name: H}`` dict, or a left-to-right per-leaf sequence -- into a
    ``(leaf_index, leaf_name) -> Optional[int]`` lookup."""
    if local_steps is None or isinstance(local_steps, int):
        return lambda i, name: local_steps
    leaves = tree.leaves()
    if isinstance(local_steps, dict):
        unknown = set(local_steps) - {l.name for l in leaves}
        if unknown:
            raise ValueError(
                f"local_steps names unknown leaves {sorted(unknown)}; "
                f"topology leaves are {[l.name for l in leaves]}")
        return lambda i, name: local_steps.get(name)
    seq = [int(v) for v in local_steps]
    if len(seq) != len(leaves):
        raise ValueError(
            f"per-leaf local_steps must list all {len(leaves)} leaves "
            f"left-to-right, got {len(seq)} entries")
    return lambda i, name: seq[i]


def _apply_rounds(
    node: TreeNode, depth: int, counter, *,
    leaf_steps_of,    # callable (leaf index, leaf name) -> Optional[int]
    rounds_of_depth,  # callable depth -> Optional[int]
) -> TreeNode:
    if node.is_leaf:
        i = counter[0]
        counter[0] += 1
        r = leaf_steps_of(i, node.name)
        if r is None:
            return node
        return dataclasses.replace(node, rounds=int(r))
    kids = tuple(
        _apply_rounds(c, depth + 1, counter, leaf_steps_of=leaf_steps_of,
                      rounds_of_depth=rounds_of_depth)
        for c in node.children)
    r = rounds_of_depth(depth)
    return dataclasses.replace(node, children=kids,
                               rounds=node.rounds if r is None else r)


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Round counts per tree level.

    * ``rounds``: root rounds -- an int, ``None`` (use the topology's
      default), or ``"auto"`` (eq.-(12) planning; requires ``delay``).
    * ``level_rounds``: per-internal-depth rounds below the root, top-down
      (depth 1, 2, ...); ``None`` keeps the topology's defaults.
    * ``local_steps``: H at the leaves -- an int, a ``{leaf_name: H}``
      dict, or a left-to-right per-leaf sequence (heterogeneous H for
      imbalanced leaf datasets); ``None`` keeps the defaults.
    * ``h_cap``: compile the plan with this per-leaf H *capacity* and make
      the executed H a RUNTIME input: the session runs ``local_steps``
      (or the topology's defaults) via step masks, and ``run(local_h=)``
      swaps in any other H up to the cap.
    * ``weighting``: ``"uniform"`` (paper 1/K) or ``"size"``
      (|block|-proportional, CoCoA-style).
    * ``delay``: the :class:`DelayModel` driving ``rounds="auto"``.
    * ``compression``: delta compression of the up-link syncs -- ``None``
      (only the topology's per-edge ``up_compress`` overrides apply), one
      spec string (``"none"``/``"int8"``/``"topk_<frac>"``) for every
      depth, a top-down per-depth sequence, or ``"auto"`` (requires
      ``rounds="auto"``: ``core/delay.py::choose_compression`` picks per
      level by the eq.-(12) bound -- slow bandwidth-bound hops
      compress, fast ones stay exact).  The resolved specs ride on
      ``ResolvedSchedule.compression`` into plan compilation, and the
      simulated clocks charge the compressed link delays.
    * ``acceleration``: Nesterov-style momentum coefficient on the server
      combine (Ma et al., arXiv 1711.05305) in ``[0, 1]``.  ``None``
      (default) runs the plain ``"sdca"`` method; any float -- ``0.0``
      included, which is bit-identical to plain -- selects
      ``get_method("sdca_acc")``, with the coefficient a runtime scalar
      of the executor.  ``rounds="auto"`` plans under the accelerated
      per-round factor.
    """
    rounds: Union[int, str, None] = None
    local_steps: Union[int, Sequence[int], Dict[str, int], None] = None
    level_rounds: Optional[Sequence[int]] = None
    weighting: str = "uniform"
    delay: Optional[DelayModel] = None
    h_cap: Optional[int] = None
    compression: Union[str, Sequence, None] = None
    acceleration: Optional[float] = None

    def __post_init__(self):
        if self.acceleration is not None \
                and not 0.0 <= float(self.acceleration) <= 1.0:
            raise ValueError(
                f"acceleration must be in [0, 1] (0 = plain SDCA, 1 = full "
                f"Nesterov rate); got {self.acceleration}")

    @classmethod
    def auto(cls, t_total: float, *, C: Union[float, str] = 0.5,
             delta: Optional[float] = None, t_cp: Optional[float] = None,
             h_max: int = 10**6, weighting: str = "uniform",
             pilot_rounds: int = 8,
             straggler: Optional[StragglerModel] = None,
             skip_max: int = 3, h_cap: Optional[int] = None,
             compression: Union[str, Sequence, None] = None,
             acceleration: Optional[float] = None) -> "Schedule":
        """Shorthand for ``Schedule(rounds="auto", delay=DelayModel(...))``
        (``C="auto"`` calibrates C from a pilot run at compile time;
        ``straggler=`` switches to the straggler-aware joint (H, skip)
        planner; ``h_cap=`` keeps the planned H a runtime input so
        adaptive sessions can replan it;
        ``compression="auto"`` lets the same eq.-(12) machinery choose
        per-level delta compression; ``acceleration=`` runs and plans the
        accelerated server-momentum flavor)."""
        return cls(rounds="auto", weighting=weighting, h_cap=h_cap,
                   compression=compression, acceleration=acceleration,
                   delay=DelayModel(t_total=t_total, C=C, delta=delta,
                                    t_cp=t_cp, h_max=h_max,
                                    pilot_rounds=pilot_rounds,
                                    straggler=straggler, skip_max=skip_max))

    def _normalized_compression(self, D: int) -> Optional[tuple]:
        """The top-down per-depth spec tuple for a depth-``D`` topology
        (validated), or ``None``.  ``"auto"`` is resolved elsewhere."""
        c = self.compression
        if c is None:
            return None
        if isinstance(c, str):
            comp_mod.parse_spec(c)  # fail fast on typos
            return (c,) * D
        out = tuple(None if v in (None, "") else str(v) for v in c)
        if len(out) != D:
            raise ValueError(
                f"per-depth compression must list all {D} internal depths "
                f"top-down, got {len(out)} entries")
        for v in out:
            if v is not None:
                comp_mod.parse_spec(v)
        return out

    # -----------------------------------------------------------------
    def resolve(self, topology: Topology) -> ResolvedSchedule:
        """Bind to ``topology``: produce concrete per-depth round counts."""
        if self.rounds == "auto":
            return self._resolve_auto(topology)
        if isinstance(self.rounds, str):
            raise ValueError(
                f"rounds must be an int, None, or 'auto'; got {self.rounds!r}")
        if self.compression == "auto":
            raise ValueError(
                "compression='auto' needs rounds='auto' (the eq.-(12) "
                "DelayModel chooses the per-level specs)")
        comp = self._normalized_compression(topology.depth)

        level = dict(enumerate(self.level_rounds or (), start=1))
        tree = _apply_rounds(
            topology.tree, 0, [0],
            leaf_steps_of=_leaf_steps_resolver(topology.tree,
                                               self.local_steps),
            rounds_of_depth=lambda d: None if d == 0 else level.get(d))
        rounds = topology.tree.rounds if self.rounds is None else \
            int(self.rounds)
        if rounds < 0:
            raise ValueError(f"rounds must be >= 0, got {rounds}")
        tree, runtime_h = self._apply_h_cap(tree)
        chunk = dataclasses.replace(tree, rounds=1)
        resolved = ResolvedSchedule(
            chunk_tree=chunk, rounds=rounds, weighting=self.weighting,
            per_round_time=compressed_time_tree(chunk, comp).solve_time(),
            level_plan=None, runtime_h=runtime_h, compression=comp)
        if runtime_h is not None:
            # the simulated clock charges the RUNTIME H, not the capacity
            resolved = dataclasses.replace(
                resolved, per_round_time=resolved.round_time_for(runtime_h))
        return self._with_ckpt_plan(resolved)

    def _with_ckpt_plan(self, resolved: ResolvedSchedule) -> ResolvedSchedule:
        """Attach the Young/Daly checkpoint period when the DelayModel is
        fault-aware (``mtbf`` declared)."""
        dm = self.delay
        if dm is None or dm.mtbf is None:
            return resolved
        every = checkpoint_period(
            resolved.per_round_time, dm.ckpt_write, dm.mtbf,
            max_period=max(resolved.rounds, 1))
        return dataclasses.replace(resolved, ckpt_every=every)

    def _apply_h_cap(self, tree: TreeNode):
        """Pad the leaves to the ``h_cap`` capacity; the displaced per-leaf
        counts become the session's runtime H (executed via step masks)."""
        if self.h_cap is None:
            return tree, None
        cap = int(self.h_cap)
        runtime_h = tuple(l.rounds for l in tree.leaves())
        if cap < max(runtime_h):
            raise ValueError(
                f"h_cap={cap} is below the schedule's own local steps "
                f"(max {max(runtime_h)}); the capacity must cover every "
                "H the session should be able to execute")
        padded = _apply_rounds(
            tree, 0, [0], leaf_steps_of=lambda i, name: cap,
            rounds_of_depth=lambda d: None)
        return padded, runtime_h

    def _resolve_auto(self, topology: Topology) -> ResolvedSchedule:
        if self.delay is None:
            raise ValueError(
                "Schedule(rounds='auto') needs delay=DelayModel(t_total=...)")
        if isinstance(self.delay.C, str):
            raise ValueError(
                "DelayModel(C='auto') needs a pilot run to calibrate C, "
                "which requires the problem data: resolve this schedule "
                "through Session.compile(problem, topology, schedule) "
                "instead of Schedule.resolve(topology)")
        if self.local_steps is not None or self.level_rounds is not None:
            raise ValueError(
                "rounds='auto' plans local_steps/level_rounds itself; "
                "don't pass them explicitly")
        dm = self.delay
        levels = topology.sync_levels()      # innermost first, length D
        t_lp = topology.leaf_t_lp()
        if not t_lp > 0:
            raise ValueError(
                "rounds='auto' needs leaf t_lp > 0 (the delay trade-off is "
                "meaningless with free local iterations)")
        m_leaf = topology.tree.leaves()[0].data_size
        delta = dm.delta if dm.delta is not None else 1.0 / m_leaf
        t_cp = dm.t_cp if dm.t_cp is not None else topology.internal_t_cp()
        D = len(levels)
        if self.compression == "auto":
            # eq.-(12) per-level spec choice: cheaper compressed rounds vs.
            # the diluted improvement constant, innermost-first
            comp_rows = choose_compression(
                levels, C=dm.C, delta=delta, t_total=dm.t_total, t_lp=t_lp,
                t_cp=t_cp, h_max=dm.h_max,
                acceleration=self.acceleration or 0.0)
            comp_levels = [r["spec"] for r in comp_rows]
            comp = tuple(reversed(comp_levels))  # innermost-first -> top-down
        else:
            comp = self._normalized_compression(D)
            comp_levels = list(reversed(comp)) if comp is not None else None
        lp = plan_hierarchical_h(
            levels, C=dm.C, delta=delta, t_total=dm.t_total, t_lp=t_lp,
            t_cp=t_cp, h_max=dm.h_max,
            # the compiled capacity bounds the innermost search space, so
            # the planned round times / root budget stay consistent with
            # what the executors can actually run
            h_max0=self.h_cap,
            straggler=dm.straggler, skip_max=dm.skip_max,
            base_delays=(topology.leaf_sync_delays()
                         if dm.straggler is not None else None),
            compression=comp_levels,
            acceleration=self.acceleration or 0.0)
        # lp[0] plans the leaves' H; lp[i] (i >= 1) plans how many rounds of
        # the level below one sync at internal depth D-1-i amortizes; the
        # root's own count comes from the time budget.
        local_steps = int(lp[0]["H"])
        rounds_of = {D - i: int(lp[i]["H"]) for i in range(1, D)}
        tree = _apply_rounds(
            topology.tree, 0, [0],
            leaf_steps_of=lambda i, name: local_steps,
            rounds_of_depth=lambda d: None if d == 0 else rounds_of.get(d))
        # fault-aware budget: every root round additionally pays the
        # AMORTIZED checkpoint-write cost at the Young/Daly period
        budget_round_time = lp[-1]["round_time"]
        if dm.mtbf is not None:
            period = checkpoint_period(budget_round_time, dm.ckpt_write,
                                       dm.mtbf)
            budget_round_time += dm.ckpt_write / period
        root_rounds = max(1, int(dm.t_total / budget_round_time))
        tree, runtime_h = self._apply_h_cap(tree)
        chunk = dataclasses.replace(tree, rounds=1)
        resolved = ResolvedSchedule(
            chunk_tree=chunk, rounds=root_rounds, weighting=self.weighting,
            per_round_time=compressed_time_tree(chunk, comp).solve_time(),
            level_plan=lp, runtime_h=runtime_h, skip=lp[0].get("skip"),
            straggler_model=dm.straggler, compression=comp)
        if runtime_h is not None:
            resolved = dataclasses.replace(
                resolved, per_round_time=resolved.round_time_for(runtime_h))
        return self._with_ckpt_plan(resolved)
