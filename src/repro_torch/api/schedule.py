"""The :class:`Schedule` object: *how many* rounds at every tree level.

The paper's central knob is the local/global iteration trade-off (eq.
(9)-(12)).  A Schedule pins it explicitly: root ``rounds``, per-depth
``level_rounds`` and the leaves' ``local_steps`` (an int, a ``{leaf_name:
H}`` dict or a left-to-right sequence).  ``h_cap=`` compiles the plan with
a larger per-leaf H *capacity* and makes the executed H a runtime input
(a step mask), so ``Session.run(local_h=...)`` runs any H up to the cap
through the same executor.

Not ported yet, and refused with ``NotImplementedError``: ``rounds="auto"``
and the ``DelayModel`` behind it (needs ``core/delay.py``, ROADMAP A6),
edge ``compression=`` (A7) and ``acceleration=`` (A9).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Union

import numpy as np

from repro_torch.api.topology import Topology
from repro_torch.core.tree import TreeNode


@dataclasses.dataclass(frozen=True)
class ResolvedSchedule:
    """A Schedule bound to one Topology: concrete per-depth round counts.

    ``chunk_tree`` is the full tree with the root pinned to ONE round --
    the unit a Session compiles and iterates ``rounds`` times.
    ``runtime_h`` (set iff the schedule declared an ``h_cap``) is the
    per-leaf local H the session executes through step masks."""
    chunk_tree: TreeNode
    rounds: int
    weighting: str
    per_round_time: float            # simulated seconds per root round
    runtime_h: Optional[tuple] = None

    def round_time_for(self, local_h=None) -> float:
        """Simulated seconds of one root round under runtime local H
        (``None``: the schedule's own), clamped to the compiled capacity."""
        if local_h is None:
            return self.per_round_time
        return runtime_tree(self.chunk_tree, local_h).solve_time()


def leaf_h_spec(h, n_leaves: int) -> np.ndarray:
    """A runtime local-H spec -- scalar, per-leaf ``(n,)`` or per-slot
    ``(S, n)`` (reduced to its per-leaf max) -- as per-leaf counts."""
    arr = np.asarray(h, np.int64)
    if arr.ndim == 2:
        arr = arr.max(axis=0)
    return np.broadcast_to(arr, (n_leaves,))


def runtime_tree(chunk_tree: TreeNode, h) -> TreeNode:
    """The chunk tree with its leaves clamped to the runtime local-H
    schedule ``h`` (``None``: the tree itself)."""
    if h is None:
        return chunk_tree
    leaves = chunk_tree.leaves()
    hs = leaf_h_spec(h, len(leaves))
    hs = [min(int(v), int(l.rounds)) for v, l in zip(hs, leaves, strict=True)]
    return _apply_rounds(chunk_tree, 0, [0],
                         leaf_steps_of=lambda i, name: hs[i],
                         rounds_of_depth=lambda d: None)


def _leaf_steps_resolver(tree: TreeNode, local_steps):
    """``local_steps`` -- ``None``, an int, a ``{leaf name: H}`` dict, or a
    left-to-right sequence -- as a ``(leaf_index, leaf_name) -> H or
    None`` lookup."""
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


def _apply_rounds(node: TreeNode, depth: int, counter, *, leaf_steps_of,
                  rounds_of_depth) -> TreeNode:
    if node.is_leaf:
        i = counter[0]
        counter[0] += 1
        r = leaf_steps_of(i, node.name)
        return node if r is None else dataclasses.replace(node, rounds=int(r))
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

    * ``rounds``: root rounds -- an int or ``None`` (the topology's).
    * ``level_rounds``: rounds of internal depths 1, 2, ... (top-down);
      ``None`` keeps the topology's.
    * ``local_steps``: H at the leaves (int, ``{leaf_name: H}`` or a
      per-leaf sequence); ``None`` keeps the topology's.
    * ``h_cap``: compile this per-leaf H capacity and run ``local_steps``
      (or ``run(local_h=)``) through step masks.
    * ``weighting``: ``"uniform"`` (paper 1/K) or ``"size"``.
    * ``delay`` / ``compression`` / ``acceleration``: the reference's
      planner, codec and momentum knobs -- not ported yet.
    """
    rounds: Union[int, str, None] = None
    local_steps: Union[int, Sequence[int], Dict[str, int], None] = None
    level_rounds: Optional[Sequence[int]] = None
    weighting: str = "uniform"
    delay: object = None
    h_cap: Optional[int] = None
    compression: Union[str, Sequence, None] = None
    acceleration: Optional[float] = None

    def __post_init__(self):
        if self.rounds == "auto" or self.delay is not None:
            raise NotImplementedError(
                "rounds='auto' and DelayModel need core/delay.py, not "
                "ported yet (ROADMAP A6); pass explicit rounds")
        if isinstance(self.rounds, str):
            raise ValueError(f"rounds must be an int or None; got "
                             f"{self.rounds!r}")
        specs = [self.compression] if self.compression is None or isinstance(
            self.compression, str) else list(self.compression)
        if any(c not in (None, "", "none") for c in specs):
            raise NotImplementedError(
                "edge compression is not ported yet (ROADMAP A7)")
        if self.acceleration is not None:
            raise NotImplementedError(
                "accelerated server momentum is not ported yet (ROADMAP A9)")

    def resolve(self, topology: Topology) -> ResolvedSchedule:
        """Bind to ``topology``: produce concrete per-depth round counts."""
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
            per_round_time=chunk.solve_time(), runtime_h=runtime_h)
        if runtime_h is not None:
            # the simulated clock charges the RUNTIME H, not the capacity
            resolved = dataclasses.replace(
                resolved, per_round_time=resolved.round_time_for(runtime_h))
        return resolved

    def _apply_h_cap(self, tree: TreeNode):
        """Pad the leaves to the ``h_cap`` capacity; the displaced per-leaf
        counts become the session's runtime H."""
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
