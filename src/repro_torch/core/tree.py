"""Tree-network topology description for TreeDualMethod (plain Python,
the same record as the JAX package's ``core/tree.py``).

A TreeNode is either a leaf (owns a contiguous block of data columns) or an
internal node with K children. Every node carries:
  * ``rounds``   -- T (internal; R at the root) or H (leaf: # LocalSDCA steps)
  * ``up_delay`` -- round-trip communication delay to its *parent* (seconds)
  * ``t_cp``     -- computation time of one aggregation at this node (internal)
  * ``t_lp``     -- computation time of one coordinate step (leaf)
  * ``up_compress`` -- delta-compression spec of the up-link to the parent
    (``""`` inherits the schedule's per-level default; otherwise ``"none"``,
    ``"int8"``, ``"topk"`` or ``"topk_<frac>"``; this package runs
    uncompressed edges only so far)

Data assignment: leaves, in left-to-right order, own contiguous column blocks
whose sizes are given by ``data_size`` (leaf-only).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class TreeNode:
    name: str
    children: Tuple["TreeNode", ...] = ()
    rounds: int = 1
    up_delay: float = 0.0
    t_cp: float = 0.0
    t_lp: float = 0.0
    data_size: int = 0  # leaves only
    up_compress: str = ""  # per-edge compression override ("" = inherit)

    @property
    def is_leaf(self) -> bool:
        return not self.children

    # ---- structure -----------------------------------------------------
    def leaves(self) -> List["TreeNode"]:
        if self.is_leaf:
            return [self]
        out: List[TreeNode] = []
        for c in self.children:
            out.extend(c.leaves())
        return out

    def depth(self) -> int:
        if self.is_leaf:
            return 0
        return 1 + max(c.depth() for c in self.children)

    def total_data(self) -> int:
        return sum(l.data_size for l in self.leaves())

    def leaf_slices(self, start: int = 0) -> List[Tuple[str, slice]]:
        """(leaf name, column slice) pairs, left-to-right contiguous blocks."""
        out: List[Tuple[str, slice]] = []
        off = start
        for l in self.leaves():
            out.append((l.name, slice(off, off + l.data_size)))
            off += l.data_size
        return out

    # ---- timing (paper SS6 generalized to trees) -------------------------
    def round_time(self) -> float:
        """Wall-clock cost of ONE round at this node.

        leaf:     H * t_lp
        internal: max_k (child_k.round_time()*child_k.rounds + child_k.up_delay)
                  + t_cp
        Children run in parallel; the synchronous barrier waits for the
        slowest child including its uplink delay (paper eq. (9) when the
        tree is a star: H*t_lp + t_delay + t_cp).
        """
        if self.is_leaf:
            return self.rounds * self.t_lp
        slowest = max(c.round_time() * 1.0 + c.up_delay for c in self.children)
        return slowest + self.t_cp

    def child_phase_time(self) -> float:
        """Time for one *full child solve* (child rounds included)."""
        if self.is_leaf:
            return self.round_time()
        return (
            max(c.child_phase_time() * c.rounds_if_internal() + c.up_delay
                for c in self.children)
            + self.t_cp
        )

    def rounds_if_internal(self) -> int:
        # A leaf's "rounds" are its H coordinate steps, already inside
        # round_time(); an internal child re-runs its T rounds per parent call.
        return 1 if self.is_leaf else self.rounds

    def solve_time(self) -> float:
        """Total wall-clock for one full invocation of TreeDualMethod here."""
        if self.is_leaf:
            return self.rounds * self.t_lp
        per_round = (
            max(c.solve_time() + c.up_delay for c in self.children) + self.t_cp
        )
        return self.rounds * per_round


# ---------------------------------------------------------------------------
# constructors
# ---------------------------------------------------------------------------
def star(
    n_workers: int,
    m_per_worker: int,
    *,
    outer_rounds: int,
    local_steps: int,
    t_lp: float = 0.0,
    t_cp: float = 0.0,
    t_delay: float = 0.0,
) -> TreeNode:
    """The CoCoA star network (paper Fig. 1 / Algorithm 1)."""
    workers = tuple(
        TreeNode(
            name=f"W{k}", rounds=local_steps, up_delay=t_delay,
            t_lp=t_lp, data_size=m_per_worker,
        )
        for k in range(n_workers)
    )
    return TreeNode(name="root", children=workers, rounds=outer_rounds, t_cp=t_cp)


def two_level(
    n_groups: int,
    workers_per_group: int,
    m_per_worker: int,
    *,
    root_rounds: int,
    group_rounds: int,
    local_steps: int,
    t_lp: float = 0.0,
    t_cp: float = 0.0,
    root_delay: float = 0.0,
    group_delay: float = 0.0,
) -> TreeNode:
    """Paper Fig. 2: root -> sub-centers S_i -> workers W_ij."""
    groups = []
    for g in range(n_groups):
        ws = tuple(
            TreeNode(
                name=f"W{g}{j}", rounds=local_steps, up_delay=group_delay,
                t_lp=t_lp, data_size=m_per_worker,
            )
            for j in range(workers_per_group)
        )
        groups.append(
            TreeNode(
                name=f"S{g}", children=ws, rounds=group_rounds,
                up_delay=root_delay, t_cp=t_cp,
            )
        )
    return TreeNode(name="root", children=tuple(groups), rounds=root_rounds,
                    t_cp=t_cp)


def strip_delays(node: TreeNode) -> TreeNode:
    """A copy of the tree with every up-link delay zeroed: its
    ``solve_time`` is the compute-only component of a round, the base the
    straggler simulation adds sampled link delays on top of."""
    kids = tuple(strip_delays(c) for c in node.children)
    return dataclasses.replace(node, children=kids, up_delay=0.0)


def with_rounds(node: TreeNode, *, leaf_steps: Optional[int] = None,
                internal_rounds: Optional[int] = None) -> TreeNode:
    """Return a copy of the tree with round counts replaced."""
    if node.is_leaf:
        r = leaf_steps if leaf_steps is not None else node.rounds
        return dataclasses.replace(node, rounds=r)
    kids = tuple(
        with_rounds(c, leaf_steps=leaf_steps, internal_rounds=internal_rounds)
        for c in node.children
    )
    r = internal_rounds if internal_rounds is not None else node.rounds
    return dataclasses.replace(node, children=kids, rounds=r)
