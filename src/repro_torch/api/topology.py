"""The :class:`Topology` object: a serializable tree-network spec.

Wraps :class:`~repro_torch.core.tree.TreeNode` with builders for the
paper's network families (star, balanced multi-level, two-level,
imbalanced groups) and a stable dict/JSON wire format -- the same format
as the JAX package's ``Topology``, so a topology serialized by one loads
in the other.  Round counts on the tree are defaults; a Schedule may
override them.  Not ported yet: the delay-planner view (``sync_levels``,
ROADMAP A6), ``from_mesh`` (A11) and the elastic membership edits (A10).
"""
from __future__ import annotations

import dataclasses
import json
from typing import List, Optional, Sequence

from repro_torch.core import tree as tree_mod
from repro_torch.core.tree import TreeNode


def _node_to_dict(node: TreeNode) -> dict:
    d = {
        "name": node.name,
        "rounds": node.rounds,
        "up_delay": node.up_delay,
        "t_cp": node.t_cp,
        "t_lp": node.t_lp,
        "data_size": node.data_size,
    }
    if node.up_compress:
        d["up_compress"] = node.up_compress
    if node.children:
        d["children"] = [_node_to_dict(c) for c in node.children]
    return d


def _node_from_dict(d: dict) -> TreeNode:
    return TreeNode(
        name=d["name"],
        children=tuple(_node_from_dict(c) for c in d.get("children", ())),
        rounds=int(d.get("rounds", 1)),
        up_delay=float(d.get("up_delay", 0.0)),
        t_cp=float(d.get("t_cp", 0.0)),
        t_lp=float(d.get("t_lp", 0.0)),
        data_size=int(d.get("data_size", 0)),
        up_compress=str(d.get("up_compress", "")),
    )


@dataclasses.dataclass(frozen=True)
class Topology:
    """A tree network.  The root is always an internal node."""
    tree: TreeNode

    def __post_init__(self):
        if self.tree.is_leaf:
            raise ValueError("a Topology's root must be an internal node")
        names = [l.name for l in self.tree.leaves()]
        if len(set(names)) != len(names):
            raise ValueError(f"leaf names must be unique, got {names}")

    # ---- structure queries ---------------------------------------------
    @property
    def n_leaves(self) -> int:
        return len(self.tree.leaves())

    @property
    def m_total(self) -> int:
        return self.tree.total_data()

    @property
    def depth(self) -> int:
        """Number of internal depths (star = 1, two-level = 2, ...)."""
        return self.tree.depth()

    def leaf_sizes(self) -> List[int]:
        return [l.data_size for l in self.tree.leaves()]

    # ---- serialization -------------------------------------------------
    def to_dict(self) -> dict:
        return _node_to_dict(self.tree)

    @classmethod
    def from_dict(cls, d: dict) -> "Topology":
        return cls(tree=_node_from_dict(d))

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), **kw)

    @classmethod
    def from_json(cls, s: str) -> "Topology":
        return cls.from_dict(json.loads(s))

    # ---- builders ------------------------------------------------------
    @classmethod
    def from_tree(cls, tree: TreeNode) -> "Topology":
        return cls(tree=tree)

    @classmethod
    def star(
        cls, n_workers: int, m_per_worker: int, *,
        rounds: int = 10, local_steps: int = 64,
        t_lp: float = 0.0, t_cp: float = 0.0, t_delay: float = 0.0,
    ) -> "Topology":
        """The CoCoA star network (paper Fig. 1 / Algorithm 1)."""
        return cls(tree=tree_mod.star(
            n_workers, m_per_worker, outer_rounds=rounds,
            local_steps=local_steps, t_lp=t_lp, t_cp=t_cp, t_delay=t_delay))

    @classmethod
    def two_level(
        cls, n_groups: int, workers_per_group: int, m_per_worker: int, *,
        root_rounds: int = 10, group_rounds: int = 2, local_steps: int = 64,
        t_lp: float = 0.0, t_cp: float = 0.0,
        root_delay: float = 0.0, group_delay: float = 0.0,
    ) -> "Topology":
        """Paper Fig. 2: root -> sub-centers -> workers."""
        return cls(tree=tree_mod.two_level(
            n_groups, workers_per_group, m_per_worker,
            root_rounds=root_rounds, group_rounds=group_rounds,
            local_steps=local_steps, t_lp=t_lp, t_cp=t_cp,
            root_delay=root_delay, group_delay=group_delay))

    @classmethod
    def balanced(
        cls, branching: Sequence[int], *, m_leaf: int,
        local_steps: int = 64, level_rounds: Optional[Sequence[int]] = None,
        level_delays: Optional[Sequence[float]] = None,
        t_lp: float = 0.0, t_cp: float = 0.0,
    ) -> "Topology":
        """A level-homogeneous tree, top-down: ``branching[i]`` children per
        node at internal depth ``i``.  ``level_rounds[i]`` are the depth-i
        round defaults (all 1 if omitted); ``level_delays[i]`` is the
        up-link delay of the children *under* depth ``i`` (0 if omitted)."""
        L = len(branching)
        rounds = list(level_rounds) if level_rounds is not None else [1] * L
        delays = list(level_delays) if level_delays is not None else [0.0] * L
        assert len(rounds) == L and len(delays) == L, (branching, rounds,
                                                       delays)

        def build(d: int, path: tuple, up: float) -> TreeNode:
            tag = "-".join(str(p) for p in path)
            if d == L:
                return TreeNode(name=f"L{tag}", rounds=local_steps,
                                data_size=m_leaf, t_lp=t_lp, up_delay=up)
            kids = tuple(build(d + 1, path + (k,), delays[d])
                         for k in range(branching[d]))
            name = "root" if d == 0 else f"N{tag}"
            return TreeNode(name=name, children=kids, rounds=rounds[d],
                            t_cp=t_cp, up_delay=up)
        return cls(tree=build(0, (), 0.0))

    @classmethod
    def groups(
        cls, group_sizes: Sequence[Sequence[int]], *,
        root_rounds: int = 10, group_rounds: int = 2, local_steps: int = 64,
        t_lp: float = 0.0, t_cp: float = 0.0,
        root_delay: float = 0.0, group_delay: float = 0.0,
    ) -> "Topology":
        """An imbalanced/heterogeneous two-level tree: one sub-center per
        entry of ``group_sizes``, whose leaves own the listed (possibly
        unequal) data-block sizes; singleton groups may be passed as bare
        ints, attaching that leaf directly to the root (mixed depth)."""
        children = []
        for g, sizes in enumerate(group_sizes):
            if isinstance(sizes, int):
                children.append(TreeNode(
                    name=f"W{g}", rounds=local_steps, data_size=sizes,
                    t_lp=t_lp, up_delay=root_delay))
                continue
            ws = tuple(
                TreeNode(name=f"W{g}-{j}", rounds=local_steps, data_size=sz,
                         t_lp=t_lp, up_delay=group_delay)
                for j, sz in enumerate(sizes))
            children.append(TreeNode(
                name=f"S{g}", children=ws, rounds=group_rounds,
                up_delay=root_delay, t_cp=t_cp))
        return cls(tree=TreeNode(name="root", children=tuple(children),
                                 rounds=root_rounds, t_cp=t_cp))
