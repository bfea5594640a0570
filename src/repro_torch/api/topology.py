"""The :class:`Topology` object: a serializable tree-network spec.

Wraps :class:`~repro_torch.core.tree.TreeNode` with builders for the
paper's network families (star, balanced multi-level, two-level,
imbalanced groups), a stable dict/JSON wire format -- the same format
as the JAX package's ``Topology``, so a topology serialized by one loads
in the other -- the delay views the eq.-(12) planner reads
(:meth:`Topology.sync_levels`, per-leaf sync delays, leaf and aggregation
costs), per-edge compression stamps (:meth:`Topology.with_compression`)
and the membership edits of elastic sessions (:meth:`Topology.with_leaf` /
:meth:`Topology.without_leaf`), and the tree of a ``DeviceMesh``
(:meth:`Topology.from_mesh`).  Round counts on the tree are defaults; a
Schedule may override them.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence

from repro_torch.core import compression as comp_mod
from repro_torch.core import tree as tree_mod
from repro_torch.core.delay import FixedLevel
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

    def sync_levels(self) -> List[FixedLevel]:
        """The per-depth sync structure, innermost first (the order
        ``core/delay.py::plan_hierarchical_h`` consumes).

        Requires structural level-homogeneity: one fan-out per internal
        depth and all leaves at the same depth with equal ``data_size`` and
        ``t_lp``.  The level delay is the slowest child up-link at that
        depth (the synchronous barrier waits for it)."""
        by_depth: Dict[int, set] = {}
        delays: Dict[int, float] = {}
        leaf_info = set()
        leaf_depths = set()

        def visit(node: TreeNode, depth: int):
            if node.is_leaf:
                leaf_depths.add(depth)
                leaf_info.add((node.data_size, node.t_lp))
                return
            by_depth.setdefault(depth, set()).add(len(node.children))
            for c in node.children:
                delays[depth] = max(delays.get(depth, 0.0), c.up_delay)
                visit(c, depth + 1)
        visit(self.tree, 0)

        D = max(by_depth) + 1
        if leaf_depths != {D}:
            raise ValueError(
                "sync_levels needs all leaves at one depth; got leaves at "
                f"depths {sorted(leaf_depths)} with internal depths 0..{D-1}")
        if len(leaf_info) != 1:
            raise ValueError(
                f"sync_levels needs congruent leaves, got {sorted(leaf_info)}")
        bad = {d: ks for d, ks in by_depth.items() if len(ks) != 1}
        if bad:
            raise ValueError(f"sync_levels needs one fan-out per depth: {bad}")
        return [
            FixedLevel(name=f"depth{d}", group_size=next(iter(by_depth[d])),
                       delay_s=delays[d])
            for d in range(D - 1, -1, -1)
        ]

    def leaf_sync_delays(self) -> List[float]:
        """Per-leaf nominal sync-path delay (seconds), leaf order: the sum
        of ``up_delay`` along the leaf's path to the root -- what one root
        round's barrier pays to hear from that leaf.  The base delays that
        ``Session.run(straggler=...)`` hands the
        ``StragglerModel`` sampler."""
        out: List[float] = []

        def visit(node: TreeNode, acc: float):
            acc += node.up_delay
            if node.is_leaf:
                out.append(acc)
                return
            for c in node.children:
                visit(c, acc)
        visit(self.tree, -self.tree.up_delay)  # the root has no up-link
        return out

    def leaf_t_lp(self) -> float:
        """The (homogeneous) per-coordinate-step cost at the leaves."""
        vals = {l.t_lp for l in self.tree.leaves()}
        if len(vals) != 1:
            raise ValueError(f"heterogeneous leaf t_lp: {sorted(vals)}")
        return vals.pop()

    def internal_t_cp(self) -> float:
        """The per-aggregation compute cost carried by the internal nodes
        (the slowest one: the barrier waits for it)."""
        def visit(node: TreeNode) -> float:
            if node.is_leaf:
                return 0.0
            return max([node.t_cp] + [visit(c) for c in node.children])
        return visit(self.tree)

    def with_compression(
        self, spec, *, names: Optional[Sequence[str]] = None,
        min_up_delay: Optional[float] = None,
    ) -> "Topology":
        """A copy with ``up_compress=spec`` stamped on matching up-links.

        With no filter every non-root edge gets the spec; ``names``
        restricts it to those nodes' up-links, ``min_up_delay`` to edges at
        least that slow -- the topological way to say "compress the
        cross-pod hops, leave the fast intra-pod links exact".  Filters
        compose (both must match).  Pass ``spec=""`` to clear overrides.
        """
        if spec:
            comp_mod.parse_spec(spec)  # fail fast on typos
        sel = set(names) if names is not None else None

        def visit(node: TreeNode, is_root: bool) -> TreeNode:
            kids = tuple(visit(c, False) for c in node.children)
            node = dataclasses.replace(node, children=kids)
            if is_root:
                return node
            if sel is not None and node.name not in sel:
                return node
            if min_up_delay is not None and node.up_delay < min_up_delay:
                return node
            return dataclasses.replace(node, up_compress=str(spec))
        return Topology(tree=visit(self.tree, True))

    # ---- membership editing (elastic sessions) -------------------------
    def leaf_names(self) -> List[str]:
        return [l.name for l in self.tree.leaves()]

    def leaf_span(self, name: str) -> "tuple[int, int]":
        """``(offset, size)`` of leaf ``name``'s block in the flat dual
        vector (leaves in tree order) -- where membership events splice
        alpha and the stacked (X, y) rows."""
        off = 0
        for l in self.tree.leaves():
            if l.name == name:
                return off, l.data_size
            off += l.data_size
        raise KeyError(f"no leaf named {name!r}")

    def without_leaf(self, name: str) -> "Topology":
        """A copy with leaf ``name`` permanently removed (the *leave* half
        of a membership event).  Internal nodes left childless are pruned
        with it; removing the last leaf is an error."""
        found = [False]

        def visit(node: TreeNode) -> Optional[TreeNode]:
            if node.is_leaf:
                if node.name == name:
                    found[0] = True
                    return None
                return node
            kids = tuple(k for k in (visit(c) for c in node.children)
                         if k is not None)
            if not kids:
                return None
            return dataclasses.replace(node, children=kids)

        new_root = visit(self.tree)
        if not found[0]:
            raise KeyError(f"no leaf named {name!r}")
        if new_root is None or new_root.is_leaf:
            raise ValueError(
                f"removing {name!r} leaves no usable tree (the root must "
                "keep at least one leaf under an internal node)")
        return Topology(tree=new_root)

    def with_leaf(
        self, name: str, *, parent: Optional[str] = None,
        data_size: int, local_steps: Optional[int] = None,
        up_delay: float = 0.0, t_lp: Optional[float] = None,
    ) -> "Topology":
        """A copy with a new leaf appended under internal node ``parent``
        (default: the root) -- the *join* half of a membership event.
        ``local_steps`` / ``t_lp`` default to the values the existing
        leaves share (their max / the first leaf's)."""
        if name in self.leaf_names():
            raise ValueError(f"leaf name {name!r} already exists")
        leaves = self.tree.leaves()
        if local_steps is None:
            local_steps = max(leaf.rounds for leaf in leaves)
        if t_lp is None:
            t_lp = leaves[0].t_lp
        target = parent if parent is not None else self.tree.name
        hit = [0]

        def visit(node: TreeNode) -> TreeNode:
            if node.is_leaf:
                return node
            kids = tuple(visit(c) for c in node.children)
            if node.name == target:
                hit[0] += 1
                kids = kids + (TreeNode(
                    name=name, rounds=int(local_steps),
                    data_size=int(data_size), up_delay=float(up_delay),
                    t_lp=float(t_lp)),)
            return dataclasses.replace(node, children=kids)

        new_root = visit(self.tree)
        if hit[0] != 1:
            raise KeyError(
                f"parent {target!r} matched {hit[0]} internal nodes; "
                "need exactly one")
        return Topology(tree=new_root)

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
    def from_mesh(
        cls, mesh, *, sync_axes: Sequence[str] = ("data", "pod"),
        periods: Optional[Sequence[int]] = None,
        level_delays: Optional[Sequence[float]] = None,
        t_lp: float = 0.0, t_cp: float = 0.0, m_leaf: int = 1,
    ) -> "Topology":
        """The LM-training tree of a ``DeviceMesh``: one leaf per replica,
        one internal level per sync axis.

        ``sync_axes`` are bottom-up (fastest link first); axes missing
        from the mesh or of size 1 are dropped.  ``periods[i]`` (bottom-up,
        default all 1) is the number of level-i rounds per level-(i+1)
        sync -- the leaves' local H and the internal rounds of the tree,
        what ``Schedule(rounds="auto")`` re-plans from ``level_delays[i]``,
        the delay of the link crossing axis ``i``.  The root runs 1 round:
        the run length is the Schedule's.  ``m_leaf`` is a nominal per-leaf
        data size (it only feeds the delay model's bandwidth terms)."""
        from repro_torch.launch.mesh import axis_size

        axes = tuple(a for a in sync_axes
                     if a in tuple(mesh.mesh_dim_names or ())
                     and axis_size(mesh, a) > 1)
        sizes = [axis_size(mesh, a) for a in axes]       # bottom-up
        L = len(axes)
        if L == 0:
            # one replica: a one-leaf star, keeping the first link delay
            # so eq.-(12) replanning stays meaningful
            return cls.balanced(
                [1], m_leaf=m_leaf,
                local_steps=(list(periods) or [1])[0] if periods else 1,
                level_delays=[level_delays[0]] if level_delays else None,
                t_lp=t_lp, t_cp=t_cp)
        ps = list(periods) if periods is not None else [1] * L
        if len(ps) != L:
            raise ValueError(
                f"{len(ps)} periods for {L} present sync axes {axes}")
        ds = list(level_delays) if level_delays is not None else [0.0] * L
        if len(ds) != L:
            raise ValueError(
                f"{len(ds)} level_delays for {L} present sync axes {axes}")
        # top-down rounds: the root runs 1, depth d runs periods[L-d], the
        # leaves periods[0] local steps
        rounds = [1] + [ps[L - d] for d in range(1, L)]
        return cls.balanced(list(reversed(sizes)), m_leaf=m_leaf,
                            local_steps=ps[0], level_rounds=rounds,
                            level_delays=list(reversed(ds)),
                            t_lp=t_lp, t_cp=t_cp)

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
