"""Tree-schedule plan IR: lower an arbitrary ``TreeNode`` topology into a
flat, static execution plan that the host executor (``engine.host``) runs
tick by tick.  The same IR as the JAX package's ``core/engine/plan.py``,
field for field (so the fingerprints agree), in numpy apart from the
threefry key replay (``core/prng.py``).

The paper's TreeDualMethod (Algorithms 1-3) is a nested recursion: every
internal node runs T rounds; each round runs all children's full solves in
parallel from the round-start state and then combines the children's
(delta_alpha, delta_w) with weights summing to 1.  It compiles to S
"ticks":

  * tick = one batched leaf-solve slot.  ``span(leaf) = 1``,
    ``span(internal) = rounds * max_k span(child_k)``; children are aligned
    at the start of the parent round, and a child with a smaller span
    solves early and then idles (``solve_mask`` 0).
  * at the last tick of each internal round the node syncs: for every leaf
    under it ``alpha <- snap + alpha_scale * (alpha - snap)`` and ``w <-
    snap + sum_leaves w_coeff * (w_leaf - snap)``, deepest ancestor first.
  * snapshots: one per internal depth per leaf, refreshed after any tick
    where an ancestor at depth <= d synced (``refresh_mask``).

RNG: leaf coordinate choices replay the legacy recursion's key derivation
(``split(key, 1+K)`` per internal round, ``randint(leaf_key, (H,), 0,
m_b)`` per leaf solve), so both packages draw the same coordinates.

Runtime operands: a ``(S, n)`` participation mask (who attends each sync;
all ones = the synchronous schedule) and a ``(S, n, h_max)`` step mask
(how many of the drawn H steps apply; all ones = the static-H schedule).
``leaf_h`` is an H *capacity*: draws always cover it, so the key stream
never depends on the runtime schedule.

Edge compression: ``compress_kind`` / ``compress_frac`` hold each
(depth, leaf) up-link's spec (``core/compression.py`` codes), from the
per-depth default of ``compile_tree(compression=)`` or the child node's own
``up_compress``; both are hashed into the fingerprint, so a compressed
plan's fingerprint equals the reference's too.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import compression as comp_mod
from repro_torch.core import prng
from repro_torch.core.tree import TreeNode


@dataclasses.dataclass(frozen=True)
class LevelSpec:
    """One internal depth of a level-homogeneous plan."""
    depth: int        # 0 = root
    group_size: int   # K: children per node at this depth
    rounds: int       # T: rounds every node at this depth runs


# ---------------------------------------------------------------------------
# fingerprint field registry (the reference's).  Every field of TreePlan
# is classified exactly once, and ``analysis/plan_check.py::
# audit_fingerprint`` checks the registry against the dataclass:
#   * BEHAVIOR fields are hashed into the fingerprint (arrays as raw
#     bytes, scalars through ``repr``);
#   * DERIVED fields follow from the behavior fields (the plan checker
#     recomputes them), so hashing them could not tell two plans apart;
#   * METADATA fields never reach a run: renaming a leaf keeps the plan.
# ---------------------------------------------------------------------------
FINGERPRINT_ARRAY_FIELDS: Tuple[str, ...] = (
    "solve_mask", "sync_mask", "refresh_mask", "alpha_scale", "w_coeff",
    "group_ids", "child_ids", "child_sizes", "leaf_sizes", "leaf_offsets",
    "leaf_h", "compress_kind", "compress_frac")
FINGERPRINT_SCALAR_FIELDS: Tuple[str, ...] = (
    "n_leaves", "m_b", "m_total", "n_ticks", "depth", "h_max",
    "weighting", "n_groups")
DERIVED_FIELDS: Tuple[str, ...] = (
    "root_sync",     # == sync_mask[:, 0, :].max(axis=1) > 0
    "n_children",    # == per-depth max(child_ids) + 1
    "levels",        # re-detectable from the masks and group structure
    "fingerprint",   # the hash itself
)
METADATA_FIELDS: Tuple[str, ...] = ("leaf_names",)


def fingerprint_payload(plan: "TreePlan") -> bytes:
    """The canonical byte serialization of every behavior field."""
    chunks = []
    for name in FINGERPRINT_ARRAY_FIELDS:
        a = np.ascontiguousarray(getattr(plan, name))
        chunks.append(repr((name, a.shape, a.dtype.str)).encode())
        chunks.append(a.tobytes())
    chunks.append(repr(tuple(
        (name, getattr(plan, name))
        for name in FINGERPRINT_SCALAR_FIELDS)).encode())
    return b"".join(chunks)


def compute_fingerprint(plan: "TreePlan") -> str:
    """SHA-1 over :func:`fingerprint_payload`."""
    return hashlib.sha1(fingerprint_payload(plan)).hexdigest()


@dataclasses.dataclass(frozen=True)
class TreePlan:
    """The lowered schedule.  All arrays are host numpy."""
    # ---- geometry ------------------------------------------------------
    n_leaves: int
    m_b: int                      # padded block size (max leaf data size)
    m_total: int
    n_ticks: int                  # S
    depth: int                    # D: number of internal depths (0..D-1)
    h_max: int
    leaf_names: Tuple[str, ...]
    leaf_sizes: np.ndarray        # (n,) int
    leaf_offsets: np.ndarray      # (n,) int: start of each block in flat alpha
    leaf_h: np.ndarray            # (n,) int: per-leaf H capacity
    # ---- per-tick schedule --------------------------------------------
    solve_mask: np.ndarray        # (S, n) f32
    sync_mask: np.ndarray         # (S, D, n) f32
    refresh_mask: np.ndarray      # (S, D, n) f32
    root_sync: np.ndarray         # (S,) bool
    # ---- static per-(depth, leaf) aggregation --------------------------
    alpha_scale: np.ndarray       # (D, n) f32
    w_coeff: np.ndarray           # (D, n) f32
    group_ids: np.ndarray         # (D, n) int32
    n_groups: Tuple[int, ...]
    child_ids: np.ndarray         # (D, n) int32
    child_sizes: np.ndarray       # (D, n) f32
    n_children: Tuple[int, ...]
    # ---- metadata ------------------------------------------------------
    weighting: str
    levels: Optional[Tuple[LevelSpec, ...]]
    # ---- per-(depth, leaf) edge compression ----------------------------
    compress_kind: Optional[np.ndarray] = None   # (D, n) int8
    compress_frac: Optional[np.ndarray] = None   # (D, n) f32
    fingerprint: str = ""

    def __post_init__(self):
        if self.compress_kind is None:
            object.__setattr__(
                self, "compress_kind",
                np.zeros((self.depth, self.n_leaves), np.int8))
        if self.compress_frac is None:
            object.__setattr__(
                self, "compress_frac",
                np.zeros((self.depth, self.n_leaves), np.float32))
        if not self.fingerprint:
            object.__setattr__(self, "fingerprint",
                               compute_fingerprint(self))

    @property
    def has_compression(self) -> bool:
        return bool((self.compress_kind != 0).any())


# ---------------------------------------------------------------------------
# spans and child weights
# ---------------------------------------------------------------------------
def _span(node: TreeNode) -> int:
    if node.is_leaf:
        return 1
    return node.rounds * max(_span(c) for c in node.children)


def _child_weights(node: TreeNode, weighting: str) -> List[float]:
    K = len(node.children)
    if weighting == "uniform":
        return [1.0 / K] * K
    if weighting == "size":
        tot = node.total_data()
        return [c.total_data() / tot for c in node.children]
    raise ValueError(f"unknown weighting {weighting!r}")


# ---------------------------------------------------------------------------
# the walk: shared between plan compilation and RNG replay
# ---------------------------------------------------------------------------
def _split_chain(key: torch.Tensor, T: int, K: int) -> torch.Tensor:
    """The legacy per-round key threading: round t does ``key, *subkeys =
    split(key, 1 + K)``.  Returns the (T, K, 2) stacked subkeys."""
    subs = []
    for _ in range(T):
        ks = prng.split(key, 1 + K)
        key = ks[0]
        subs.append(ks[1:])
    return torch.stack(subs) if subs else torch.zeros((0, K, 2),
                                                      dtype=torch.int64)


def _walk(tree: TreeNode, key, on_solve, on_sync):
    """Drive the recursion symbolically: ``on_solve(tick, leaf_path, key)``
    for every leaf solve (key None when ``key`` is None), ``on_sync(tick,
    depth, path)`` for every internal-node aggregation, in the legacy
    recursion's order."""
    def walk(node, path, t0, depth, k):
        if node.is_leaf:
            on_solve(t0, path, k)
            return
        K = len(node.children)
        sub = max(_span(c) for c in node.children)
        subkeys = None
        if k is not None and node.rounds > 0:
            subkeys = _split_chain(k, node.rounds, K)
        for t in range(node.rounds):
            start = t0 + t * sub
            for ci, c in enumerate(node.children):
                ck = None if subkeys is None else subkeys[t, ci]
                walk(c, path + (ci,), start, depth + 1, ck)
            on_sync(start + sub - 1, depth, path)
    walk(tree, (), 0, 0, key)


# ---------------------------------------------------------------------------
# plan compilation
# ---------------------------------------------------------------------------
def compile_tree(tree: TreeNode, *, weighting: str = "uniform",
                 compression=None) -> TreePlan:
    """Lower ``tree`` into a :class:`TreePlan`.

    ``compression`` sets the per-depth edge-compression default: ``None``,
    one spec string for every depth, or a top-down per-depth sequence
    (entry ``d`` compresses the up-links INTO depth-``d`` nodes); a child
    node's own ``up_compress`` overrides it for that edge."""
    if tree.is_leaf:
        raise ValueError("the root must be an internal node")
    leaves = tree.leaves()
    names = tuple(l.name for l in leaves)
    if len(set(names)) != len(names):
        raise ValueError("leaf names must be unique")
    n = len(leaves)
    sizes = np.array([l.data_size for l in leaves], dtype=np.int64)
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    m_total = int(sizes.sum())
    m_b = int(sizes.max())
    leaf_h = np.array([l.rounds for l in leaves], dtype=np.int64)
    h_max = int(leaf_h.max())

    leaf_of_path: Dict[tuple, int] = {}
    node_info: Dict[tuple, tuple] = {}
    counter = [0]

    def index(node, path, depth):
        if node.is_leaf:
            leaf_of_path[path] = counter[0]
            counter[0] += 1
            return
        lo = counter[0]
        for ci, c in enumerate(node.children):
            index(c, path + (ci,), depth + 1)
        node_info[path] = (node, depth, lo, counter[0])
    index(tree, (), 0)

    D = max(depth for (_, depth, _, _) in node_info.values()) + 1
    S = _span(tree)

    solve_mask = np.zeros((S, n), np.float32)
    sync_mask = np.zeros((S, D, n), np.float32)
    alpha_scale = np.ones((D, n), np.float32)
    w_coeff = np.zeros((D, n), np.float32)
    group_ids = np.zeros((D, n), np.int32)
    child_ids = np.zeros((D, n), np.int32)
    child_sizes = np.ones((D, n), np.float32)
    gid_of: List[Dict[tuple, int]] = [dict() for _ in range(D)]
    cid_count = [0] * D

    if compression is None:
        level_spec: List = [None] * D
    elif isinstance(compression, str):
        level_spec = [compression] * D
    else:
        level_spec = [None if c in (None, "") else str(c)
                      for c in compression]
        if len(level_spec) != D:
            raise ValueError(
                f"per-depth compression must list all {D} internal depths "
                f"top-down, got {len(level_spec)} entries")
    compress_kind = np.zeros((D, n), np.int8)
    compress_frac = np.zeros((D, n), np.float32)

    for path, (node, depth, lo, hi) in node_info.items():
        if path not in gid_of[depth]:
            gid_of[depth][path] = len(gid_of[depth])
        gid = gid_of[depth][path]
        group_ids[depth, lo:hi] = gid
        omegas = _child_weights(node, weighting)
        for ci, c in enumerate(node.children):
            if c.is_leaf:
                clo = leaf_of_path[path + (ci,)]
                chi = clo + 1
            else:
                _, _, clo, chi = node_info[path + (ci,)]
            alpha_scale[depth, clo:chi] = omegas[ci]
            w_coeff[depth, clo:chi] = omegas[ci] / (chi - clo)
            child_ids[depth, clo:chi] = cid_count[depth]
            child_sizes[depth, clo:chi] = chi - clo
            cid_count[depth] += 1
            ck, cf = comp_mod.parse_spec(c.up_compress or level_spec[depth])
            compress_kind[depth, clo:chi] = ck
            compress_frac[depth, clo:chi] = cf

    def on_solve(tick, path, _key):
        solve_mask[tick, leaf_of_path[path]] = 1.0

    def on_sync(tick, depth, path):
        _, _, lo, hi = node_info[path]
        sync_mask[tick, depth, lo:hi] = 1.0

    _walk(tree, None, on_solve, on_sync)

    refresh_mask = np.maximum.accumulate(sync_mask, axis=1)
    root_sync = sync_mask[:, 0, :].max(axis=1) > 0.0

    return TreePlan(
        n_leaves=n, m_b=m_b, m_total=m_total, n_ticks=S, depth=D,
        h_max=h_max, leaf_names=names, leaf_sizes=sizes,
        leaf_offsets=offsets, leaf_h=leaf_h,
        solve_mask=solve_mask, sync_mask=sync_mask,
        refresh_mask=refresh_mask, root_sync=root_sync,
        alpha_scale=alpha_scale, w_coeff=w_coeff, group_ids=group_ids,
        n_groups=tuple(max(len(g), 1) for g in gid_of),
        child_ids=child_ids, child_sizes=child_sizes,
        n_children=tuple(max(c, 1) for c in cid_count),
        weighting=weighting, levels=_detect_levels(tree, leaves, D),
        compress_kind=compress_kind, compress_frac=compress_frac,
    )


def _detect_levels(tree: TreeNode, leaves, D) -> Optional[Tuple[LevelSpec, ...]]:
    """Level-homogeneous: all internal nodes at each depth share (rounds,
    fan-out), every leaf sits at depth D and all leaves share (size, H)."""
    by_depth: Dict[int, set] = {}
    leaf_depths = set()

    def visit(node, depth):
        if node.is_leaf:
            leaf_depths.add(depth)
            return
        by_depth.setdefault(depth, set()).add(
            (node.rounds, len(node.children)))
        for c in node.children:
            visit(c, depth + 1)
    visit(tree, 0)

    if leaf_depths != {D}:
        return None
    if len({(l.data_size, l.rounds) for l in leaves}) != 1:
        return None
    if any(len(v) != 1 for v in by_depth.values()):
        return None
    return tuple(
        LevelSpec(depth=d, rounds=next(iter(by_depth[d]))[0],
                  group_size=next(iter(by_depth[d]))[1])
        for d in range(D))


# ---------------------------------------------------------------------------
# RNG replay -> per-solve key arrays (draws happen inside the executor)
# ---------------------------------------------------------------------------
def _leaf_index(tree: TreeNode) -> Dict[tuple, int]:
    out: Dict[tuple, int] = {}

    def index(node, path):
        if node.is_leaf:
            out[path] = len(out)
            return
        for ci, c in enumerate(node.children):
            index(c, path + (ci,))
    index(tree, ())
    return out


def _solve_keys(tree: TreeNode, key, n_ticks: int, n_leaves: int
                ) -> np.ndarray:
    key = prng.PRNGKey(0) if key is None else prng.as_key(key).cpu()
    leaf_of_path = _leaf_index(tree)
    keys = np.zeros((n_ticks, n_leaves, 2), np.uint32)

    def on_solve(tick, path, k):
        keys[tick, leaf_of_path[path]] = k.numpy()

    _walk(tree, key, on_solve, lambda *a: None)
    return keys


def key_plan(tree: TreeNode, plan: TreePlan, key=None) -> np.ndarray:
    """The (S, n_leaves, 2) uint32 per-solve keys: entry [s, l] is the key
    the legacy recursion hands leaf l's solve at tick s (zeros at idle
    ticks, whose draws are masked out)."""
    return _solve_keys(tree, key, plan.n_ticks, plan.n_leaves)


def chunked_key_plan(chunk_tree: TreeNode, plan: TreePlan, key,
                     rounds: int) -> np.ndarray:
    """The per-solve keys of ``rounds`` consecutive root rounds of
    ``chunk_tree`` (whose root runs ONE round; ``plan`` is its plan), from
    one walk of the equivalent monolithic tree, shaped ``(rounds, S_chunk,
    n, 2)``."""
    if chunk_tree.rounds != 1:
        raise ValueError(f"chunk tree must run one root round, got "
                         f"{chunk_tree.rounds}")
    if rounds == 0:
        return np.zeros((0, plan.n_ticks, plan.n_leaves, 2), np.uint32)
    full = dataclasses.replace(chunk_tree, rounds=rounds)
    keys = _solve_keys(full, key, rounds * plan.n_ticks, plan.n_leaves)
    return keys.reshape(rounds, plan.n_ticks, plan.n_leaves, 2)


def advance_root_key(key, rounds: int, K: int) -> torch.Tensor:
    """The root RNG-chain state after ``rounds`` rounds of a K-child root
    (each round consumes ``key, *_ = split(key, 1 + K)``)."""
    key = prng.as_key(key).cpu()
    for _ in range(rounds):
        key = prng.split(key, 1 + K)[0]
    return key


def index_plan(tree: TreeNode, plan: TreePlan, key=None,
               local_h=None) -> np.ndarray:
    """The (S, n_leaves, h_max) int32 coordinate choices the executor draws
    from :func:`key_plan` (a test helper): draws at each leaf's H capacity,
    with the entries a ``local_h`` step mask gates off zeroed."""
    keys = key_plan(tree, plan, key)
    idx = np.zeros((plan.n_ticks, plan.n_leaves, plan.h_max), np.int32)
    h_run = None
    if local_h is not None:
        h_run = np.broadcast_to(
            np.asarray(local_h, np.int64), (plan.n_leaves,))
    for li in range(plan.n_leaves):
        ticks = np.nonzero(plan.solve_mask[:, li])[0]
        if len(ticks) == 0:
            continue
        h = int(plan.leaf_h[li])
        mb = int(plan.leaf_sizes[li])
        draws = prng.randint(prng.as_key(keys[ticks, li]), (h,), 0, mb)
        idx[ticks, li, :h] = draws.numpy()
        if h_run is not None:
            idx[ticks, li, min(int(h_run[li]), h):] = 0
    return idx


# ---------------------------------------------------------------------------
# runtime operands: participation and step masks
# ---------------------------------------------------------------------------
def full_participation(plan: TreePlan) -> np.ndarray:
    """The all-ones ``(S, n)`` participation mask: the synchronous
    schedule."""
    return np.ones((plan.n_ticks, plan.n_leaves), np.float32)


def chunk_participation(plan: TreePlan, leaf_mask) -> np.ndarray:
    """Broadcast a per-leaf ``(n,)`` 0/1 decision over every tick of one
    chunk: the whole-chunk granularity under which masked syncs preserve
    ``w = A alpha`` exactly on any tree (a leaf absent for the whole chunk
    never delivers work that a participant's delta could double-carry)."""
    leaf_mask = np.asarray(leaf_mask, np.float32).reshape(plan.n_leaves)
    return np.broadcast_to(
        leaf_mask[None, :], (plan.n_ticks, plan.n_leaves)).copy()


def full_steps(plan: TreePlan) -> np.ndarray:
    """The all-ones ``(S, n, h_max)`` step mask: the static-H schedule."""
    return np.ones((plan.n_ticks, plan.n_leaves, plan.h_max), np.float32)


def steps_for_h(plan: TreePlan, h) -> np.ndarray:
    """The ``(S, n, h_max)`` step mask running ``h`` local iterations per
    solve slot: a scalar, a per-leaf ``(n,)`` vector or a per-slot ``(S,
    n)`` array, clamped to ``[0, plan.leaf_h]`` per leaf."""
    S, n, h_max = plan.n_ticks, plan.n_leaves, plan.h_max
    h = np.asarray(h, np.int64)
    if h.ndim == 0:
        h = np.full((n,), int(h), np.int64)
    if h.shape == (n,):
        h = np.broadcast_to(h[None, :], (S, n))
    if h.shape != (S, n):
        raise ValueError(
            f"local h must be a scalar, ({n},) per leaf, or ({S}, {n}) "
            f"per slot; got shape {h.shape}")
    h_eff = np.minimum(np.maximum(h, 0), plan.leaf_h[None, :])
    j = np.arange(h_max)
    return (j[None, None, :] < h_eff[:, :, None]).astype(np.float32)


# ---------------------------------------------------------------------------
# simulated communication accounting
# ---------------------------------------------------------------------------
def plan_bytes_per_round(plan: TreePlan, d_feat: int, *,
                         dtype_bytes: int = 4) -> float:
    """Simulated UPLINK bytes one root round ships: every sync event in
    the plan delivers one ``d``-vector delta per distinct child edge,
    scaled by that edge's compression wire ratio
    (``core/compression.py::wire_ratio``); the plan's total is normalized
    by its root-round count."""
    total = 0.0
    for s in range(plan.n_ticks):
        for dd in range(plan.depth):
            ev = plan.sync_mask[s, dd] > 0
            if not ev.any():
                continue
            seen = set()
            for li in np.nonzero(ev)[0]:
                cid = int(plan.child_ids[dd, li])
                if cid in seen:
                    continue
                seen.add(cid)
                ratio = comp_mod.wire_ratio(
                    int(plan.compress_kind[dd, li]),
                    float(plan.compress_frac[dd, li]))
                total += float(d_feat) * dtype_bytes * ratio
    return total / max(int(plan.root_sync.sum()), 1)


# ---------------------------------------------------------------------------
# plan diffing (elastic membership: recompile bookkeeping)
# ---------------------------------------------------------------------------
def plan_diff(old: TreePlan, new: TreePlan) -> Dict[str, object]:
    """Structural diff between two compiled plans, keyed by leaf NAME (the
    stable identity across membership events: leaf indices shift when
    leaves leave or join).  ``fingerprint_changed`` says whether the
    executor must be rebuilt; ``weights_changed`` lists surviving leaves
    whose aggregation column (alpha_scale / w_coeff / compression / size /
    H capacity) was re-weighted."""
    old_idx = {nm: i for i, nm in enumerate(old.leaf_names)}
    new_idx = {nm: i for i, nm in enumerate(new.leaf_names)}
    added = [nm for nm in new.leaf_names if nm not in old_idx]
    removed = [nm for nm in old.leaf_names if nm not in new_idx]
    structure_changed = (old.depth != new.depth
                         or old.n_ticks != new.n_ticks
                         or old.n_groups != new.n_groups
                         or old.n_children != new.n_children)
    weights_changed = []
    for nm in new.leaf_names:
        if nm not in old_idx:
            continue
        oi, ni = old_idx[nm], new_idx[nm]
        same = (old.depth == new.depth
                and int(old.leaf_sizes[oi]) == int(new.leaf_sizes[ni])
                and int(old.leaf_h[oi]) == int(new.leaf_h[ni])
                and np.array_equal(old.alpha_scale[:, oi],
                                   new.alpha_scale[:, ni])
                and np.array_equal(old.w_coeff[:, oi], new.w_coeff[:, ni])
                and np.array_equal(old.compress_kind[:, oi],
                                   new.compress_kind[:, ni])
                and np.array_equal(old.compress_frac[:, oi],
                                   new.compress_frac[:, ni]))
        if not same:
            weights_changed.append(nm)
    return {
        "fingerprint_changed": old.fingerprint != new.fingerprint,
        "leaves_added": added,
        "leaves_removed": removed,
        "weights_changed": weights_changed,
        "structure_changed": structure_changed,
        "unchanged": (not added and not removed and not weights_changed
                      and not structure_changed),
    }


# ---------------------------------------------------------------------------
# tree constructors for plan-driven workflows
# ---------------------------------------------------------------------------
def balanced_tree(
    branching: Sequence[int],
    rounds: Sequence[int],
    *,
    local_steps: int,
    m_leaf: int,
    t_lp: float = 0.0,
) -> TreeNode:
    """A level-homogeneous tree, top-down: ``branching[0]`` children at the
    root running ``rounds[0]`` rounds, and so on; leaves run ``local_steps``
    coordinate steps over ``m_leaf`` examples each."""
    assert len(branching) == len(rounds) and len(branching) >= 1

    def build(d, path):
        tag = "-".join(str(p) for p in path)  # separator: fan-out >= 10 safe
        if d == len(branching):
            return TreeNode(name=f"L{tag}", rounds=local_steps,
                            data_size=m_leaf, t_lp=t_lp)
        kids = tuple(build(d + 1, path + (k,))
                     for k in range(branching[d]))
        name = "root" if d == 0 else f"N{tag}"
        return TreeNode(name=name, children=kids, rounds=rounds[d])
    return build(0, ())


def tree_from_level_plan(
    level_plan: Sequence[dict],
    branching: Sequence[int],
    *,
    m_leaf: int,
    root_rounds: int,
    t_lp: float = 0.0,
) -> TreeNode:
    """Bridge from ``core/delay.py::plan_hierarchical_h`` (eq. (12) per
    level, innermost first) to an engine-runnable tree: ``level_plan[0]
    ["H"]`` becomes the leaf local-step count, higher levels' H the
    per-depth round counts, and the root runs ``root_rounds``.
    ``branching`` is top-down (root fan-out first)."""
    hs = [int(row["H"]) for row in level_plan]
    assert len(branching) == len(hs), (len(branching), len(hs))
    # top-down internal rounds: root, then H of the outer levels inward
    rounds = [root_rounds] + list(reversed(hs[1:]))
    return balanced_tree(branching, rounds, local_steps=hs[0],
                         m_leaf=m_leaf, t_lp=t_lp)


# ---------------------------------------------------------------------------
# the method-agnostic schedule view
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SchedulePlan:
    """What a Method (``core/engine/method.py``) reads from a
    level-homogeneous :class:`TreePlan`: tree shape and per-level
    periods, bottom-up (level 0 = the leaves):

      * ``periods[0]``      local steps per level-1 sync (leaf H),
      * ``periods[i]``      level-(i-1) rounds per level-i sync,
      * ``group_sizes[i]``  fan-out of the level-(i+1) node over its
        level-i children,
      * ``compression[i]``  codec spec of the up-link into level i+1.
    """
    periods: Tuple[int, ...]
    group_sizes: Tuple[int, ...]
    compression: Tuple[str, ...]
    fingerprint: str

    @property
    def depth(self) -> int:
        return len(self.group_sizes)

    def cum_periods(self) -> Tuple[int, ...]:
        out, p = [], 1
        for h in self.periods:
            p *= h
            out.append(p)
        return tuple(out)


def schedule_view(plan: TreePlan) -> SchedulePlan:
    """The method-agnostic schedule layer of a lowered plan; needs a
    level-homogeneous plan (``plan.levels`` set) with uniform leaf H."""
    if plan.levels is None:
        raise ValueError(
            "schedule_view needs a level-homogeneous plan (uniform "
            "per-depth fan-out/rounds, congruent leaves)")
    leaf_h = np.asarray(plan.leaf_h)
    if plan.n_leaves and not (leaf_h == leaf_h[0]).all():
        raise ValueError(
            "schedule_view needs uniform leaf H (per-leaf heterogeneous H "
            "is a runtime step-mask input, not part of the static view)")
    D = plan.depth
    # bottom-up: leaf H, then the rounds of each internal depth from the
    # innermost (depth D-1) up to just below the root (depth 1); the
    # root's own rounds are the run length, not a period
    periods = [int(leaf_h[0]) if plan.n_leaves else 1]
    periods += [int(plan.levels[d].rounds) for d in range(D - 1, 0, -1)]
    group_sizes = [int(plan.levels[d].group_size)
                   for d in range(D - 1, -1, -1)]
    # the codec of the up-link into bottom-up level i+1 is the edge into
    # top-down depth D-1-i; uniform per depth in a level-homogeneous plan,
    # so leaf 0's column stands for it
    comp = []
    for i in range(D):
        d = D - 1 - i
        kind = int(plan.compress_kind[d, 0]) if plan.n_leaves else 0
        frac = float(plan.compress_frac[d, 0]) if plan.n_leaves else 0.0
        comp.append(comp_mod.spec_name(kind, frac))
    return SchedulePlan(periods=tuple(periods),
                        group_sizes=tuple(group_sizes),
                        compression=tuple(comp),
                        fingerprint=plan.fingerprint)
