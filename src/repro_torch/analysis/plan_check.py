"""Plan-IR verifier: structural invariants of a lowered ``TreePlan`` (and
its method-agnostic ``SchedulePlan`` view), checked in O(plan size) host
numpy -- no device work -- so ``Session.compile`` runs it on every plan,
an elastic session's recompiles of an edited topology included.  The JAX
package's ``analysis/plan_check.py``, check for check and code for code
(P1xx plan structure, F2xx fingerprint registry, S3xx schedule view).

Invariant families
------------------

GEOMETRY      block layout coherent: offsets are the size cumsum, ``m_b``
              the max block, ``h_max`` the max capacity, tick/depth
              counts positive.
SHAPES        every per-tick / per-(depth, leaf) array has the schedule's
              exact shape and (for masks) is 0/1 -- a mask with a stray
              value multiplies deltas by it silently.
SCHEDULE      derived schedule fields are exactly their definitions:
              ``refresh_mask`` the running max of ``sync_mask`` over
              depth, ``root_sync`` the depth-0 event row, and the last
              tick ends a root round (the chunk-carry completeness that
              ``Session.run``'s exactness rests on).
AGGREGATION   each sync event covers whole contiguous groups, child
              weights are a convex combination (per-group ``w_coeff``
              sums to 1, ``alpha_scale`` in (0, 1]), and
              ``w_coeff == alpha_scale / child_size`` leaf-wise -- the
              paper's eq.-(13) ``w = A alpha`` preservation.
COMPRESSION   per-(depth, edge) specs valid: known kind codes, top-k
              fractions in (0, 1], zero fractions elsewhere, and one
              spec per child edge (every leaf of a child shares its
              up-link).
RNG           schedule-independence of the key/draw stream: runtime step
              masks can never exceed the compiled per-leaf draw capacity
              (``steps_for_h`` clamps to ``leaf_h``), so no runtime
              schedule can perturb which randints are drawn.
FINGERPRINT   the soundness audit (:func:`audit_fingerprint`): every
              dataclass field of ``TreePlan`` is classified in the plan
              IR's fingerprint registry (behavior / derived / metadata),
              derived fields really are recomputable, and perturbing any
              behavior field changes the fingerprint -- i.e. two
              semantically distinct plans cannot collide on the executor
              cache key (a lambda or a codec left out of the key).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from repro_torch.core import compression as comp_mod
from repro_torch.core.engine import plan as plan_mod
from repro_torch.core.engine.plan import SchedulePlan, TreePlan


@dataclasses.dataclass(frozen=True)
class Finding:
    """One verifier finding: a machine code, where it sits, and an
    actionable message (what is wrong + what to change)."""
    code: str        # e.g. "P102"
    where: str       # e.g. "sync_mask" or "fingerprint-registry"
    message: str

    def __str__(self):
        return f"[{self.code}] {self.where}: {self.message}"


class AnalysisError(ValueError):
    """Raised by :func:`verify_plan` when a plan violates an invariant;
    carries the full finding list."""

    def __init__(self, findings: List[Finding]):
        self.findings = list(findings)
        lines = "\n  ".join(str(f) for f in self.findings)
        super().__init__(
            f"plan verification failed with {len(self.findings)} "
            f"finding(s):\n  {lines}")


def _is_binary(a: np.ndarray) -> bool:
    return bool(np.isin(np.unique(a), (0.0, 1.0)).all())


# ---------------------------------------------------------------------------
# TreePlan structural checks
# ---------------------------------------------------------------------------
def check_tree_plan(plan: TreePlan) -> List[Finding]:
    """All structural findings for ``plan`` (empty list == verified)."""
    out: List[Finding] = []
    add = lambda c, w, m: out.append(Finding(c, w, m))  # noqa: E731
    n, S, D = plan.n_leaves, plan.n_ticks, plan.depth

    # ---- geometry ------------------------------------------------------
    if n < 1 or S < 1 or D < 1:
        add("P100", "geometry",
            f"need n_leaves, n_ticks, depth >= 1; got ({n}, {S}, {D}) -- "
            "compile plans through engine.plan.compile_tree")
        return out  # nothing below is meaningful
    sizes = np.asarray(plan.leaf_sizes)
    if sizes.shape != (n,) or (sizes < 1).any():
        add("P101", "leaf_sizes",
            f"expected (n={n},) positive ints, got shape {sizes.shape} "
            f"min {sizes.min() if sizes.size else '-'}")
    else:
        if int(sizes.max()) != plan.m_b:
            add("P101", "m_b",
                f"m_b={plan.m_b} != max leaf block {int(sizes.max())}; "
                "the blocked (n, m_b) layout would truncate a leaf")
        if int(sizes.sum()) != plan.m_total:
            add("P101", "m_total",
                f"m_total={plan.m_total} != sum(leaf_sizes)="
                f"{int(sizes.sum())}")
        offs = np.concatenate([[0], np.cumsum(sizes)[:-1]])
        if not np.array_equal(np.asarray(plan.leaf_offsets), offs):
            add("P101", "leaf_offsets",
                "leaf_offsets is not the cumulative sum of leaf_sizes; "
                "the flat<->blocked alpha maps would scatter wrong rows")
    leaf_h = np.asarray(plan.leaf_h)
    if leaf_h.shape != (n,) or (leaf_h < 1).any():
        add("P102", "leaf_h",
            f"per-leaf H capacity must be (n={n},) ints >= 1, got shape "
            f"{leaf_h.shape}")
    elif int(leaf_h.max()) != plan.h_max:
        add("P102", "h_max",
            f"h_max={plan.h_max} != max(leaf_h)={int(leaf_h.max())}; "
            "step masks and draw shapes would disagree")
    if len(plan.leaf_names) != n or len(set(plan.leaf_names)) != n:
        add("P103", "leaf_names",
            f"need {n} unique leaf names, got {len(plan.leaf_names)} "
            f"({len(set(plan.leaf_names))} unique) -- plan_diff keys "
            "membership on names")

    # ---- shapes --------------------------------------------------------
    expect = {
        "solve_mask": (S, n), "sync_mask": (S, D, n),
        "refresh_mask": (S, D, n), "root_sync": (S,),
        "alpha_scale": (D, n), "w_coeff": (D, n), "group_ids": (D, n),
        "child_ids": (D, n), "child_sizes": (D, n),
        "compress_kind": (D, n), "compress_frac": (D, n),
    }
    bad_shape = set()
    for name, shp in expect.items():
        a = np.asarray(getattr(plan, name))
        if a.shape != shp:
            bad_shape.add(name)
            add("P110", name,
                f"expected shape {shp} for (S={S}, D={D}, n={n}), got "
                f"{a.shape} -- executors would broadcast or crash "
                "mid-run")
    for name in ("solve_mask", "sync_mask", "refresh_mask"):
        if name in bad_shape:
            continue
        a = np.asarray(getattr(plan, name))
        if not _is_binary(a):
            add("P111", name,
                "schedule masks must be 0/1 (they multiply deltas); "
                f"found values {np.setdiff1d(np.unique(a), (0.0, 1.0))[:4]}")
    if len(plan.n_groups) != D or len(plan.n_children) != D:
        add("P112", "n_groups/n_children",
            f"need one segment count per depth (D={D}); got "
            f"{len(plan.n_groups)} / {len(plan.n_children)}")

    if bad_shape or len(plan.n_groups) != D or len(plan.n_children) != D:
        return out  # the schedule/aggregation checks index these arrays

    sync = np.asarray(plan.sync_mask)
    solve = np.asarray(plan.solve_mask)

    # ---- schedule coherence -------------------------------------------
    if not np.array_equal(np.asarray(plan.refresh_mask),
                          np.maximum.accumulate(sync, axis=1)):
        add("P120", "refresh_mask",
            "refresh_mask != running max of sync_mask over depth: a "
            "snapshot would go stale (or refresh early) relative to its "
            "ancestor's sync -- recompute it, don't hand-edit plans")
    root = sync[:, 0, :].max(axis=1) > 0.0
    if not np.array_equal(np.asarray(plan.root_sync), root):
        add("P121", "root_sync",
            "root_sync != (sync_mask depth-0 row has an event): chunked "
            "sessions would cut carries at non-root ticks")
    if not bool(root[-1]):
        add("P122", "root_sync",
            "the last tick must end a root round (root syncs refresh "
            "every snapshot; Session.run's exact chunk carry depends on "
            "it) -- the plan's span does not cover whole root rounds")
    if not solve.any(axis=0).all():
        idle = [plan.leaf_names[i]
                for i in np.nonzero(~solve.any(axis=0))[0][:4]]
        add("P123", "solve_mask",
            f"leaves {idle} never solve; their alpha blocks would be "
            "dead weight and their RNG keys unused")

    # ---- aggregation ---------------------------------------------------
    # Only leaves that ever sync at depth d carry meaningful depth-d
    # columns: a shallow leaf outside every depth-d subtree keeps the
    # lowering's default zeros in group/child/w columns, and no executor
    # ever reads them (its sync_mask row is 0 there).
    ascale = np.asarray(plan.alpha_scale)
    wcoef = np.asarray(plan.w_coeff)
    gids = np.asarray(plan.group_ids)
    cids = np.asarray(plan.child_ids)
    csize = np.asarray(plan.child_sizes)
    for d in range(D):
        act = sync[:, d, :].max(axis=0) > 0.0
        if not act.any():
            continue
        ng, nc = plan.n_groups[d], plan.n_children[d]
        g_a, c_a = gids[d][act], cids[d][act]
        if g_a.min() < 0 or g_a.max() >= ng:
            add("P130", f"group_ids[depth {d}]",
                f"ids must lie in [0, n_groups[{d}]={ng}); got "
                f"[{g_a.min()}, {g_a.max()}] -- segment sums would drop "
                "or alias groups")
            continue
        if c_a.min() < 0 or c_a.max() >= nc:
            add("P130", f"child_ids[depth {d}]",
                f"ids must lie in [0, n_children[{d}]={nc}); got "
                f"[{c_a.min()}, {c_a.max()}]")
            continue
        # groups and children are contiguous leaf ranges (the lowering
        # indexes subtrees as [lo:hi) slices)
        pos = np.nonzero(act)[0]
        for name, ids in (("group_ids", g_a), ("child_ids", c_a)):
            ok = True
            for u in np.unique(ids):
                where = pos[ids == u]
                ok &= int(where.max() - where.min()) == len(where) - 1
            if not ok:
                add("P131", f"{name}[depth {d}]",
                    "segment ids must tile contiguous leaf ranges "
                    "(subtrees are [lo:hi) slices); found an id that "
                    "recurs after a different id")
        # every child nests inside exactly one group
        for c in np.unique(c_a):
            gs = np.unique(g_a[c_a == c])
            if len(gs) != 1:
                add("P132", f"child_ids[depth {d}]",
                    f"child {c} spans groups {gs.tolist()}; a sync would "
                    "average across different parents")
        # child_sizes is the actual member count
        counts = np.bincount(c_a, minlength=nc)
        if not np.array_equal(csize[d][act],
                              counts[c_a].astype(csize.dtype)):
            add("P133", f"child_sizes[depth {d}]",
                "child_sizes != leaf count of the child subtree; the "
                "|child|/|present| participation correction would "
                "mis-scale partial children")
        # convex combination per group; eq.-(13) preservation
        if (ascale[d][act] <= 0).any() or (ascale[d][act] > 1).any():
            add("P134", f"alpha_scale[depth {d}]",
                f"child weights must lie in (0, 1]; got "
                f"[{ascale[d][act].min():.3g}, "
                f"{ascale[d][act].max():.3g}]")
        wsum = np.zeros(ng)
        np.add.at(wsum, g_a, wcoef[d][act])
        live = np.zeros(ng, bool)
        live[np.unique(g_a)] = True
        if not np.allclose(wsum[live], 1.0, atol=1e-5):
            add("P135", f"w_coeff[depth {d}]",
                f"per-group w-average weights must sum to 1 (convex "
                f"combination preserves w = A alpha, paper eq. (13)); "
                f"got sums in [{wsum[live].min():.6g}, "
                f"{wsum[live].max():.6g}]")
        if not np.allclose(wcoef[d][act] * csize[d][act], ascale[d][act],
                           atol=1e-5):
            add("P136", f"w_coeff[depth {d}]",
                "w_coeff != alpha_scale / child_size leaf-wise: the "
                "alpha rescale and the w average would apply different "
                "child weights, breaking w = A alpha at the sync")
        # sync events cover whole groups
        ev = sync[:, d, :]
        for s in np.nonzero(ev.any(axis=1))[0]:
            on = ev[s] > 0
            touched = np.unique(gids[d][on])
            full = act & np.isin(gids[d], touched)
            if not np.array_equal(on, full):
                add("P137", f"sync_mask[tick {s}, depth {d}]",
                    "a sync event must cover every leaf of each "
                    "participating group (partial attendance is the "
                    "RUNTIME participation mask's job, not the plan's)")
                break

    # ---- compression specs --------------------------------------------
    kind = np.asarray(plan.compress_kind)
    frac = np.asarray(plan.compress_frac)
    known = (comp_mod.KIND_NONE, comp_mod.KIND_INT8, comp_mod.KIND_TOPK)
    if not np.isin(kind, known).all():
        add("P140", "compress_kind",
            f"unknown kind codes {np.setdiff1d(np.unique(kind), known)}; "
            "use repro_torch.core.compression.KIND_*")
    else:
        topk = kind == comp_mod.KIND_TOPK
        if ((frac[topk] <= 0.0) | (frac[topk] > 1.0)).any():
            add("P141", "compress_frac",
                f"top-k fraction must lie in (0, 1]; got "
                f"[{frac[topk].min():.3g}, {frac[topk].max():.3g}] -- "
                "parse specs through compression.parse_spec")
        if (frac[~topk] != 0.0).any():
            add("P142", "compress_frac",
                "non-top-k edges must carry frac=0 (the fraction is "
                "top-k's parameter; a stray value changes the "
                "fingerprint without changing behavior)")
        for d in range(D):
            act = sync[:, d, :].max(axis=0) > 0.0
            for c in np.unique(cids[d][act]):
                rows = act & (cids[d] == c)
                pairs = {(int(k), float(f))
                         for k, f in zip(kind[d][rows], frac[d][rows],
                                         strict=True)}
                if len(pairs) > 1:
                    add("P143", f"compress_kind[depth {d}]",
                        f"child {c} mixes specs "
                        f"{sorted(comp_mod.spec_name(*p) for p in pairs)} "
                        "across its leaves; an up-link is ONE edge and "
                        "must compress uniformly")

    # ---- RNG schedule-independence ------------------------------------
    if not out:  # shapes are sane; the functional check is meaningful
        cap = plan_mod.steps_for_h(plan, np.full((n,), 1 << 30, np.int64))
        want = (np.arange(plan.h_max)[None, :]
                < leaf_h[:, None]).astype(np.float32)
        if not np.array_equal(cap, np.broadcast_to(want[None], cap.shape)):
            add("P150", "steps_for_h",
                "a maximal runtime step mask exceeds the compiled "
                "per-leaf draw capacity: runtime schedules could "
                "perturb the randint stream, breaking the "
                "schedule-independent RNG contract (draws must always "
                "cover leaf_h)")

    # ---- fingerprint ---------------------------------------------------
    if not plan.fingerprint:
        add("P160", "fingerprint",
            "empty fingerprint: the executor cache would key every plan "
            "to one entry")
    elif plan.fingerprint != plan_mod.compute_fingerprint(plan):
        add("P161", "fingerprint",
            "stored fingerprint != recomputed canonical hash: the plan "
            "was mutated after construction (plans are frozen; build a "
            "new one via dataclasses.replace with fingerprint='')")
    out.extend(audit_fingerprint(plan))
    return out


# ---------------------------------------------------------------------------
# fingerprint-soundness audit
# ---------------------------------------------------------------------------
def audit_fingerprint(plan: Optional[TreePlan] = None) -> List[Finding]:
    """The soundness audit of the plan IR's executor cache key.

    Class-level (always): every dataclass field of ``TreePlan`` must be
    classified in the fingerprint registry
    (``plan.FINGERPRINT_ARRAY_FIELDS`` / ``FINGERPRINT_SCALAR_FIELDS`` /
    ``DERIVED_FIELDS`` / ``METADATA_FIELDS``) exactly once.  A field
    added without classification fails HERE, at analysis time -- not
    later, when two distinct plans silently share a compiled executor
    (the bug class of a lambda or a codec left out of the cache key).

    Instance-level (when ``plan`` is given): derived fields really are
    recomputable from behavior fields, and perturbing each cheap
    behavior field changes the fingerprint (collision spot-check; the
    exhaustive per-field mutation audit lives in
    ``tests/test_analysis.py``)."""
    out: List[Finding] = []
    fields = {f.name for f in dataclasses.fields(TreePlan)}
    reg = {
        "behavior-array": set(plan_mod.FINGERPRINT_ARRAY_FIELDS),
        "behavior-scalar": set(plan_mod.FINGERPRINT_SCALAR_FIELDS),
        "derived": set(plan_mod.DERIVED_FIELDS),
        "metadata": set(plan_mod.METADATA_FIELDS),
    }
    seen: dict = {}
    for cls, names in reg.items():
        for nm in names:
            if nm in seen:
                out.append(Finding(
                    "F200", "fingerprint-registry",
                    f"field {nm!r} classified twice ({seen[nm]} and "
                    f"{cls}); a field has exactly one cache-key role"))
            seen[nm] = cls
            if nm not in fields:
                out.append(Finding(
                    "F201", "fingerprint-registry",
                    f"registry names {nm!r} but TreePlan has no such "
                    "field; remove the stale entry"))
    missing = fields - set(seen)
    if missing:
        out.append(Finding(
            "F202", "fingerprint-registry",
            f"TreePlan field(s) {sorted(missing)} are not classified in "
            "the fingerprint registry: decide whether each is compiled "
            "behavior (hash it), derived (prove it), or metadata "
            "(document it) in engine/plan.py -- an unclassified "
            "behavior field lets two distinct plans collide on the "
            "executor cache key"))
    if plan is None or out:
        return out

    # derived fields really are derived
    root = np.asarray(plan.sync_mask)[:, 0, :].max(axis=1) > 0.0
    if not np.array_equal(np.asarray(plan.root_sync), root):
        out.append(Finding(
            "F210", "root_sync",
            "classified derived but does not equal its derivation from "
            "sync_mask; either fix the plan or promote the field to a "
            "hashed behavior field"))
    cids = np.asarray(plan.child_ids)
    derived_nc = tuple(max(int(cids[d].max()) + 1, 1)
                       for d in range(plan.depth))
    if tuple(plan.n_children) != derived_nc:
        out.append(Finding(
            "F210", "n_children",
            f"classified derived but {tuple(plan.n_children)} != "
            f"max(child_ids)+1 per depth {derived_nc}; promote it to a "
            "hashed behavior field or fix the lowering"))

    # collision spot-check on the cheap scalar fields
    base = plan.fingerprint
    probe = dataclasses.replace(plan, weighting=plan.weighting + "?",
                                fingerprint="")
    if probe.fingerprint == base:
        out.append(Finding(
            "F220", "weighting",
            "perturbing a behavior field left the fingerprint unchanged "
            "-- the canonical serialization dropped it"))
    arr = np.array(plan.compress_kind, copy=True)
    arr[0, 0] = comp_mod.KIND_INT8 if arr[0, 0] != comp_mod.KIND_INT8 \
        else comp_mod.KIND_TOPK
    probe = dataclasses.replace(plan, compress_kind=arr, fingerprint="")
    if probe.fingerprint == base:
        out.append(Finding(
            "F220", "compress_kind",
            "changing an edge codec left the fingerprint unchanged: "
            "compressed and uncompressed plans would share one "
            "executor"))
    return out


# ---------------------------------------------------------------------------
# SchedulePlan checks
# ---------------------------------------------------------------------------
def check_schedule_plan(sview: SchedulePlan) -> List[Finding]:
    """Structural findings for a method-agnostic schedule view."""
    out: List[Finding] = []
    D = sview.depth
    if len(sview.periods) != D:
        out.append(Finding(
            "S300", "periods",
            f"need one period per level (depth={D}, bottom-up: leaf H "
            f"first); got {len(sview.periods)}"))
    if any(int(p) < 1 for p in sview.periods):
        out.append(Finding(
            "S301", "periods",
            f"periods must be >= 1 (a 0 period never syncs its level); "
            f"got {tuple(sview.periods)}"))
    if any(int(g) < 1 for g in sview.group_sizes):
        out.append(Finding(
            "S302", "group_sizes",
            f"level fan-outs must be >= 1; got "
            f"{tuple(sview.group_sizes)}"))
    if len(sview.compression) != D:
        out.append(Finding(
            "S303", "compression",
            f"need one up-link codec per level; got "
            f"{len(sview.compression)} for depth {D}"))
    for i, spec in enumerate(sview.compression):
        try:
            comp_mod.parse_spec(spec)
        except (ValueError, TypeError) as e:
            out.append(Finding(
                "S304", f"compression[{i}]", str(e)))
    if not sview.fingerprint:
        out.append(Finding(
            "S305", "fingerprint",
            "schedule view carries no plan fingerprint; LM executors "
            "could not be cache-keyed"))
    return out


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------
def verify_plan(plan, *, schedule_view: bool = True) -> None:
    """Verify ``plan`` (a :class:`TreePlan` or :class:`SchedulePlan`) and
    raise :class:`AnalysisError` listing every violated invariant.

    ``Session.compile`` calls this on every lowered plan; by default the
    level-homogeneous schedule view is additionally checked when the plan
    has one (mesh/LM consumers)."""
    if isinstance(plan, SchedulePlan):
        findings = check_schedule_plan(plan)
    elif isinstance(plan, TreePlan):
        findings = check_tree_plan(plan)
        if schedule_view and plan.levels is not None:
            leaf_h = np.asarray(plan.leaf_h)
            if plan.n_leaves and (leaf_h == leaf_h[0]).all():
                findings += check_schedule_plan(
                    plan_mod.schedule_view(plan))
    else:
        raise TypeError(
            f"verify_plan takes a TreePlan or SchedulePlan, got "
            f"{type(plan).__name__}")
    if findings:
        raise AnalysisError(findings)
