"""The port's plan-IR verifier (``repro_torch/analysis/plan_check.py``)
against the JAX package's: the plan-check cases of
``tests/test_analysis.py`` run on the port's plans, the same corruption
applied to both packages' plans of one topology gives findings with the
same codes, and ``Session.compile`` runs the verifier on every plan it
compiles.  Everything here is exact: codes, registries, fingerprints."""
import dataclasses
import hashlib

import numpy as np
import pytest
import torch

from repro.analysis import plan_check as jcheck
from repro.core import compression as jcomp
from repro.core import tree as jtree
from repro.core.engine import plan as jplan
from repro_torch.analysis import (AnalysisError, audit_fingerprint,
                                  check_schedule_plan, check_tree_plan,
                                  verify_plan)
from repro_torch.analysis import plan_check
from repro_torch.api import (ElasticSession, MembershipLog, Problem,
                             Schedule, Session, Topology)
from repro_torch.core import compression as tcomp
from repro_torch.core import tree as ttree
from repro_torch.core.engine import plan as plan_mod
from repro_torch.core.engine.plan import compile_tree, schedule_view
from repro_torch.core.prng import PRNGKey
from repro_torch.core.tree import star


def _codes(findings):
    return {f.code for f in findings}


def _star_plan(n=4, m=6, rounds=3, h=8, **kw):
    return compile_tree(star(n, m, outer_rounds=rounds, local_steps=h), **kw)


def _hetero(mod):
    # a shallow leaf next to a deeper subtree: the inactive-leaf (default
    # zero) columns the verifier must NOT flag
    leaves = tuple(mod.TreeNode(name=f"l{i}", rounds=2 + i, data_size=4 + i)
                   for i in range(3))
    return mod.TreeNode(name="root", rounds=2, children=(
        mod.TreeNode(name="g", rounds=2, children=leaves),
        mod.TreeNode(name="x", rounds=3, data_size=5)))


# ---------------------------------------------------------------------------
# valid plans pass
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mk", [
    lambda: _star_plan(),
    lambda: _star_plan(compression=("int8",)),
    lambda: _star_plan(compression=("topk_0.25",)),
    lambda: compile_tree(_hetero(ttree)),
    lambda: compile_tree(star(3, 5, outer_rounds=2, local_steps=4),
                         weighting="size"),
], ids=["star", "int8", "topk", "hetero", "size-weighted"])
def test_verifier_accepts_valid_plans(mk):
    plan = mk()
    assert check_tree_plan(plan) == []
    assert audit_fingerprint(plan) == []
    verify_plan(plan)  # no raise


def test_verifier_accepts_schedule_view():
    sview = schedule_view(_star_plan())
    assert check_schedule_plan(sview) == []
    verify_plan(sview)


def test_registry_equals_the_reference():
    for name in ("FINGERPRINT_ARRAY_FIELDS", "FINGERPRINT_SCALAR_FIELDS",
                 "DERIVED_FIELDS", "METADATA_FIELDS"):
        assert getattr(plan_mod, name) == getattr(jplan, name), name
    assert {f.name for f in dataclasses.fields(plan_mod.TreePlan)} == \
        {f.name for f in dataclasses.fields(jplan.TreePlan)}


# ---------------------------------------------------------------------------
# fingerprint soundness: per-field mutation
# ---------------------------------------------------------------------------
def _mutate(plan, name):
    """A semantically distinct copy differing only in ``name``."""
    val = getattr(plan, name)
    if isinstance(val, np.ndarray):
        arr = np.array(val, copy=True)
        flat = arr.reshape(-1)
        if arr.dtype.kind == "f":
            # masks are 0/1 -- flip; weights -- nudge
            flat[0] = 1.0 - flat[0] if flat[0] in (0.0, 1.0) \
                else flat[0] * 0.5 + 0.25
        else:
            flat[0] = flat[0] + 1
        return dataclasses.replace(plan, **{name: arr}, fingerprint="")
    if isinstance(val, str):
        return dataclasses.replace(plan, **{name: val + "?"}, fingerprint="")
    if isinstance(val, tuple):
        return dataclasses.replace(
            plan, **{name: tuple(v + 1 for v in val)}, fingerprint="")
    return dataclasses.replace(plan, **{name: val + 1}, fingerprint="")


@pytest.mark.parametrize("field", plan_mod.FINGERPRINT_ARRAY_FIELDS
                         + plan_mod.FINGERPRINT_SCALAR_FIELDS)
def test_fingerprint_changes_under_every_behavior_field(field):
    plan = _star_plan()
    probe = _mutate(plan, field)
    assert probe.fingerprint != plan.fingerprint


def test_fingerprint_ignores_metadata():
    plan = _star_plan()
    renamed = dataclasses.replace(
        plan, leaf_names=tuple(f"r{i}" for i in range(plan.n_leaves)),
        fingerprint="")
    assert renamed.fingerprint == plan.fingerprint


def test_fingerprint_deterministic_across_recompile():
    t = star(4, 6, outer_rounds=3, local_steps=8)
    assert compile_tree(t).fingerprint == compile_tree(t).fingerprint


# ---------------------------------------------------------------------------
# seeded registry defects
# ---------------------------------------------------------------------------
def test_audit_catches_unregistered_field(monkeypatch):
    monkeypatch.setattr(
        plan_mod, "FINGERPRINT_ARRAY_FIELDS",
        tuple(f for f in plan_mod.FINGERPRINT_ARRAY_FIELDS
              if f != "compress_kind"))
    findings = audit_fingerprint(None)
    assert "F202" in _codes(findings)
    assert any("compress_kind" in f.message for f in findings)


def test_audit_catches_double_classification(monkeypatch):
    monkeypatch.setattr(plan_mod, "METADATA_FIELDS",
                        plan_mod.METADATA_FIELDS + ("solve_mask",))
    assert "F200" in _codes(audit_fingerprint(None))


def test_audit_catches_stale_registry_entry(monkeypatch):
    monkeypatch.setattr(plan_mod, "FINGERPRINT_SCALAR_FIELDS",
                        plan_mod.FINGERPRINT_SCALAR_FIELDS + ("no_such",))
    assert "F201" in _codes(audit_fingerprint(None))


def test_audit_catches_dropped_field_in_payload(monkeypatch):
    # a serialization that drops compress_kind collides the compressed and
    # uncompressed plans
    real = plan_mod.fingerprint_payload

    def lossy(plan):
        return real(dataclasses.replace(
            plan, compress_kind=np.zeros_like(plan.compress_kind),
            fingerprint="x"))
    monkeypatch.setattr(plan_mod, "compute_fingerprint",
                        lambda p: hashlib.sha1(lossy(p)).hexdigest())
    plan = _star_plan(compression=("int8",))
    assert "F220" in _codes(audit_fingerprint(plan))


# ---------------------------------------------------------------------------
# corrupted plans: the port's findings carry the reference's codes
# ---------------------------------------------------------------------------
def _flip(arr, at, value):
    arr = np.array(arr, copy=True)
    arr[at] = value
    return arr


def _stale(plan, comp):
    arr = np.array(plan.solve_mask, copy=True)
    arr[0, :] = 1.0 - arr[0, :]
    return {"solve_mask": arr, "fingerprint": plan.fingerprint}


CORRUPTIONS = {
    # name: (tree spec, compression, edit(plan, comp) -> replace kwargs)
    "mask-shape": ("star", None,
                   lambda p, c: {"solve_mask": p.solve_mask[:, :-1]}),
    "nonbinary-mask": ("star", None, lambda p, c: {
        "solve_mask": _flip(p.solve_mask, (0, 0), 0.5)}),
    "frac-range": ("star", ("topk_0.25",), lambda p, c: {
        "compress_frac": np.where(p.compress_frac > 0, 1.5,
                                  p.compress_frac).astype(np.float32)}),
    "unknown-kind": ("star", None, lambda p, c: {
        "compress_kind": _flip(p.compress_kind, (0, 0), 99)}),
    "stray-frac": ("star", ("int8",), lambda p, c: {
        "compress_frac": _flip(p.compress_frac, (0, 0), 0.5)}),
    "bad-w-coeff": ("star", None, lambda p, c: {"w_coeff": p.w_coeff * 0.5}),
    "refresh-mismatch": ("star", None, lambda p, c: {
        "refresh_mask": np.zeros_like(p.refresh_mask)}),
    "root-sync": ("star", None, lambda p, c: {
        "root_sync": np.zeros_like(p.root_sync)}),
    "stale-fingerprint": ("star", None, _stale),
    "derived-n-children": ("star", None, lambda p, c: {
        "fingerprint": "x", "n_children": (9,)}),
    "alpha-scale": ("two", None, lambda p, c: {
        "alpha_scale": _flip(p.alpha_scale, (1, 0), 2.0)}),
    "group-ids": ("two", None, lambda p, c: {
        "group_ids": _flip(p.group_ids, (1, 0), 7)}),
    "child-sizes": ("two", None, lambda p, c: {
        "child_sizes": _flip(p.child_sizes, (1, 0), 5.0)}),
    "mixed-edge": ("two", ("none", "int8"), lambda p, c: {
        "compress_kind": _flip(p.compress_kind, (1, 0), c.KIND_TOPK),
        "compress_frac": _flip(p.compress_frac, (1, 0), 0.5)}),
    "leaf-h": ("two", None, lambda p, c: {"h_max": p.h_max + 3}),
    "offsets": ("two", None, lambda p, c: {
        "leaf_offsets": p.leaf_offsets + 1}),
    "m-b": ("two", None, lambda p, c: {"m_b": p.m_b + 1}),
    "names": ("two", None, lambda p, c: {
        "leaf_names": ("a",) * p.n_leaves}),
    "idle-leaf": ("two", None, lambda p, c: {
        "solve_mask": _flip(p.solve_mask, (slice(None), 0), 0.0)}),
    "segments": ("two", None, lambda p, c: {"n_groups": (1,)}),
}


def _outcome(verify, plan):
    """What ``verify`` does with ``plan``: the exception's type name and,
    for an AnalysisError, its finding codes."""
    try:
        verify(plan)
    except ValueError as e:
        return type(e).__name__, _codes(getattr(e, "findings", []))
    return "ok", set()


def _tree(mod, spec):
    if spec == "star":
        return mod.star(4, 6, outer_rounds=3, local_steps=8)
    return mod.two_level(2, 3, 5, root_rounds=2, group_rounds=2,
                         local_steps=4)


@pytest.mark.parametrize("name", sorted(CORRUPTIONS))
def test_corrupted_plans_give_the_reference_codes(name):
    spec, compression, edit = CORRUPTIONS[name]
    tp = compile_tree(_tree(ttree, spec), compression=compression)
    jp = jplan.compile_tree(_tree(jtree, spec), compression=compression)
    assert tp.fingerprint == jp.fingerprint
    got = check_tree_plan(dataclasses.replace(tp, **edit(tp, tcomp)))
    want = jcheck.check_tree_plan(dataclasses.replace(jp, **edit(jp, jcomp)))
    assert want, name                  # the corruption is a real defect
    assert _codes(got) == _codes(want)
    assert [(f.code, f.where) for f in got] == \
        [(f.code, f.where) for f in want]
    # verify_plan adds the schedule view's checks: the same outcome too
    assert _outcome(verify_plan, dataclasses.replace(
        tp, **edit(tp, tcomp))) == _outcome(
        jcheck.verify_plan, dataclasses.replace(jp, **edit(jp, jcomp)))


def test_rejects_mismatched_mask_shape():
    plan = _star_plan()
    bad = dataclasses.replace(plan, solve_mask=plan.solve_mask[:, :-1])
    findings = check_tree_plan(bad)
    assert "P110" in _codes(findings)
    assert any("solve_mask" in f.where for f in findings)
    with pytest.raises(AnalysisError, match="P110"):
        verify_plan(bad)


def test_rejects_out_of_range_compress_frac():
    plan = _star_plan(compression=("topk_0.25",))
    arr = np.array(plan.compress_frac, copy=True)
    arr[arr > 0] = 1.5
    findings = check_tree_plan(dataclasses.replace(plan, compress_frac=arr))
    assert "P141" in _codes(findings)
    assert any("(0, 1]" in f.message for f in findings)


def test_rejects_bad_schedule_plan():
    sview = schedule_view(_star_plan())
    jview = jplan.schedule_view(jplan.compile_tree(
        jtree.star(4, 6, outer_rounds=3, local_steps=8)))
    assert dataclasses.astuple(sview) == dataclasses.astuple(jview)
    for edit, code in ((dict(periods=(0,) + sview.periods[1:]), "S301"),
                       (dict(compression=("wat",)), "S304"),
                       (dict(fingerprint=""), "S305"),
                       (dict(periods=()), "S300"),
                       (dict(group_sizes=(0,)), "S302")):
        got = check_schedule_plan(dataclasses.replace(sview, **edit))
        want = jcheck.check_schedule_plan(dataclasses.replace(jview, **edit))
        assert code in _codes(got)
        assert _codes(got) == _codes(want)


def test_verify_plan_rejects_wrong_type():
    with pytest.raises(TypeError):
        verify_plan({"not": "a plan"})


# ---------------------------------------------------------------------------
# every compile verifies
# ---------------------------------------------------------------------------
def _data(m, d=6, seed=0):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal((m, d)).astype(np.float32)),
            torch.from_numpy(rng.standard_normal(m).astype(np.float32)))


def test_session_compile_runs_the_verifier(monkeypatch):
    """Session.compile verifies each plan it compiles -- the pilot's and
    an elastic session's recompiles included -- and refuses a malformed
    one before building an executor."""
    seen = []
    real = plan_check.verify_plan

    def spy(plan, **kw):
        seen.append(plan.fingerprint)
        return real(plan, **kw)
    monkeypatch.setattr(plan_check, "verify_plan", spy)
    topo = Topology.star(4, 8, rounds=3, local_steps=4)
    X, y = _data(topo.m_total)
    sess = Session.compile(Problem(X, y), topo, backend="torch",
                           device="cpu")
    assert seen == [sess.plan.fingerprint]
    es = ElasticSession(Problem(X, y), topo, backend="torch", device="cpu")
    es.run(3, membership=MembershipLog().leave("W2", at_round=1),
           key=PRNGKey(0))
    assert len(seen) == 3 and seen[-1] != seen[-2]

    real_compile = plan_mod.compile_tree

    def broken(tree, **kw):
        plan = real_compile(tree, **kw)
        return dataclasses.replace(plan, w_coeff=plan.w_coeff * 0.5)
    monkeypatch.setattr(plan_mod, "compile_tree", broken)
    with pytest.raises(AnalysisError, match="P135"):
        Session.compile(Problem(X, y), topo, backend="torch", device="cpu")


def test_the_calibration_pilot_is_verified(monkeypatch):
    from repro_torch.api import DelayModel
    seen = []
    real = plan_check.verify_plan
    monkeypatch.setattr(plan_check, "verify_plan",
                        lambda plan, **kw: (seen.append(plan.n_ticks),
                                            real(plan, **kw))[1])
    topo = Topology.two_level(2, 2, 16, t_lp=1e-6, group_delay=1e-4,
                              root_delay=5e-2)
    X, y = _data(topo.m_total)
    Session.compile(Problem(X, y, lam=1e-2), topo, Schedule(
        rounds="auto", delay=DelayModel(t_total=1.0, C="auto",
                                        pilot_rounds=2)),
        backend="torch", device="cpu")
    assert len(seen) == 2              # the pilot's plan and the run's
