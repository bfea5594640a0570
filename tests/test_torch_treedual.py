"""The port's recursion oracle and plan helpers against the JAX package's.

* ``tree_dual_solve_reference`` (the verbatim Algorithm-2 recursion with
  its key derivation), the deprecated ``tree_dual_solve`` /
  ``cocoa_star_solve`` shims and ``local_sdca_epochs``: the same numpy
  inputs and the same keys through both packages, within ``ORACLE_TOL``;
* the port's engine against the port's own oracle, on the cases of
  ``tests/test_engine.py::test_engine_matches_reference_recursion``, to
  the tolerances that test states;
* the plan helpers (``plan_diff``, ``balanced_tree``,
  ``tree_from_level_plan``, ``chunk_participation``, ``schedule_view``)
  equal the reference's exactly: they are integer and structural.
Small sizes throughout (a few leaves, m_b <= 60, d <= 24)."""
import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core import dual as JD  # noqa: E402
from repro.core import tree as jtree  # noqa: E402
from repro.core import treedual as jtd  # noqa: E402
from repro.core.engine import plan as jplan  # noqa: E402
from repro.core.local_sdca import local_sdca_epochs as j_epochs  # noqa: E402
from repro_torch.api import Topology  # noqa: E402
from repro_torch.core import dual as TD  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core import treedual as ttd  # noqa: E402
from repro_torch.core.engine import plan as tplan  # noqa: E402
from repro_torch.core.local_sdca import local_sdca_epochs  # noqa: E402
from test_torch_dual import jloss  # noqa: E402

torch.set_num_threads(1)

LAM = 0.1
# the oracle in both packages: the same float32 coordinate steps, dot
# products and 1/K averages, in two libraries that sum a dot product in
# different orders; over a few hundred dependent steps the iterates (of
# order 1) stay within a few ulps
ORACLE_TOL = dict(rtol=1e-5, atol=1e-5)
# the port's engine against the port's oracle: the tolerances of
# tests/test_engine.py (the engine reassociates the 1/K averages into
# per-depth alpha scales and segment sums)
TOL = dict(rtol=1e-4, atol=1e-5)


def port_tree(tree):
    """The reference TreeNode as the port's (through the JSON form)."""
    return Topology.from_json(jtree_topology(tree).to_json()).tree


def jtree_topology(tree):
    from repro.api import Topology as JTopology
    return JTopology.from_tree(tree)


def _imbalanced_tree():
    la = jtree.TreeNode(name="A", rounds=40, data_size=24)
    lb = jtree.TreeNode(name="B", rounds=30, data_size=16)
    lc = jtree.TreeNode(name="C", rounds=50, data_size=8)
    g = jtree.TreeNode(name="g", children=(lb, lc), rounds=2)
    ld = jtree.TreeNode(name="Dd", rounds=20, data_size=12)
    le = jtree.TreeNode(name="E", rounds=25, data_size=20)
    h = jtree.TreeNode(name="h", children=(ld, le), rounds=3)
    mid = jtree.TreeNode(name="mid", children=(g, h), rounds=2)
    return jtree.TreeNode(name="root", children=(la, mid), rounds=6)


def _chain_tree():
    leaves = (jtree.TreeNode(name="l0", rounds=60, data_size=30),
              jtree.TreeNode(name="l1", rounds=60, data_size=30))
    grp = jtree.TreeNode(name="grp", children=leaves, rounds=2)
    mid = jtree.TreeNode(name="mid", children=(grp,), rounds=3)
    return jtree.TreeNode(name="root", children=(mid,), rounds=4)


# the cases of tests/test_engine.py, a little smaller
CASES = {
    "star": lambda: jtree.star(4, 30, outer_rounds=6, local_steps=60),
    "chain": _chain_tree,
    "two_level": lambda: jtree.two_level(2, 2, 30, root_rounds=4,
                                         group_rounds=3, local_steps=50),
    "imbalanced": _imbalanced_tree,
}


def data(m, d=16, seed=0, labels=False):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((m, d)).astype(np.float32)
    y = rng.standard_normal(m).astype(np.float32)
    if labels:
        y = np.where(y >= 0, 1.0, -1.0).astype(np.float32)
    return X, y


def assert_history_close(got, want):
    assert [h["round"] for h in got.history] == \
        [h["round"] for h in want.history]
    np.testing.assert_allclose(got.times, want.times, rtol=1e-12)
    np.testing.assert_allclose(got.duals, want.duals, **ORACLE_TOL)
    np.testing.assert_allclose(got.primals, want.primals, **ORACLE_TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_oracle_matches_the_reference_oracle(case):
    tree = CASES[case]()
    X, y = data(tree.total_data())
    want = jtd.tree_dual_solve_reference(tree, X, y, loss=JD.squared,
                                         lam=LAM, key=jax.random.PRNGKey(5))
    got = ttd.tree_dual_solve_reference(
        port_tree(tree), torch.from_numpy(X), torch.from_numpy(y),
        loss=TD.squared, lam=LAM, key=prng.PRNGKey(5))
    np.testing.assert_allclose(got.alpha.numpy(), np.asarray(want.alpha),
                               **ORACLE_TOL)
    np.testing.assert_allclose(got.w.numpy(), np.asarray(want.w),
                               **ORACLE_TOL)
    assert_history_close(got, want)


@pytest.mark.parametrize("loss", ["hinge", "smooth_hinge_1", "logistic"])
def test_oracle_matches_the_reference_oracle_for_classification(loss):
    tree = jtree.two_level(2, 2, 24, root_rounds=3, group_rounds=2,
                           local_steps=40)
    X, y = data(tree.total_data(), d=12, seed=3, labels=True)
    want = jtd.tree_dual_solve_reference(tree, X, y, loss=jloss(loss),
                                         lam=LAM, key=jax.random.PRNGKey(1))
    got = ttd.tree_dual_solve_reference(
        port_tree(tree), torch.from_numpy(X), torch.from_numpy(y),
        loss=TD.get_loss(loss), lam=LAM, key=prng.PRNGKey(1))
    np.testing.assert_allclose(got.alpha.numpy(), np.asarray(want.alpha),
                               **ORACLE_TOL)
    np.testing.assert_allclose(got.w.numpy(), np.asarray(want.w),
                               **ORACLE_TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_engine_matches_port_oracle(case):
    """tests/test_engine.py::test_engine_matches_reference_recursion in the
    port: the tick engine replays the recursion's keys, so its iterates
    equal the oracle's up to float reassociation."""
    tree = port_tree(CASES[case]())
    X, y = (torch.from_numpy(a) for a in data(tree.total_data()))
    ref = ttd.tree_dual_solve_reference(tree, X, y, loss=TD.squared,
                                        lam=LAM, key=prng.PRNGKey(5))
    with pytest.warns(DeprecationWarning, match="legacy shim"):
        eng = ttd.tree_dual_solve(tree, X, y, loss=TD.squared, lam=LAM,
                                  key=prng.PRNGKey(5), backend="torch",
                                  device="cpu")
    np.testing.assert_allclose(eng.alpha.numpy(), ref.alpha.numpy(), **TOL)
    np.testing.assert_allclose(eng.w.numpy(), ref.w.numpy(), **TOL)
    assert len(eng.history) == len(ref.history) == tree.rounds + 1
    np.testing.assert_allclose(eng.times, ref.times, rtol=1e-9)
    np.testing.assert_allclose(eng.duals, ref.duals, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(eng.gaps, ref.gaps, rtol=1e-3, atol=1e-4)
    # the oracle keeps w = A alpha
    np.testing.assert_allclose(
        ref.w.numpy(), TD.w_of_alpha(ref.alpha, X, LAM).numpy(), **TOL)


def test_tree_dual_solve_shim_matches_the_reference_shim():
    tree = CASES["two_level"]()
    X, y = data(tree.total_data())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = jtd.tree_dual_solve(tree, X, y, loss=JD.squared, lam=LAM,
                                   key=jax.random.PRNGKey(2),
                                   weighting="size")
    with pytest.warns(DeprecationWarning, match="tree_dual_solve"):
        got = ttd.tree_dual_solve(port_tree(tree), X, y, loss=TD.squared,
                                  lam=LAM, key=prng.PRNGKey(2),
                                  weighting="size", backend="torch",
                                  device="cpu")
    np.testing.assert_allclose(got.alpha.numpy(), np.asarray(want.alpha),
                               **TOL)
    np.testing.assert_allclose(got.gaps, want.gaps, **TOL)


def test_cocoa_star_solve_matches_the_reference():
    X, y = data(120, d=20, seed=4)
    kw = dict(n_workers=4, lam=LAM, outer_rounds=6, local_steps=45,
              t_lp=1e-6, t_delay=1e-3)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = jtd.cocoa_star_solve(X, y, loss=JD.squared,
                                    key=jax.random.PRNGKey(9), **kw)
    with pytest.warns(DeprecationWarning, match="cocoa_star_solve"):
        got = ttd.cocoa_star_solve(torch.from_numpy(X), torch.from_numpy(y),
                                   loss=TD.squared, key=prng.PRNGKey(9),
                                   backend="torch", device="cpu", **kw)
    np.testing.assert_allclose(got.alpha.numpy(), np.asarray(want.alpha),
                               **TOL)
    np.testing.assert_allclose(got.w.numpy(), np.asarray(want.w), **TOL)
    np.testing.assert_allclose(got.times, want.times, rtol=1e-12)
    np.testing.assert_array_equal(got.next_key.numpy(),
                                  np.asarray(want.next_key))
    # the star shim is the oracle's star, up to reassociation
    oracle = ttd.tree_dual_solve_reference(
        port_tree(jtree.star(4, 30, outer_rounds=6, local_steps=45,
                             t_lp=1e-6, t_delay=1e-3)),
        torch.from_numpy(X), torch.from_numpy(y), loss=TD.squared, lam=LAM,
        key=prng.PRNGKey(9))
    np.testing.assert_allclose(got.alpha.numpy(), oracle.alpha.numpy(),
                               **TOL)


@pytest.mark.parametrize("loss", ["squared", "smooth_hinge_1"])
def test_local_sdca_epochs_matches_the_reference(loss):
    X, y = data(48, d=10, seed=6, labels=loss != "squared")
    alpha = np.zeros(48, np.float32)
    w = np.zeros(10, np.float32)
    want = j_epochs(X, y, alpha, w, jax.random.PRNGKey(4),
                    loss=JD.get_loss(loss), lam=LAM, m_total=96, epochs=2)
    got = local_sdca_epochs(*(torch.from_numpy(a) for a in (X, y, alpha, w)),
                            prng.PRNGKey(4), loss=TD.get_loss(loss), lam=LAM,
                            m_total=96, epochs=2)
    for g, r in zip(got, want, strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **ORACLE_TOL)


# ---------------------------------------------------------------------------
# plan helpers: exact
# ---------------------------------------------------------------------------
def _plans(jtree_a, jtree_b, **kw):
    return ((jplan.compile_tree(jtree_a, **kw),
             jplan.compile_tree(jtree_b, **kw)),
            (tplan.compile_tree(port_tree(jtree_a), **kw),
             tplan.compile_tree(port_tree(jtree_b), **kw)))


@pytest.mark.parametrize("change", ["same", "leaf_removed", "reweighted",
                                    "restructured", "compressed"])
def test_plan_diff_equals_the_reference(change):
    base = jtree.two_level(2, 3, 16, root_rounds=2, group_rounds=2,
                           local_steps=8)
    other = base
    kw = {}
    if change == "leaf_removed":
        g0 = base.children[0]
        other = dataclasses.replace(base, children=(
            dataclasses.replace(g0, children=g0.children[:2]),
            base.children[1]))
    elif change == "reweighted":
        g0 = base.children[0]
        leaf = dataclasses.replace(g0.children[0], data_size=24)
        other = dataclasses.replace(base, children=(
            dataclasses.replace(g0, children=(leaf,) + g0.children[1:]),
            base.children[1]))
    elif change == "restructured":
        other = jtree.two_level(2, 3, 16, root_rounds=2, group_rounds=3,
                                local_steps=8)
    elif change == "compressed":
        kw = {"compression": "int8"}
    (ja, jb), (ta, tb) = _plans(base, other)
    if kw:
        jb = jplan.compile_tree(other, **kw)
        tb = tplan.compile_tree(port_tree(other), **kw)
    want = jplan.plan_diff(ja, jb)
    assert tplan.plan_diff(ta, tb) == want
    assert want["unchanged"] == (change == "same")


@pytest.mark.parametrize("branching,rounds", [([2, 3], [4, 2]),
                                              ([2, 2, 2], [4, 2, 3]),
                                              ([16, 16], [2, 2])])
def test_balanced_tree_equals_the_reference(branching, rounds):
    want = jplan.balanced_tree(branching, rounds, local_steps=12, m_leaf=4,
                               t_lp=1e-6)
    got = tplan.balanced_tree(branching, rounds, local_steps=12, m_leaf=4,
                              t_lp=1e-6)
    assert [leaf.name for leaf in got.leaves()] == \
        [leaf.name for leaf in want.leaves()]
    assert Topology.from_tree(got).to_dict() == \
        jtree_topology(want).to_dict()
    assert tplan.compile_tree(got).fingerprint == \
        jplan.compile_tree(want).fingerprint


def test_tree_from_level_plan_equals_the_reference():
    level_plan = [{"name": "l0", "H": 64}, {"name": "l1", "H": 3},
                  {"name": "l2", "H": 5}]
    want = jplan.tree_from_level_plan(level_plan, [2, 3, 2], m_leaf=8,
                                      root_rounds=7, t_lp=1e-5)
    got = tplan.tree_from_level_plan(level_plan, [2, 3, 2], m_leaf=8,
                                     root_rounds=7, t_lp=1e-5)
    assert Topology.from_tree(got).to_dict() == \
        jtree_topology(want).to_dict()


def test_chunk_participation_equals_the_reference():
    tree = _imbalanced_tree()
    ja, ta = jplan.compile_tree(tree), tplan.compile_tree(port_tree(tree))
    mask = np.array([1, 0, 1, 1, 0], np.float32)
    want = jplan.chunk_participation(ja, mask)
    got = tplan.chunk_participation(ta, mask)
    assert got.dtype == want.dtype and got.shape == (ta.n_ticks, 5)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        tplan.chunk_participation(ta, mask[:4])


@pytest.mark.parametrize("compression", [None, ["int8", "topk_0.25"]])
def test_schedule_view_equals_the_reference(compression):
    tree = jplan.balanced_tree([2, 3], [5, 2], local_steps=16, m_leaf=8)
    ja = jplan.compile_tree(tree, compression=compression)
    ta = tplan.compile_tree(port_tree(tree), compression=compression)
    want, got = jplan.schedule_view(ja), tplan.schedule_view(ta)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.cum_periods() == want.cum_periods()
    assert got.depth == want.depth
    with pytest.raises(ValueError, match="level-homogeneous"):
        tplan.schedule_view(tplan.compile_tree(port_tree(
            _imbalanced_tree())))
