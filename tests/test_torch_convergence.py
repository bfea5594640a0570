"""The port's convergence-rate formulas (repro_torch.core.convergence)
against the JAX package's: Proposition 1, Theorems 1 and 2 and the
spectral rho_min, on the same numpy inputs.  Both are float64 numpy over
the same operations, so the results are compared exactly."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import convergence as jconv  # noqa: E402
from repro.core import tree as jtree  # noqa: E402
from repro_torch.core import convergence as tconv  # noqa: E402
from repro_torch.core import tree as ttree  # noqa: E402


def to_port(node) -> ttree.TreeNode:
    fields = {f.name: getattr(node, f.name)
              for f in dataclasses.fields(node) if f.name != "children"}
    return ttree.TreeNode(children=tuple(to_port(c) for c in node.children),
                          **fields)


def scaled(m=48, d=10, lam=0.1, seed=0):
    A = np.random.default_rng(seed).standard_normal((d, m))
    return A / (lam * m)


def test_rho_min_and_power_iteration_match():
    A = scaled()
    for blocks in ([slice(0, 48)], [slice(0, 24), slice(24, 48)],
                   [slice(0, 12), slice(12, 20), slice(20, 48)]):
        assert tconv.rho_min(A, blocks, 0.1, 48) == \
            jconv.rho_min(A, blocks, 0.1, 48)
        for iters, seed in ((50, 0), (200, 3)):
            assert tconv.rho_min_power(A, blocks, 0.1, 48, iters, seed) == \
                jconv.rho_min_power(A, blocks, 0.1, 48, iters, seed)


def test_theta_formulas_match():
    for lam, m, gamma, mb, H in ((0.1, 600, 1.0, 150, 100),
                                 (1e-3, 1000, 0.5, 10, 7)):
        assert tconv.leaf_theta(lam, m, gamma, mb, H) == \
            jconv.leaf_theta(lam, m, gamma, mb, H)
    for s, mt, H in ((1.0, 100, 50), (0.3, 7, 3)):
        assert tconv.sdca_theta(s, mt, H) == jconv.sdca_theta(s, mt, H)
    for thetas, rho, T in (([0.9, 0.8, 0.95], 2.0, 5), ([0.5], 0.0, 1)):
        assert tconv.node_theta(thetas, 0.1, 300, 1.0, rho, T) == \
            jconv.node_theta(thetas, 0.1, 300, 1.0, rho, T)
    assert tconv.star_rate(0.1, 300, 1.0, 2.0, 3, 0.9, 4) == \
        jconv.star_rate(0.1, 300, 1.0, 2.0, 3, 0.9, 4)
    np.testing.assert_array_equal(tconv.predicted_gap_curve(0.9, 2.5, 12),
                                  jconv.predicted_gap_curve(0.9, 2.5, 12))


@pytest.mark.parametrize("power", [False, True])
def test_tree_theta_matches(power):
    trees = [jtree.star(3, 16, outer_rounds=4, local_steps=20),
             jtree.two_level(2, 2, 12, root_rounds=3, group_rounds=2,
                             local_steps=10)]
    for tree in trees:
        A = scaled(m=tree.total_data())
        assert tconv.tree_theta(to_port(tree), A, 0.1, 1.0,
                                use_power_iteration=power) == \
            jconv.tree_theta(tree, A, 0.1, 1.0, use_power_iteration=power)
    rho = {"root": 0.5}
    assert tconv.tree_theta(to_port(trees[0]), scaled(m=48), 0.1, 1.0,
                            rho_by_node=rho) == \
        jconv.tree_theta(trees[0], scaled(m=48), 0.1, 1.0, rho_by_node=rho)
