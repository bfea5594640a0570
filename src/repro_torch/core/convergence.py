"""Convergence-rate calculators: Proposition 1, Theorem 1, Theorem 2.

The paper's Theorem 2 gives a *recursion*: a node Q with K children whose
geometric-improvement factors are Theta_1..Theta_K, run for T rounds, has

    Theta_Q = (1 - (1 - max_k Theta_k) * (1/K) * lam*m*gamma/(rho + lam*m*gamma))^T

with rho >= rho_min = max_alpha lam^2 m^2
        (sum_k ||A_[k] a_[k]||^2 - ||A_Q a_Q||^2) / ||a_Q||^2.

Leaves (Proposition 1):  Theta_leaf = (1 - (lam m gamma/(1+lam m gamma))/m_B)^H.

``tree_theta`` walks the tree bottom-up and returns the root's factor, i.e.
E[D* - D^(R)] <= Theta_root * (D* - D^(0)).

Pure numpy, as in the JAX package's ``core/convergence.py``: this package
keeps its own copy so that it imports nothing of the reference.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from repro_torch.core.tree import TreeNode


# ---------------------------------------------------------------------------
# rho_min: spectral quantity of the block decomposition
# ---------------------------------------------------------------------------
def rho_min(A: np.ndarray, blocks: Sequence[slice], lam: float, m: int) -> float:
    """Exact rho_min = lam^2 m^2 * lambda_max(blockdiag_k(A_k^T A_k) - A^T A).

    A is d x m (columns already scaled by 1/(lam m)); blocks partition columns.
    The matrix D - G (D = blockdiag of Gram blocks, G = full Gram) is PSD on
    the relevant subspace; we take the max eigenvalue (>= 0).
    """
    A = np.asarray(A)
    G = A.T @ A
    D = np.zeros_like(G)
    for sl in blocks:
        D[sl, sl] = G[sl, sl]
    evals = np.linalg.eigvalsh(D - G)
    return float(max(evals[-1], 0.0) * (lam * m) ** 2)


def rho_min_power(
    A: np.ndarray, blocks: Sequence[slice], lam: float, m: int,
    iters: int = 200, seed: int = 0,
) -> float:
    """Power-iteration estimate (for large m where eigh is infeasible).

    The operator M = D - G is indefinite; plain power iteration would find
    the largest-|.| eigenvalue, which may be the negative end. We iterate on
    the PSD shift M + sigma*I with sigma = ||A||_F^2 >= lambda_max(G) >=
    -lambda_min(M), then un-shift.
    """
    A = np.asarray(A)
    sigma = float(np.sum(A * A))  # ||A||_F^2 >= lambda_max(A^T A)
    rng = np.random.default_rng(seed)
    v = rng.normal(size=A.shape[1])
    v /= np.linalg.norm(v)
    lam_est = 0.0
    for _ in range(iters):
        # (D - G + sigma I) v  without materializing G
        Gv = A.T @ (A @ v)
        Dv = np.zeros_like(v)
        for sl in blocks:
            Dv[sl] = A[:, sl].T @ (A[:, sl] @ v[sl])
        u = Dv - Gv + sigma * v
        n = np.linalg.norm(u)
        if n < 1e-30:
            return 0.0
        lam_est = float(v @ u)  # Rayleigh quotient of the shifted operator
        v = u / n
    return float(max(lam_est - sigma, 0.0) * (lam * m) ** 2)


# ---------------------------------------------------------------------------
# Proposition 1 / Theorem 1 factors
# ---------------------------------------------------------------------------
def leaf_theta(lam: float, m: int, gamma: float, m_block: int, H: int) -> float:
    """Prop. 1: Theta = (1 - (lam m gamma/(1+lam m gamma)) / m_B)^H."""
    c = lam * m * gamma / (1.0 + lam * m * gamma)
    return float((1.0 - c / m_block) ** H)


def sdca_theta(s: float, m_tilde: int, H: int) -> float:
    """Theorem 1 / eq. (4): Theta = (1 - s/m~)^H, step size s in [0,1]."""
    return float((1.0 - s / m_tilde) ** H)


def node_theta(
    child_thetas: Sequence[float], lam: float, m: int, gamma: float,
    rho: float, T: int,
) -> float:
    """Theorem 2: the parent's geometric factor after T rounds."""
    K = len(child_thetas)
    theta = max(child_thetas)
    c = lam * m * gamma / (rho + lam * m * gamma)
    per_round = 1.0 - (1.0 - theta) * c / K
    return float(per_round**T)


def star_rate(
    lam: float, m: int, gamma: float, rho: float, K: int, theta_local: float,
    T: int,
) -> float:
    """Theorem 1 / eq. (3) end-to-end factor for a star after T rounds."""
    return node_theta([theta_local] * K, lam, m, gamma, rho, T)


# ---------------------------------------------------------------------------
# Theorem 2 recursion over a whole tree
# ---------------------------------------------------------------------------
def tree_theta(
    tree: TreeNode,
    A: np.ndarray,
    lam: float,
    gamma: float,
    *,
    rho_by_node: Dict[str, float] | None = None,
    use_power_iteration: bool = False,
) -> float:
    """Bottom-up Theorem-2 recursion; returns the root's overall factor.

    ``A`` is the scaled d x m data matrix; rho at each internal node is the
    exact (or power-iteration) rho_min of its children's block decomposition,
    overridable via ``rho_by_node``.
    """
    m = tree.total_data()
    slices = dict(tree.leaf_slices())

    def node_slice(n: TreeNode) -> slice:
        ls = n.leaves()
        return slice(slices[ls[0].name].start, slices[ls[-1].name].stop)

    def rec(n: TreeNode) -> float:
        if n.is_leaf:
            return leaf_theta(lam, m, gamma, n.data_size, n.rounds)
        thetas = [rec(c) for c in n.children]
        if rho_by_node and n.name in rho_by_node:
            rho = rho_by_node[n.name]
        else:
            child_blocks = [node_slice(c) for c in n.children]
            fn = rho_min_power if use_power_iteration else rho_min
            rho = fn(A, child_blocks, lam, m)
        return node_theta(thetas, lam, m, gamma, rho, n.rounds)

    return rec(tree)


def predicted_gap_curve(theta_per_round: float, initial_gap: float,
                        rounds: int) -> np.ndarray:
    """E[D* - D^(t)] <= theta^t (D* - D^(0)) for t = 0..rounds."""
    t = np.arange(rounds + 1)
    return initial_gap * theta_per_round**t
