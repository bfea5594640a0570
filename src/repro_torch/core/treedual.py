"""TreeDualMethod (paper Algorithms 1-3): distributed dual coordinate ascent
over an arbitrary tree network.

:func:`tree_dual_solve` and :func:`cocoa_star_solve` are DEPRECATED thin
shims over the sessionized API (``repro_torch.api``): prefer

    Session.compile(Problem(X, y, loss=..., lam=...),
                    Topology.from_tree(tree)).run(key=...)

The host-side Python recursion is kept as :func:`tree_dual_solve_reference`,
the cross-check oracle of the engine (the engine replays its key
derivation, so both give the same iterates up to float reassociation).
The recursion is exact Algorithm 2:

    for t = 1..T:
        for children k = 1..K in parallel:
            (da_k, dw_k) = TreeDualMethod(child_k, alpha_[k], w)
            alpha_[k] += da_k / K
        w += (1/K) sum_k dw_k

Leaves run Procedure P (``core/local_sdca.py``).  The root (Algorithm 3)
starts from alpha = 0, w = 0 and records a (simulated_time, dual, gap)
history with the tree's delay model (``core/instrument.py``).  The oracle
runs on the device of ``X``.
"""
from __future__ import annotations

import warnings
from typing import Dict, Tuple

import torch

from repro_torch.core import dual as dual_mod
from repro_torch.core import prng
from repro_torch.core.dual import Loss
from repro_torch.core.instrument import (SolveResult, per_round_time,
                                         record_round)
from repro_torch.core.local_sdca import local_sdca
from repro_torch.core.tree import TreeNode

Tensor = torch.Tensor


def tree_dual_solve(
    tree: TreeNode,
    X: Tensor,
    y: Tensor,
    *,
    loss: Loss,
    lam: float,
    key=None,
    record_history: bool = True,
    backend: str = "cuda",
    weighting: str = "uniform",
    device="cuda",
) -> SolveResult:
    """DEPRECATED shim: Algorithm 3 at the root of ``tree``, routed through
    ``repro_torch.api`` (Problem/Topology/Schedule/Session)."""
    warnings.warn(
        "tree_dual_solve is a legacy shim; use repro_torch.api.Session "
        "(Problem/Topology/Schedule) instead", DeprecationWarning,
        stacklevel=2)
    from repro_torch import api
    return api.solve(
        api.Problem(X, y, loss=loss, lam=lam),
        api.Topology.from_tree(tree),
        api.Schedule(weighting=weighting),
        backend=backend, device=device, key=key,
        record_history=record_history)


def cocoa_star_solve(
    X: Tensor,
    y: Tensor,
    n_workers: int,
    *,
    loss: Loss,
    lam: float,
    outer_rounds: int,
    local_steps: int,
    key=None,
    t_lp: float = 0.0,
    t_cp: float = 0.0,
    t_delay: float = 0.0,
    backend: str = "cuda",
    device="cuda",
) -> SolveResult:
    """DEPRECATED shim: Algorithm 1 (CoCoA) as the star special case of
    the sessionized API.  Use ``Topology.star`` + ``Session`` instead."""
    warnings.warn(
        "cocoa_star_solve is a legacy shim; use repro_torch.api.Session "
        "with Topology.star instead", DeprecationWarning, stacklevel=2)
    from repro_torch import api

    m = X.shape[0]
    assert m % n_workers == 0, "even split expected (paper setup)"
    topo = api.Topology.star(
        n_workers, m // n_workers, rounds=outer_rounds,
        local_steps=local_steps, t_lp=t_lp, t_cp=t_cp, t_delay=t_delay)
    return api.solve(api.Problem(X, y, loss=loss, lam=lam), topo, key=key,
                     backend=backend, device=device)


# ---------------------------------------------------------------------------
# The host recursion: the engine's cross-check oracle.
# ---------------------------------------------------------------------------
def _child_slice(child: TreeNode, slices: Dict[str, slice]) -> slice:
    if child.is_leaf:
        return slices[child.name]
    return slice(slices[child.leaves()[0].name].start,
                 slices[child.leaves()[-1].name].stop)


def _solve_node(
    node: TreeNode,
    slices: Dict[str, slice],
    X: Tensor,
    y: Tensor,
    alpha: Tensor,
    w: Tensor,
    key: Tensor,
    *,
    loss: Loss,
    lam: float,
    m_total: int,
    node_slice: slice,
) -> Tuple[Tensor, Tensor]:
    """Return (new_alpha_full, new_w) after running ``node.rounds`` rounds.

    Only coordinates inside ``node_slice`` are modified; ``w`` stays
    globally consistent: w = A alpha throughout."""
    if node.is_leaf:
        sl = slices[node.name]
        da, dw = local_sdca(X[sl], y[sl], alpha[sl], w, key, loss=loss,
                            lam=lam, m_total=m_total, num_steps=node.rounds)
        out = alpha.clone()
        out[sl] = out[sl] + da
        return out, w + dw

    K = len(node.children)
    for _t in range(node.rounds):
        keys = prng.split(key, 1 + K)
        key, subkeys = keys[0], keys[1:]
        dws = []
        new_alpha = alpha.clone()
        for k, child in enumerate(node.children):
            csl = _child_slice(child, slices)
            a_k, w_k = _solve_node(
                child, slices, X, y, alpha, w, subkeys[k], loss=loss,
                lam=lam, m_total=m_total, node_slice=csl)
            # the child returns full vectors; take its delta
            da_k = a_k[csl] - alpha[csl]
            new_alpha[csl] = new_alpha[csl] + da_k / K
            dws.append(w_k - w)
        alpha = new_alpha
        w = w + sum(dws) / K
    return alpha, w


def tree_dual_solve_reference(
    tree: TreeNode,
    X: Tensor,
    y: Tensor,
    *,
    loss: Loss,
    lam: float,
    key=None,
    record_history: bool = True,
) -> SolveResult:
    """The O(tree x rounds) Python-dispatch recursion (the oracle), on the
    device of ``X``."""
    m = X.shape[0]
    assert tree.total_data() == m, (
        f"tree data sizes {tree.total_data()} != m={m}")
    slices = dict(tree.leaf_slices())
    key = prng.PRNGKey(0) if key is None else prng.as_key(key).cpu()

    alpha = torch.zeros(m, dtype=X.dtype, device=X.device)
    w = torch.zeros(X.shape[1], dtype=X.dtype, device=X.device)
    # one root round's simulated wall-clock (children in parallel, barrier)
    per_round = per_round_time(tree)
    history: list = []

    def record(t: int):
        if not record_history:
            return
        dv = float(dual_mod.dual_value(alpha, X, y, loss, lam))
        pv = float(dual_mod.primal_value(
            dual_mod.w_of_alpha(alpha, X, lam), X, y, loss, lam))
        record_round(history, t, t * per_round, dv, pv)

    record(0)
    K = len(tree.children)
    for t in range(1, tree.rounds + 1):
        keys = prng.split(key, 1 + K)
        key, subkeys = keys[0], keys[1:]
        dws = []
        new_alpha = alpha.clone()
        for k, child in enumerate(tree.children):
            csl = _child_slice(child, slices)
            a_k, w_k = _solve_node(
                child, slices, X, y, alpha, w, subkeys[k], loss=loss,
                lam=lam, m_total=m, node_slice=csl)
            new_alpha[csl] = new_alpha[csl] + (a_k[csl] - alpha[csl]) / K
            dws.append(w_k - w)
        alpha = new_alpha
        w = w + sum(dws) / K
        record(t)

    return SolveResult(alpha=alpha, w=w, history=history, lam=lam)
