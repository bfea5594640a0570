"""Carry state between the JAX package and this one, through numpy.

``from_reference`` turns the parts of a reference ``SolveResult`` (as
numpy arrays: ``np.asarray(res.alpha)``, ...) into this package's
:class:`~repro_torch.core.instrument.SolveResult`, so a run of the port
can continue one of the reference (``Session.run(warm_start=...)``);
``problem_from_numpy`` builds a :class:`~repro_torch.api.problem.Problem`
from the arrays a reference ``Problem`` was built from;
``lm_params_from_reference`` carries a reference LM's parameters over;
``exec_state_from_reference`` turns a reference state-executor carry into
this package's :class:`~repro_torch.core.engine.host.ExecState`;
``lm_state_from_reference`` / ``lm_state_to_reference`` carry an LM
TreeSync state (params, optimizer state, step, residual) across, one
replica's row of the reference's replica-stacked state.  The tests start
both packages from the same state this way.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.api.problem import Problem
from repro_torch.core import prng
from repro_torch.core.engine.host import ExecState
from repro_torch.core.instrument import SolveResult
from repro_torch.models.transformer import block_layout


def from_reference(alpha, w, history: Sequence[dict] = (), next_key=None,
                   lam: Optional[float] = None,
                   device="cuda") -> SolveResult:
    """A :class:`SolveResult` on ``device`` from numpy ``alpha`` (m,),
    ``w`` (d,), a reference history (list of dicts) and the reference's
    uint32 ``next_key``."""
    return SolveResult(
        alpha=torch.as_tensor(np.array(alpha, np.float32), device=device),
        w=torch.as_tensor(np.array(w, np.float32), device=device),
        history=[dict(h) for h in history],
        next_key=None if next_key is None else prng.as_key(
            np.asarray(next_key)),
        lam=None if lam is None else float(lam))


def to_reference(res: SolveResult) -> dict:
    """The parts of ``res`` as numpy arrays (``alpha``, ``w``, uint32
    ``next_key``), plus its history and lambda, for the reference side."""
    return {
        "alpha": res.alpha.detach().cpu().numpy(),
        "w": res.w.detach().cpu().numpy(),
        "history": [dict(h) for h in res.history],
        "next_key": (None if res.next_key is None
                     else res.next_key.cpu().numpy().astype(np.uint32)),
        "lam": res.lam,
    }


def exec_state_from_reference(carry, device="cuda") -> ExecState:
    """The port's executor state from a reference ``StateExecutor`` carry
    as numpy arrays (``jax.tree.map(np.asarray, state)``): ``(a (n, m_b),
    w (n, d), snapA (D, n, m_b), snapW (D, n, d), srvW (D, n, d)[, srvP
    (D, n, d), srvA (D, n, m_b)][, residuals])`` -- the momentum anchors
    of an accelerated executor, the residuals one (n, d) array per
    compressed depth.  A batched executor's carry (a leading config axis
    B on every array: ``a`` (B, n, m_b), ``snapA`` (B, D, n, m_b), ...)
    gives the batched state."""
    a, w, snapA, snapW, srvW = (np.array(c) for c in carry[:5])
    rest = list(carry[5:])
    anchors = ((), ())
    if len(rest) >= 2 and not isinstance(rest[0], (tuple, list)):
        anchors, rest = (np.array(rest[0]), np.array(rest[1])), rest[2:]
    res = tuple(rest[0]) if rest else ()
    batched = a.ndim == 3

    def t(x):
        return torch.as_tensor(np.array(x), device=device)

    def per_depth(x):
        if isinstance(x, tuple):
            return x
        x = np.moveaxis(x, 1, 0) if batched else x   # depth first
        return tuple(t(x[d]) for d in range(x.shape[0]))
    return ExecState(t(a), t(w), per_depth(snapA), per_depth(snapW),
                     per_depth(srvW), tuple(t(r) for r in res),
                     per_depth(anchors[0]), per_depth(anchors[1]))


def problem_from_numpy(X, y, loss="squared", lam: float = 0.1,
                       device="cuda") -> Problem:
    """A Problem on ``device`` from numpy (m, d) data and (m,) labels."""
    return Problem(
        torch.as_tensor(np.array(X, np.float32), device=device),
        torch.as_tensor(np.array(y, np.float32), device=device),
        loss=loss, lam=lam)


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":   # ml_dtypes' bfloat16, which torch lacks
        return torch.as_tensor(a.astype(np.float32),
                               device=device).to(torch.bfloat16)
    return torch.as_tensor(np.array(a), device=device)


def _tree(node, device, index=None):
    """A numpy tree (dicts, lists; ``None`` kept) as tensors on
    ``device``, taking row ``index`` of every leaf when given."""
    if node is None:
        return None
    if isinstance(node, dict):
        return {k: _tree(v, device, index) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_tree(v, device, index) for v in node]
    return _tensor(node if index is None else np.asarray(node)[index],
                   device)


def lm_params_from_reference(tree, cfg, device="cuda") -> dict:
    """The port's LM parameters on ``device`` from the reference's
    ``repro.models.transformer.init_params(cfg, key)`` with numpy leaves
    (``jax.tree.map(np.asarray, params)``): the stacked ``blocks`` are
    split into one dict per block; ``tail``, the tied or untied embedding
    and the norms carry over as they are."""
    _, n_full, _ = block_layout(cfg)
    out = {k: _tree(v, device) for k, v in tree.items() if k != "blocks"}
    if "blocks" in tree:
        out["blocks"] = [_tree(tree["blocks"], device, i)
                         for i in range(n_full)]
    return out


def lm_state_from_reference(state, replica: int = 0, device="cuda", *,
                            cfg=None, mesh=None):
    """Replica ``replica`` of a reference ``TreeSyncState`` with numpy
    leaves (``jax.tree.map(np.asarray, state)``; the fields may also be
    given as a dict ``{"params", "opt_state", "step", "residual"}``) as
    this package's :class:`~repro_torch.core.engine.lm.TreeSyncState` on
    ``device``: params in the reference's layout (blocks stacked), the
    optimizer state entry for entry (its step a 0-d int32 tensor), the
    host step and the residual.  With ``mesh`` (and the model's ``cfg``)
    whose ``model`` axis is larger than 1, this rank's shards of it, cut
    by the replica's specs (``engine.lm.cut_replica_state``)."""
    from repro_torch.core.engine.lm import TreeSyncState, cut_replica_state
    from repro_torch.launch.mesh import axis_size
    get = (state.get if isinstance(state, dict)
           else lambda k: getattr(state, k, None))
    opt = _tree(get("opt_state"), device, replica)
    out = TreeSyncState(
        params=_tree(get("params"), device, replica),
        opt_state=opt, step=int(np.asarray(get("step"))),
        residual=_tree(get("residual"), device, replica))
    if mesh is not None and axis_size(mesh, "model") > 1:
        out = cut_replica_state(cfg, mesh, out)
    return out


def _numpy_tree(node):
    if node is None:
        return None
    if isinstance(node, dict):
        return {k: _numpy_tree(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_numpy_tree(v) for v in node]
    t = node.detach().cpu()
    return (t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy())


def lm_state_to_reference(states) -> dict:
    """The reference's replica-stacked state as numpy, from this
    package's per-replica states (a list, in replica order):
    ``{"params", "opt_state", "step", "residual"}`` with every leaf
    stacked on a leading (R,) axis (bfloat16 leaves as float32)."""
    def stack(trees):
        if trees[0] is None:
            return None
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        if isinstance(trees[0], list):
            return [stack([t[i] for t in trees])
                    for i in range(len(trees[0]))]
        return np.stack(trees)
    return {
        "params": stack([_numpy_tree(s.params) for s in states]),
        "opt_state": stack([_numpy_tree(s.opt_state) for s in states]),
        "step": np.asarray(int(states[0].step), np.int32),
        "residual": stack([_numpy_tree(s.residual) for s in states]),
    }
