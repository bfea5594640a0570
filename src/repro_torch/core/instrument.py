"""Instrumentation for solver runs: the simulated wall-clock of the tree's
delay model and the per-root-round history, as in the JAX package's
``core/instrument.py``.

* simulated wall-clock: ``TreeNode.solve_time`` (the generalization of
  paper eq. (9)) gives the per-root-round time;
* history: a list of ``{round, time, dual, primal, gap}`` dicts wrapped in
  :class:`SolveResult`, with array accessors;
* batched histories: the sweep layer (``api/sweep.py``) stores a config
  batch's series as ``(B, T)`` arrays -- :func:`stack_histories` /
  :func:`history_row` convert between that schema and the per-run dict
  lists (NaN-padded where members recorded fewer rounds).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.tree import TreeNode

HISTORY_FIELDS = ("round", "time", "dual", "primal", "gap")


@dataclasses.dataclass
class SolveResult:
    """A solver run: final iterates + per-root-round instrumentation.

    ``next_key`` is the root RNG chain state after the run (a CPU int64
    key), so a warm-restarted continuation reproduces one longer run;
    ``lam`` records the regularization the run used, so a warm restart
    under another lambda rebuilds ``w = X^T alpha / (lam m)``."""
    alpha: torch.Tensor
    w: torch.Tensor
    history: List[dict]
    next_key: Optional[torch.Tensor] = None
    lam: Optional[float] = None

    @property
    def times(self) -> np.ndarray:
        return np.array([h["time"] for h in self.history])

    @property
    def gaps(self) -> np.ndarray:
        return np.array([h["gap"] for h in self.history])

    @property
    def duals(self) -> np.ndarray:
        return np.array([h["dual"] for h in self.history])

    @property
    def primals(self) -> np.ndarray:
        return np.array([h["primal"] for h in self.history])

    def to_dict(self) -> dict:
        """JSON-serializable form (iterates as lists, history as-is)."""
        return {
            "alpha": self.alpha.detach().cpu().tolist(),
            "w": self.w.detach().cpu().tolist(),
            "history": [dict(h) for h in self.history],
            "next_key": (None if self.next_key is None
                         else self.next_key.cpu().tolist()),
            "lam": None if self.lam is None else float(self.lam),
        }


def per_round_time(tree: TreeNode) -> float:
    """Simulated wall-clock of ONE root round (children in parallel,
    synchronous barrier; paper eq. (9) when the tree is a star)."""
    return tree.solve_time() / max(tree.rounds, 1)


def round_times(tree: TreeNode) -> np.ndarray:
    """Times of rounds 0..T (round 0 is the start-of-run record)."""
    return np.arange(tree.rounds + 1) * per_round_time(tree)


def history_from_series(
    times: Sequence[float],
    duals: Sequence[float],
    primals: Sequence[float],
) -> List[dict]:
    """Assemble the history-dict list from aligned series."""
    out = []
    for t, (tm, dv, pv) in enumerate(zip(times, duals, primals,
                                         strict=True)):
        out.append({"round": t, "time": float(tm), "dual": float(dv),
                    "primal": float(pv), "gap": float(pv) - float(dv)})
    return out


def record_round(history: List[dict], t: int, time: float, dual: float,
                 primal: float) -> None:
    """Append one history entry (host floats; the gap is their float64
    difference)."""
    history.append({"round": t, "time": time, "dual": dual,
                    "primal": primal, "gap": primal - dual})


# ---------------------------------------------------------------------------
# batched-history schema (the sweep layer's (B, T) representation)
# ---------------------------------------------------------------------------
def stack_histories(histories: Sequence[List[dict]]) -> Dict[str, np.ndarray]:
    """Stack B per-run history dict-lists into ``{field: (B, T_max)}``
    float arrays (one per :data:`HISTORY_FIELDS`), NaN-padding members that
    recorded fewer rounds -- the ``api/sweep.py::RunSet`` history
    schema.  Extra per-entry keys (async instrumentation) are dropped."""
    B = len(histories)
    t_max = max((len(h) for h in histories), default=0)
    out = {f: np.full((B, t_max), np.nan) for f in HISTORY_FIELDS}
    for b, hist in enumerate(histories):
        for t, entry in enumerate(hist):
            for f in HISTORY_FIELDS:
                out[f][b, t] = float(entry[f])
    return out


def history_row(stacked: Dict[str, np.ndarray], b: int) -> List[dict]:
    """Reconstruct member ``b``'s history dict-list from a
    :func:`stack_histories` batch (NaN padding rows are dropped)."""
    out: List[dict] = []
    rounds = stacked["round"]
    for t in range(rounds.shape[1]):
        if not np.isfinite(rounds[b, t]):
            continue
        out.append({
            "round": int(rounds[b, t]),
            "time": float(stacked["time"][b, t]),
            "dual": float(stacked["dual"][b, t]),
            "primal": float(stacked["primal"][b, t]),
            "gap": float(stacked["gap"][b, t]),
        })
    return out
