"""The comparison that decides ``correct``.

What a job produced is held against the plain reference
(``portbench/reference/sdca.py``) run on the same inputs, in float64, for
every member that the cell's traffic defines: the job's own ``expected``
members (lambda, key and local steps of each, in the order the port's
``Sweep`` lays a grid out), worked out by the harness and never read
from the program.  Four numbers, each the worst over the members:

  * ``alpha_rel``: max |alpha - alpha_ref| / max |alpha_ref|;
  * ``w_rel``: max |w - w_ref| / max |w_ref|;
  * ``gap_rel``: max over the rounds of |gap - gap_ref| / gap_ref;
  * ``members``: the places at which the program's members and the
    reference's differ -- one missing, one more, or another (lambda, key,
    steps) at that place; an exact comparison, limit 0.

A reference member with no program member of its own at its place reads
infinity in the first three.  Their limits are in the cell's
``workloads/<cell>.json`` (``limits``), set from the readings of sound
runs and of the control (``PERF.md``).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

NUMBERS = ("alpha_rel", "w_rel", "gap_rel", "members")
EXACT = {"members": 0.0}
M32 = 0xFFFFFFFF


def spec_of(member: Dict) -> tuple:
    """A member's (lambda, key words, local steps)."""
    return (float(member["lam"]), tuple(int(k) & M32 for k in member["key"]),
            int(member["h"]))


def _member(g: Dict, r: Dict) -> Dict[str, float]:
    a_ref = r["alpha"].double().cpu()
    w_ref = r["w"].double().cpu()
    vals = {
        "alpha_rel": float((torch.as_tensor(g["alpha"]).double().cpu()
                            - a_ref).abs().max() / a_ref.abs().max()),
        "w_rel": float((torch.as_tensor(g["w"]).double().cpu()
                        - w_ref).abs().max() / w_ref.abs().max()),
    }
    gp = np.asarray(g["gaps"], np.float64)
    gr = np.asarray(r["gaps"], np.float64)
    if gp.shape != gr.shape:
        vals["gap_rel"] = float("inf")
    else:
        vals["gap_rel"] = float(np.max(np.abs(gp - gr) / np.abs(gr)))
    return {k: v if np.isfinite(v) else float("inf")
            for k, v in vals.items()}


def readings(got: List[Dict], want: List[Dict]) -> Dict[str, float]:
    """The compared numbers of members ``got`` (the program's, or the
    control's) against ``want`` (the reference's, one per member the
    traffic defines).  A number that is not finite reads as infinity."""
    out = {k: 0.0 for k in NUMBERS}
    for i in range(max(len(got), len(want))):
        g = got[i] if i < len(got) else None
        r = want[i] if i < len(want) else None
        if g is None or r is None or spec_of(g) != spec_of(r):
            out["members"] += 1.0
            if r is not None:
                for k in ("alpha_rel", "w_rel", "gap_rel"):
                    out[k] = float("inf")
            continue
        for k, v in _member(g, r).items():
            out[k] = max(out[k], v)
    return out


def _limits(limits: Dict[str, float]) -> Dict[str, float]:
    return {**{k: float(v) for k, v in limits.items()}, **EXACT}


def verdict(values: Dict[str, float], limits: Dict[str, float]) -> bool:
    lim = _limits(limits)
    return all(values[k] <= lim[k] for k in NUMBERS)


def lines(values: Dict[str, float], limits: Dict[str, float]) -> List[str]:
    lim = _limits(limits)
    return [f"check {k} {values[k]!r} limit {lim[k]!r}" for k in NUMBERS]


def record(values: Dict[str, float], limits: Dict[str, float]) -> Dict:
    lim = _limits(limits)
    return {k: {"value": values[k], "limit": lim[k]} for k in NUMBERS}
