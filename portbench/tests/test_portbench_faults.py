"""A whole run at the harness's debug size on the CPU, past the look for a
card, with the timed path broken underneath: ``correct`` comes out false
for each fault a cell can have, and true with none.

The faults, planted in the port's executor (``core/engine/host.py``):
a step that returns its state unchanged; half of the leaves left out of a
solve tick, the mean taken over the rest; the exchange between the
tree's nodes (the syncs) left out; an answer altered where it is produced
(one dual of the finalized alpha).  A grid cell also reads false where
the port's ``Sweep`` solves other members than the traffic's grid: half
of them left out, or half of them twice in place of the others.
"""
import dataclasses
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench.harness import execute  # noqa: E402
from repro_torch.api import Sweep  # noqa: E402
from repro_torch.core.engine import host  # noqa: E402

CELLS = ["epsilon-svm-tree128.heavy-delay",
         "covtype-logreg-tree128.heavy-delay",
         "epsilon-svm-tree128.grid8"]
GRID_CELLS = ["epsilon-svm-tree128.grid8"]


def _run(cell: str, seed: int = 4294967311):
    return execute.execute(cell, seed, 0.3, False,
                           t_start=time.perf_counter(), device="cpu",
                           debug=True, log=lambda s: None)


def _unchanged(self, data, keys, state, *args, **kw):
    return state


def _half_batch(orig):
    def leaf_solve(self, data, a, w, xsq, idx, mk, lms):
        da, dw = orig(self, data, a, w, xsq, idx, mk, lms)
        half = da.shape[1] // 2
        da, dw = da.clone(), dw.clone()
        da[:, half:] = 0
        dw[:, half:] = 0
        return 2 * da, 2 * dw
    return leaf_solve


def _no_exchange(self, *args, **kw):
    return None


def _altered(orig):
    def finalize(self, state):
        a, w = orig(self, state)
        a = a.clone()
        a[..., 3] += 0.25
        return a, w
    return finalize


def _dropped(orig):
    def expand(self, default_lam):
        pts = orig(self, default_lam)
        return pts[:len(pts) // 2]
    return expand


def _doubled(orig):
    def expand(self, default_lam):
        pts = orig(self, default_lam)
        half = len(pts) // 2
        return pts[:half] + [dataclasses.replace(pts[i - half], index=i)
                             for i in range(half, len(pts))]
    return expand


GRID_FAULTS = {
    "members_dropped": lambda mp: mp.setattr(
        Sweep, "expand", _dropped(Sweep.expand)),
    "members_doubled": lambda mp: mp.setattr(
        Sweep, "expand", _doubled(Sweep.expand)),
}


FAULTS = {
    "state_unchanged": lambda mp: mp.setattr(host.HostExecutor, "step",
                                             _unchanged),
    "half_batch": lambda mp: mp.setattr(
        host.HostExecutor, "leaf_solve",
        _half_batch(host.HostExecutor.leaf_solve)),
    "exchange_left_out": lambda mp: mp.setattr(host.HostExecutor, "_sync",
                                               _no_exchange),
    "answer_altered": lambda mp: mp.setattr(
        host.HostExecutor, "finalize",
        _altered(host.HostExecutor.finalize)),
}


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    out = _run(cell)
    assert out["correct"] is True, out["check"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert list(out)[-2:] == ["check", "_lines"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_fault_makes_run_incorrect(cell, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    out = _run(cell)
    assert out["correct"] is False, (fault, out["check"])
    assert out["failed"] == 1


@pytest.mark.parametrize("fault", sorted(GRID_FAULTS))
@pytest.mark.parametrize("cell", GRID_CELLS)
def test_grid_of_other_members_makes_run_incorrect(cell, fault, monkeypatch):
    GRID_FAULTS[fault](monkeypatch)
    out = _run(cell)
    assert out["correct"] is False, (fault, out["check"])
    assert out["check"]["members"]["value"] >= 1


def test_no_card_no_result(monkeypatch, capsys):
    """Without a card the run prints no result and exits non-zero."""
    sys.path.insert(0, str(ROOT / "portbench"))
    import run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds",
                   "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""
