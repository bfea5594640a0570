"""The plain reference against the port's ``backend="torch"`` sessions at a
tiny size on the CPU: the threefry copy draws what the port draws, and a
reference solve -- keys, draws, leaf chains, combinations at every depth,
the gap history -- agrees with ``Session.run`` and ``Session.sweep``."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench.harness import check, data  # noqa: E402
from portbench.reference import sdca as ref_sdca  # noqa: E402
from portbench.reference import threefry  # noqa: E402
from repro_torch.api import (Problem, Schedule, Session, Sweep,  # noqa: E402
                             Topology)
from repro_torch.core import prng  # noqa: E402

TOL = 2e-5     # float32 program against the float64 reference, tiny sizes


def test_threefry_copy_draws_as_the_port():
    keys = torch.tensor([[0, 7], [123456, 4294967295], [2 ** 31, 5]],
                        dtype=torch.int64)
    assert torch.equal(threefry.split(keys, 5), prng.split(keys, 5))
    for mb in (1, 7, 3125, 4539, 2 ** 31 - 1):
        want = prng.randint(keys, (64,), 0, mb).to(torch.int64)
        assert torch.equal(threefry.randint(keys, (64,), mb), want)


def _dataset(loss: str, rows: int, d: int, seed: int):
    cfg = {"rows": rows, "columns": [{"kind": "gaussian", "count": d}],
           "row_norm": "unit",
           "labels": {"kind": "planted", "threshold": "zero", "flip": 0.1}}
    X, y = data.make(cfg, seed, "cpu")
    if loss == "squared":
        y = y + 0.1 * torch.randn(rows, generator=torch.Generator()
                                  .manual_seed(seed))
    return X, y


@pytest.mark.parametrize("loss,fanouts,level_rounds", [
    ("hinge", [2, 3], [2]),
    ("logistic", [2, 2, 2], [2, 1]),
    ("squared", [4], []),
])
def test_reference_solve_matches_session_run(loss, fanouts, level_rounds):
    m_leaf, H, R = 12, 30, 3
    n = int(np.prod(fanouts))
    X, y = _dataset(loss, n * m_leaf, 9, seed=11)
    lam = 3.0 / (n * m_leaf)
    sess = Session.compile(
        Problem(X, y, loss=loss, lam=lam),
        Topology.balanced(fanouts, m_leaf=m_leaf),
        Schedule(rounds=R, level_rounds=level_rounds, local_steps=H),
        backend="torch", device="cpu")
    key = torch.tensor([5, 4294967291], dtype=torch.int64)
    res = sess.run(key=key)
    member = {"lam": lam, "key": key.tolist(), "h": H}
    got = [dict(member, alpha=res.alpha, w=res.w,
                gaps=[e["gap"] for e in res.history])]
    want = ref_sdca.tree_solve(
        X, y, loss=loss, fanouts=fanouts, level_rounds=level_rounds,
        rounds=R, h_cap=H, members=[member])
    values = check.readings(got, want)
    assert all(v < TOL for v in values.values()), values
    assert want[0]["gaps"][-1] < want[0]["gaps"][0]


def test_reference_grid_matches_session_sweep():
    fanouts, level_rounds, m_leaf, cap, R = [2, 2], [2], 10, 24, 2
    X, y = _dataset("logistic", 40, 6, seed=3)
    sess = Session.compile(
        Problem(X, y, loss="logistic", lam=0.05),
        Topology.balanced(fanouts, m_leaf=m_leaf),
        Schedule(rounds=R, level_rounds=level_rounds, local_steps=cap,
                 h_cap=cap), backend="torch", device="cpu")
    seeds = [torch.tensor([1, 2], dtype=torch.int64),
             torch.tensor([3, 4], dtype=torch.int64)]
    rs = sess.sweep(Sweep(lams=[0.05, 0.2], seeds=seeds, local_hs=[7, 24]))
    members = [{"lam": lam, "key": key.tolist(), "h": h}
               for lam in (0.05, 0.2) for h in (7, 24) for key in seeds]
    got = [{"lam": pt.lam, "key": pt.seed.tolist(), "h": pt.local_h,
            "alpha": rs.alphas[b], "w": rs.ws[b],
            "gaps": list(rs.history["gap"][b])}
           for b, pt in enumerate(rs.points)]
    want = ref_sdca.tree_solve(X, y, loss="logistic", fanouts=fanouts,
                               level_rounds=level_rounds, rounds=R,
                               h_cap=cap, members=members)
    values = check.readings(got, want)
    assert all(v < TOL for v in values.values()), values


SPEC = {"lam": 0.1, "key": [3, 4], "h": 5}
LOOSE = {"alpha_rel": 1, "w_rel": 1, "gap_rel": 1}


def test_readings_catch_a_wrong_member():
    a = torch.tensor([0.0, 0.5, -0.25])
    w = torch.tensor([1.0, 2.0])
    ref = [dict(SPEC, alpha=a.double(), w=w.double(), gaps=[1.0, 0.5])]
    ok = check.readings([dict(SPEC, alpha=a, w=w, gaps=[1.0, 0.5])], ref)
    assert ok == {"alpha_rel": 0.0, "w_rel": 0.0, "gap_rel": 0.0,
                  "members": 0.0}
    bad = check.readings([dict(SPEC, alpha=a * 0, w=w, gaps=[1.0, 0.6])],
                         ref)
    assert bad["alpha_rel"] == 1.0 and bad["gap_rel"] == pytest.approx(0.2)
    nan = check.readings([dict(SPEC, alpha=a, w=w * float("nan"),
                               gaps=[1.0])], ref)
    assert nan["w_rel"] == float("inf") and nan["gap_rel"] == float("inf")
    assert not check.verdict(nan, LOOSE)


@pytest.mark.parametrize("change", ["dropped", "extra", "other_key",
                                    "other_lam", "other_h", "swapped"])
def test_readings_catch_members_that_differ_from_the_grid(change):
    a = torch.tensor([0.0, 0.5, -0.25])
    w = torch.tensor([1.0, 2.0])
    specs = [dict(SPEC, lam=lam) for lam in (0.1, 0.2)]
    ref = [dict(sp, alpha=a.double(), w=w.double(), gaps=[1.0, 0.5])
           for sp in specs]
    got = [dict(sp, alpha=a, w=w, gaps=[1.0, 0.5]) for sp in specs]
    assert check.verdict(check.readings(got, ref), LOOSE)
    if change == "dropped":
        got = got[:1]
    elif change == "extra":
        got = got + got[:1]
    elif change == "swapped":
        got = got[::-1]
    else:
        key = {"other_key": "key", "other_lam": "lam", "other_h": "h"}
        got[1] = dict(got[1], **{key[change]: {"key": [3, 5], "lam": 0.3,
                                              "h": 4}[key[change]]})
    values = check.readings(got, ref)
    assert values["members"] >= 1
    assert not check.verdict(values, LOOSE)
    assert check.record(values, LOOSE)["members"]["limit"] == 0.0
