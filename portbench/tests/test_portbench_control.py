"""The control comes out not correct: the reference computed in bfloat16
(the precision below the configurations' float32) put in the program's
place fails the cell's limits, where the program's own job passes them.
At the harness's debug size on the CPU; ``portbench/control.py`` reads
the same at each cell's own size on the card."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench import control  # noqa: E402
from portbench.harness import cell as cell_mod  # noqa: E402
from portbench.harness import check, data, execute  # noqa: E402
from portbench.reference import sdca as ref_sdca  # noqa: E402

CELLS = [w["name"] for w in cell_mod.benchmark()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_where_the_program_passes(cell):
    c = cell_mod.load_cell(cell)
    job_mod = cell_mod.job_module(c.traffic["job"])
    config, traffic = execute.debug_sized(c.config, c.traffic, job_mod)
    X, y = data.make(config, 2 ** 32 + 9, "cpu")
    job = job_mod.Job(config, traffic, X, y, device="cpu", backend="torch",
                      spans=execute.Spans())
    got = job.members(job.run(0, 2 ** 32 + 9, None))
    expected = job.expected(0, 2 ** 32 + 9)
    spec = job.reference_spec()
    want = ref_sdca.tree_solve(X, y, members=expected, **spec)
    limits = traffic["limits"]
    assert check.verdict(check.readings(got, want), limits)
    ctl = check.readings(control.control_members(X, y, spec, expected),
                         want)
    assert not check.verdict(ctl, limits), ctl
