"""The per-layer metrics read from the port's own spans and counters
(``repro_torch.core.instrument``): a ``--trace 1`` run at the debug size
reports the host-side ones, with the bytes and host syncs that the cell's
traffic implies, and each reader returns nothing on a port that has no
spans."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench.harness import cell as cell_mod  # noqa: E402
from portbench.harness import execute  # noqa: E402

HOST_SIDE = ["key_plan.ms_per_job", "h2d.mb_per_job", "host.syncs_per_job"]
PROGRAM = HOST_SIDE + ["tick.draw_ms"]


def _expected(cell: str):
    """(MB a job, host syncs a job) at the debug size, from the traffic:
    each member's (R, S, n, 2) int64 key plan and (S, n, H) float32 step
    mask, one (S, n) float32 participation mask, S = the product of the
    level rounds; a solve reads its history every root round and once at
    the start, a grid once."""
    c = cell_mod.load_cell(cell)
    job = cell_mod.job_module(c.traffic["job"])
    config, traffic = execute.debug_sized(c.config, c.traffic, job)
    tree = config["tree"]
    n = 2 ** len(tree["fanouts"])
    S = 1
    for r in tree["level_rounds"]:
        S *= r
    R, H = traffic["rounds"], traffic["local_steps"]
    if traffic["job"] == "grid":
        B = len(traffic["lams"] or [1]) * len(traffic["local_hs"] or [1]) \
            * traffic["seeds"]
        H = traffic["h_cap"] or H
        syncs = 1
    else:
        B, syncs = 1, R + 1
    nbytes = B * (R * S * n * 2 * 8 + S * n * H * 4) + S * n * 4
    return nbytes / 1e6, syncs


@pytest.mark.parametrize("cell", ["epsilon-svm-tree128.heavy-delay",
                                  "epsilon-svm-tree128.grid8"])
def test_traced_debug_run_reports_program_metrics(cell):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell,
         "--seed", "3000000019", "--seconds", "0.5", "--trace", "1",
         "--debug"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    metrics = result["metrics"]
    for name in HOST_SIDE:
        assert metrics[name]["value"] > 0, name
    assert "tick.draw_ms" not in metrics          # no CUDA stream on a CPU
    mb, syncs = _expected(cell)
    assert metrics["h2d.mb_per_job"]["value"] == pytest.approx(mb, rel=1e-12)
    assert metrics["host.syncs_per_job"]["value"] == syncs


@pytest.mark.parametrize("metric", PROGRAM)
def test_reader_reads_nothing_without_the_program_spans(metric,
                                                        monkeypatch):
    from repro_torch.core import instrument
    monkeypatch.delattr(instrument, "snapshot")
    reader = cell_mod.metric_readers([{"name": metric}])[metric]
    assert reader.read({"job_seconds": [1.0, 1.0]}) is None


def test_draw_reader_reads_the_busy_stream_pairs(monkeypatch):
    """``tick.draw_ms`` is the mean of the event pairs the port resolved
    (spans opened on a busy stream), whatever the number of spans."""
    from repro_torch.core import instrument
    snap = {"spans": {"tick.draw": {"count": 8, "seconds": 0.5}},
            "device_ms": {"tick.draw": {"count": 4, "ms": 62.0}},
            "counts": {}}
    monkeypatch.setattr(instrument, "snapshot", lambda: snap)
    reader = cell_mod.metric_readers(
        [{"name": "tick.draw_ms"}])["tick.draw_ms"]
    assert reader.read({"job_seconds": [1.0]}) == 15.5
    snap["device_ms"] = {}                   # no pair: no reading
    assert reader.read({"job_seconds": [1.0]}) is None

