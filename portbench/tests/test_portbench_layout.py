"""BENCHMARK.json against the benchmark's contract and its own files: every
cell names a configuration, a traffic file and a job kind that exist,
every metric has a reader, every per-layer metric's cells report the
end-to-end metric it moves, and names, units and bounds keep to the
allowed forms."""
import json
import re
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "portbench/run.py"]
    assert SPEC["paths"] == ["portbench"]
    assert isinstance(SPEC["run_seconds"], int)
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_check_fits_its_budget_with_24_cells():
    # 2 + 14 runs a cell, each run_seconds + 60 s, 2 x 90 s a cell to
    # compile, 1200 s spare
    cells = 24
    total = (2 + 14 * cells) * (SPEC["run_seconds"] + 60) + cells * 180 \
        + 1200
    assert total <= 43200


@pytest.mark.parametrize("cell", CELLS)
def test_cell_names_files_that_exist(cell):
    entry = next(w for w in SPEC["workloads"] if w["name"] == cell)
    config = next(c for c in SPEC["configs"] if c["name"] == entry["config"])
    assert (ROOT / config["file"]).is_file()
    assert config["file"].startswith("portbench/")
    traffic = json.loads((ROOT / "portbench" / "workloads"
                          / f"{cell}.json").read_text())
    assert traffic["config"] == entry["config"]
    assert (ROOT / "portbench" / "jobs" / f"{traffic['job']}.py").is_file()
    assert set(traffic["limits"]) == {"alpha_rel", "w_rel", "gap_rel"}
    assert entry["chips"] == 1
    assert 1 <= len(entry["why"]) <= 200 and "\n" not in entry["why"]


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_every_metric_has_a_reader(metric):
    assert (ROOT / "portbench" / "metrics" / f"{metric}.py").is_file()


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_per_layer_cells_report_the_metric_they_move(metric):
    m = next(x for x in SPEC["per_layer"] if x["name"] == metric)
    moved = next(x for x in SPEC["end_to_end"] if x["name"] == m["moves"])
    for cell in m.get("workloads", CELLS):
        assert cell in CELLS
        assert "workloads" not in moved or cell in moved["workloads"]
    assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]


def test_names_units_and_bounds():
    names = [c["name"] for c in SPEC["configs"]] + CELLS + \
        [m["name"] for m in METRICS]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for w in SPEC["workloads"]:
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        assert sum(1 for v in SPEC["workloads"]
                   if (v["config"], v["traffic"]) ==
                   (w["config"], w["traffic"])) == 1
    for m in METRICS:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert "setup_s" in [m["name"] for m in SPEC["end_to_end"]]
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}


@pytest.mark.parametrize("cfg", [c["name"] for c in SPEC["configs"]])
def test_config_files_state_their_cuts(cfg):
    entry = next(c for c in SPEC["configs"] if c["name"] == cfg)
    data = json.loads((ROOT / entry["file"]).read_text())
    assert data["name"] == cfg and data["source"] == entry["source"]
    assert data["reduced"] == entry["reduced"]
    for key in entry["reduced"]:
        assert NAME.match(key) and key in data
        assert not key.endswith(("_dim", "_rank"))
    tree = data["tree"]
    n = 1
    for f in tree["fanouts"]:
        n *= f
    assert n * tree["m_leaf"] == data["rows"]
    assert len(tree["level_rounds"]) == len(tree["fanouts"]) - 1
