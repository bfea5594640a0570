"""A later cell and a later per-layer metric are new files plus new
entries of BENCHMARK.json: in a copy of the benchmark, a new cell (a
traffic file) and a new metric (a reader) run at the debug size without
any file that was there being edited."""
import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

NEW_CELL = "covtype-logreg-tree128.one-round"
NEW_METRIC = "job.count"


def _digests(root: Path):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_new_cell_and_metric_are_new_files(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "src").symlink_to(ROOT / "src")
    before = _digests(tmp_path / "portbench")

    (tmp_path / "portbench" / "workloads" / f"{NEW_CELL}.json").write_text(
        json.dumps({"config": "covtype-logreg-tree128", "job": "solve",
                    "rounds": 1, "local_steps": 4539,
                    "why": "one root round a solve",
                    "limits": {"alpha_rel": 1e-3, "w_rel": 1e-3,
                               "gap_rel": 1e-3}}))
    (tmp_path / "portbench" / "metrics" / f"{NEW_METRIC}.py").write_text(
        '"""Jobs the window completed."""\n\n\n'
        'def read(ctx):\n    return len(ctx["job_seconds"])\n')
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": NEW_CELL,
                              "config": "covtype-logreg-tree128",
                              "traffic": "one-round", "chips": 1,
                              "why": "one root round a solve"})
    spec["per_layer"].append({"name": NEW_METRIC, "unit": "jobs",
                              "better": "higher", "source": "host_clock",
                              "layer": "the window", "moves": "solve_s",
                              "workloads": [NEW_CELL]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", NEW_CELL,
         "--seed", "12", "--seconds", "0.5", "--trace", "1", "--debug"],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert result["metrics"][NEW_METRIC]["value"] >= 1
    assert result["metrics"]["session.compile_s"]["value"] > 0
    after = _digests(tmp_path / "portbench")
    assert all(after[p] == d for p, d in before.items())
