"""The benchmark measures the port alone: no file under ``portbench/``
imports JAX or the JAX package (``repro``; top-level names compared
whole, since ``repro_torch`` begins with ``repro``), nothing under
``portbench/reference/`` imports the port, and a CPU rehearsal of a run
ends with none of them in ``sys.modules``.  A checkout without the port
gives no result."""
import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
BANNED = {"jax", "jaxlib", "flax", "repro"}
FILES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & BANNED, (path, tops & BANNED)


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in BANNED | {"repro_torch"}, name
        if top == "portbench":
            assert name.startswith("portbench.reference"), name


REHEARSAL = """
import json, sys
sys.argv = ["run.py", "--workload", "covtype-logreg-tree128.heavy-delay",
            "--seed", "8589934597", "--seconds", "0.2", "--trace", "1",
            "--debug"]
sys.path.insert(0, {bench!r})
import run
rc = run.main(sys.argv[1:])
print(json.dumps({{"rc": rc, "modules": sorted({{k.split(".")[0]
                  for k in sys.modules}})}}))
"""


def test_rehearsal_loads_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", REHEARSAL.format(bench=str(BENCH))],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    lines = out.stdout.strip().splitlines()
    result, tail = json.loads(lines[-2]), json.loads(lines[-1])
    assert tail["rc"] == 0, out.stderr[-2000:]
    assert result["correct"] is True
    assert "repro_torch" in tail["modules"]
    assert not set(tail["modules"]) & BANNED, tail["modules"]


def test_checkout_without_the_port_gives_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "epsilon-svm-tree128.heavy-delay", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, env=env,
        cwd=tmp_path, timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
