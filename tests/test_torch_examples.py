"""The port's copies of the four examples (examples/torch_*.py) run on the
CPU at their smallest size, each asserting its own headline claim:
quickstart's certificate, the SVM topology table, the eq.-(12) H* within
8x of the simulated best (at the largest delay, r = 1e4), and train_lm's
loss falling (--smoke)."""
import runpy
from pathlib import Path

import pytest

pytest.importorskip("torch")

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"

CASES = {
    "torch_quickstart": ["--device", "cpu"],
    "torch_svm_tree_network": ["--device", "cpu"],
    "torch_ridge_delay_sweep": ["--device", "cpu", "--delays", "1e4"],
    "torch_train_lm": ["--device", "cpu", "--smoke", "--steps", "8"],
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_example_runs_on_the_cpu(name, capsys, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    module = runpy.run_path(str(EXAMPLES / f"{name}.py"),
                            run_name="example")
    module["main"](CASES[name])
    out = capsys.readouterr().out
    assert out.strip()
    if name == "torch_quickstart":
        assert "topology JSON round-trip: ok" in out
    if name == "torch_train_lm":
        assert "loss:" in out
