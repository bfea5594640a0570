"""Finding a cell's parts by name.

Everything that belongs to one configuration, one cell, one job kind or
one metric sits in a file of its own, named after it, and ``BENCHMARK.json``
names them:

  * ``configs/<config>.json``: the dataset shape, loss, lambda, tree;
  * ``workloads/<cell>.json``: the configuration, the job kind, the
    traffic parameters and the limits of the correctness check;
  * ``jobs/<kind>.py``: how the window drives the port for that kind;
  * ``metrics/<metric>.py``: one reader per metric, ``read(ctx)``.

A later cell, configuration, job kind or metric is new files and new
entries; no file here changes.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

ROOT = Path(__file__).resolve().parents[2]     # the checkout


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    end_to_end: List[dict]      # BENCHMARK.json entries this cell reports
    per_layer: List[dict]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s BENCHMARK.json with its files."""
    spec = benchmark(root)
    entries = {w["name"]: w for w in spec["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(entries)})")
    entry = entries[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = load_json(root / configs[entry["config"]]["file"])
    traffic = load_json(root / "portbench" / "workloads" / f"{name}.json")
    if traffic.get("config") != entry["config"]:
        raise ValueError(f"workloads/{name}.json names config "
                         f"{traffic.get('config')!r}, BENCHMARK.json "
                         f"{entry['config']!r}")
    return Cell(name, config, traffic,
                [m for m in spec["end_to_end"] if _applies(m, name)],
                [m for m in spec["per_layer"] if _applies(m, name)])


def load_module(path: Path, name: str) -> ModuleType:
    """Import the file ``path`` as a module named ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def job_module(kind: str, root: Path = ROOT) -> ModuleType:
    return load_module(root / "portbench" / "jobs" / f"{kind}.py",
                       f"portbench_job_{kind}")


def metric_readers(metrics: List[dict], root: Path = ROOT
                   ) -> Dict[str, ModuleType]:
    return {m["name"]: load_module(
        root / "portbench" / "metrics" / f"{m['name']}.py",
        "portbench_metric_" + m["name"].replace(".", "_").replace("-", "_"))
        for m in metrics}
