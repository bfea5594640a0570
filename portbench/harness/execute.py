"""One run of one cell: set-up, the measured window, the correctness check
and the metrics.  ``run.py`` wraps it with the checks of the machine.

Set-up (``setup_s``, from the start of the process) makes the inputs from
the seed on the device, builds the job (``Session.compile``: the
benchmark's span ``session.compile``) and runs a job of one root round
with keys no window job uses (a job's rounds repeat its shapes), so every
kernel is built and every shape warmed.  The window then runs whole jobs
back to back and starts none once ``seconds`` have passed; a job's time
ends in a device synchronize.  With ``trace``
the window runs under ``torch.profiler``.  Once it has closed, the peak
memory is read, the program's state is freed, and the plain reference
re-solves one job drawn from the seed (by reservoir sampling over the
jobs run) to decide ``correct``: every member that the traffic defines
for that job, worked out by the harness, not read from the program.
"""
from __future__ import annotations

import contextlib
import gc
import random
import sys
import time
from typing import Callable, Dict, List

import torch

from portbench.harness import cell as cell_mod
from portbench.harness import check, data
from portbench.harness import trace as trace_mod
from portbench.reference import sdca as ref_sdca

DEBUG_M_LEAF = 16       # the debug size: rows a leaf, two children a node


class Spans:
    """The benchmark's own host-clock spans around calls into the port."""

    def __init__(self):
        self.seconds: Dict[str, float] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[name] = self.seconds.get(name, 0.0) + \
                time.perf_counter() - t0


def debug_sized(config: dict, traffic: dict, job_mod):
    """The cell at the harness's debug size (CPU rehearsals and tests):
    two children a node, ``DEBUG_M_LEAF`` rows a leaf, every width and
    round count kept; step counts scale with the rows a leaf, and lambda
    with 1 / rows, so that lambda * m -- and with it each coordinate
    step's conditioning -- stays as at full size."""
    tree = dict(config["tree"])
    steps = DEBUG_M_LEAF / tree["m_leaf"]
    tree["fanouts"] = [2] * len(tree["fanouts"])
    tree["m_leaf"] = DEBUG_M_LEAF
    rows = DEBUG_M_LEAF * 2 ** len(tree["fanouts"])
    lams = config["rows"] / rows
    return (dict(config, tree=tree, rows=rows, lam=config["lam"] * lams),
            job_mod.debug_traffic(traffic, steps, lams))


def execute(workload: str, seed: int, seconds: float, trace: bool, *,
            t_start: float, device: str = "cuda", debug: bool = False,
            root=cell_mod.ROOT, log: Callable[[str], None] = print) -> Dict:
    """Run cell ``workload`` once; returns the result dict (the last line
    ``run.py`` prints) with the check's lines under ``"_lines"``."""
    cell = cell_mod.load_cell(workload, root)
    config, traffic = cell.config, cell.traffic
    job_mod = cell_mod.job_module(traffic["job"], root)
    if debug:
        config, traffic = debug_sized(config, traffic, job_mod)
    wanted = cell.per_layer if trace else cell.end_to_end
    readers = cell_mod.metric_readers(wanted, root)
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    backend = "cuda" if on_card else "torch"

    spans = Spans()
    with spans("data"):
        X, y = data.make(config, seed, dev)
    job = job_mod.Job(config, traffic, X, y, device=dev, backend=backend,
                      spans=spans)
    with spans("warmup"):
        job.warmup(seed)
        sync()
    setup_s = time.perf_counter() - t_start
    parts = ", ".join(f"{k} {v:.3f} s" for k, v in spans.seconds.items())
    log(f"portbench: set-up {setup_s:.3f} s ({parts})")

    from repro_torch.kernels.sdca import kernel   # the port's counters
    c0 = (kernel.LAUNCHES, kernel.LEAVES)
    prof = contextlib.nullcontext()
    if trace:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if on_card else []))
    with prof:
        win = _window(job, seed, seconds, sync)
        t_stop = time.perf_counter()
    c1 = (kernel.LAUNCHES, kernel.LEAVES)
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    summary = None
    if trace:
        t_tr = time.perf_counter()
        summary = trace_mod.summarize(prof)
        del prof
        log(f"portbench: profiler stopped in {t_tr - t_stop:.3f} s, "
            f"{summary['events']} events taken in {summary['events_s']:.3f} "
            f"s, trace read in {time.perf_counter() - t_tr:.3f} s")

    # the check: the program's state freed, then the reference in float64
    kept_members = job.members(win["kept"])
    expected = job.expected(win["kept_index"], seed)
    spec = job.reference_spec()
    shape = job.launch_shape()
    del job, win["kept"]
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    want = ref_sdca.tree_solve(X, y, members=expected, **spec)
    sync()
    ref_s = time.perf_counter() - t_ref
    values = check.readings(kept_members, want)
    limits = traffic["limits"]
    correct = check.verdict(values, limits)
    log(f"portbench: reference {ref_s:.3f} s over job {win['kept_index']} "
        f"of {win['jobs']} ({len(kept_members)} members)")

    ctx = {
        "cell": cell.name, "config": config, "traffic": traffic,
        "setup_s": setup_s, "spans": dict(spans.seconds),
        "job_seconds": win["job_seconds"], "round_seconds": win["rounds"],
        "peak_bytes": peak, "launches": c1[0] - c0[0],
        "leaves": c1[1] - c0[1], "launch_shape": shape,
        # a CPU rehearsal's trace has no device: no device metric from it
        "trace": summary if on_card else None,
    }
    metrics = {}
    for m in wanted:
        v = readers[m["name"]].read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    result = {
        "correct": bool(correct),
        "attempted": win["jobs"],
        "failed": 0 if correct else 1,
        "metrics": metrics,
        "device": _device(dev, peak),
    }
    if summary is not None:
        result["device"]["busy_s"] = summary["busy_s"]
        result["device"]["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["check"] = check.record(values, limits)
    result["_lines"] = check.lines(values, limits)
    return result


def _window(job, seed: int, seconds: float, sync) -> Dict:
    """Whole jobs back to back until ``seconds`` have passed; keeps one
    job's output, drawn uniformly from the seed over the jobs run."""
    pick = random.Random(seed)
    job_seconds: List[float] = []
    rounds: List[float] = []
    kept, kept_index = None, None
    rf = torch.profiler.record_function
    with rf(trace_mod.WINDOW):
        t_w = time.perf_counter()
        i = 0
        while time.perf_counter() - t_w < seconds:
            stamps: List[float] = []

            def on_round(_entry, stamps=stamps):
                stamps.append(time.perf_counter())

            t0 = time.perf_counter()
            with rf("portbench.job"):
                out = job.run(i, seed, on_round)
                sync()
            t1 = time.perf_counter()
            job_seconds.append(t1 - t0)
            # round k runs from stamp k-1 to stamp k; the job's start
            # stands in for round 0's stamp, so round 1 carries the cold
            # start (key plan, state init)
            marks = [t0] + stamps[1:]
            rounds.extend(b - a for a, b in zip(marks, marks[1:]))
            if i == 0 or pick.randrange(i + 1) == 0:
                kept, kept_index = out, i
            out = None
            i += 1
    return {"jobs": i, "job_seconds": job_seconds, "rounds": rounds,
            "kept": kept, "kept_index": kept_index}


def _device(dev: torch.device, peak: int) -> Dict:
    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": 1, "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu (debug size)", "count": 0,
            "memory_peak_bytes": 0}


def modules_found(names=("jax", "jaxlib", "flax", "repro")) -> List[str]:
    """Modules in ``sys.modules`` whose whole top-level name is one of
    ``names`` (``repro_torch`` is not ``repro``)."""
    return sorted({k for k in list(sys.modules)
                   if k.split(".")[0] in names})

