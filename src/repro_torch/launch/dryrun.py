"""Multi-pod dry-run: count EVERY (architecture x input-shape) cell on the
production meshes and record its memory, cost, collectives and roofline
(the JAX package's ``launch/dryrun.py``).

The reference lowers and compiles each cell for 512 forced host devices
and reads XLA's analyses.  Here a cell's program runs once, for rank 0 of
an abstract mesh (``launch/mesh.py::make_abstract_mesh``; no process
group, no devices), on ``meta`` stand-ins, and ``CellProgram.lower``
counts it (``launch/lowered.py``): flops, bytes per aten op, the peak of
live bytes, the kernels' own costs and the collectives of the counting
comm.  The layers are a Python loop, counted at full depth
(``analysis_mode`` "full-depth count on meta"), but for RWKV6's train and
prefill cells: their WKV chunk loop runs ~15 ops per 16-token chunk per
layer, which takes minutes on meta at 4k-32k tokens, so those are counted
with 1 and 2 blocks and every number fitted a + b n to the full depth,
as the reference fits its scan compiles ("1/2-block affine fit on
meta").

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun                # everything
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-32b \\
        --shape train_4k --mesh single --force
    PYTHONPATH=src python -m repro_torch.launch.dryrun --list

Results are written incrementally to
results/dryrun_torch/<arch>__<shape>__<mesh>.json, so an interrupted
sweep resumes where it stopped.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path
from typing import Any, Dict, Optional

from repro_torch.configs.registry import ARCHS, get_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch import hw
from repro_torch.launch import roofline as rf
from repro_torch.launch import sharding as sh
from repro_torch.launch import steps
from repro_torch.launch.mesh import (MULTI_POD_AXES, MULTI_POD_SHAPE,
                                     SINGLE_POD_AXES, SINGLE_POD_SHAPE,
                                     make_abstract_mesh)

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"

MESHES = {"single": (SINGLE_POD_SHAPE, SINGLE_POD_AXES),
          "multi": (MULTI_POD_SHAPE, MULTI_POD_AXES)}


# Baseline settings per shape kind (the reference's):
#   * train: sequence-parallel residual boundaries (act_seq -> model) +
#     4-way gradient accumulation.
#   * prefill/decode: default rules (no remat-saved activations).
def baseline_settings(kind: str) -> Dict[str, Any]:
    if kind == "train":
        return {
            "rules": dataclasses.replace(sh.DEFAULT_RULES,
                                         act_seq=("model",)),
            "microbatches": 4,
        }
    return {"rules": sh.DEFAULT_RULES, "microbatches": 1}


def make_mesh(mesh_name: str):
    """The abstract production mesh ``mesh_name`` ("single" / "multi")."""
    return make_abstract_mesh(*MESHES[mesh_name])


def _pattern_len(cfg) -> int:
    if cfg.is_rwkv or not cfg.block_pattern:
        return 1
    return len(cfg.block_pattern)


def _affine_fit(cfg, shape) -> bool:
    """Whether the cell is counted by the 1-/2-block fit: RWKV6's WKV
    chunk loop over a full sequence (the module docstring)."""
    return cfg.is_rwkv and shape.kind != "decode"


def _count(cfg, shape, mesh, rules, mb) -> Dict[str, Any]:
    """Rank 0's counted step, as plain numbers (JSON-ready)."""
    lowered = steps.build_cell(cfg, shape, mesh, rules=rules,
                               microbatches=mb).lower()
    mem = lowered.memory_analysis()
    return {"flops": lowered.flops, "bytes": lowered.bytes,
            "flops_by_dtype": lowered.flops_by_dtype,
            "kernel_flops": lowered.kernel_flops,
            "kernel_bytes": lowered.kernel_bytes,
            "kernel_launches": {
                k: {"x".join(map(str, key)): n for key, n in v.items()}
                for k, v in lowered.launches.items()},
            "collectives": lowered.collective_summary(),
            "memory": dataclasses.asdict(mem)}


def _affine(v1: float, v2: float, n1: int, n2: int, n: int) -> float:
    """Fit v = a + b*n through (n1,v1),(n2,v2); evaluate at n."""
    b = (v2 - v1) / (n2 - n1)
    return v1 + b * (n - n1)


def _fit(a, b, n: int):
    """Every number of two counts (1 and 2 blocks), fitted to ``n``
    blocks; integers stay integers, a key missing on one side is 0."""
    if isinstance(a, dict) or isinstance(b, dict):
        a, b = a or {}, b or {}
        return {k: _fit(a.get(k, 0), b.get(k, 0), n)
                for k in sorted(set(a) | set(b))}
    v = _affine(a, b, 1, 2, n)
    return round(v) if isinstance(a, int) and isinstance(b, int) else v


def run_cell(arch: str, shape_name: str, mesh_name: str,
             rules: Optional[sh.AxisRules] = None,
             verbose: bool = True,
             cfg_overrides: Optional[Dict[str, Any]] = None,
             microbatches: Optional[int] = None, *,
             cfg=None, shape=None, mesh=None) -> Dict[str, Any]:
    """Count one cell for rank 0; return the full analysis record.
    ``cfg`` / ``shape`` / ``mesh`` stand in for the named configuration,
    shape and production mesh (a SMOKE width, a cut shape, a small
    abstract mesh)."""
    cfg = cfg if cfg is not None else get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    shape = shape if shape is not None else SHAPES[shape_name]
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "kind": shape.kind,
    }
    ok, why = steps.cell_is_supported(cfg, shape)
    if not ok:
        rec.update(status="skipped", reason=why)
        return rec

    mesh = mesh if mesh is not None else make_mesh(mesh_name)
    n_chips = 1
    for s in mesh.shape:
        n_chips *= int(s)
    base = baseline_settings(shape.kind)
    rules = rules or base["rules"]
    mb = microbatches if microbatches else base["microbatches"]
    mb = mb if shape.kind == "train" else 1
    t0 = time.perf_counter()
    try:
        if _affine_fit(cfg, shape):
            mode = "1/2-block affine fit on meta"
            p = _pattern_len(cfg)
            tail = cfg.num_layers % p
            m = _fit(*(_count(dataclasses.replace(
                cfg, num_layers=nb * p + tail), shape, mesh, rules, mb)
                for nb in (1, 2)), cfg.num_layers // p)
        else:
            mode = "full-depth count on meta"
            m = _count(cfg, shape, mesh, rules, mb)
    except Exception as e:  # a failure here is a bug in our sharding
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
        return rec
    wall = time.perf_counter() - t0

    csum = m["collectives"]
    mflops = rf.model_flops(cfg, shape)
    roof = rf.roofline({"flops": m["flops"], "bytes accessed": m["bytes"],
                        "flops by dtype": m["flops_by_dtype"]},
                       csum, n_chips, mflops)
    mem = m["memory"]
    peak_bytes = mem["peak_bytes"]
    rec.update(
        status="ok",
        n_chips=n_chips,
        analysis_mode=mode,
        timings={"count_s": round(wall, 2)},
        memory={
            "argument_bytes": mem["argument_size_in_bytes"],
            "output_bytes": mem["output_size_in_bytes"],
            "temp_bytes": mem["temp_size_in_bytes"],
            "alias_bytes": mem["alias_size_in_bytes"],
            "peak_bytes_per_device": peak_bytes,
            "peak_gib_per_device": round(peak_bytes / 2**30, 3),
            "fits_hbm_80gib": bool(peak_bytes < hw.HBM_PER_CHIP),
        },
        cost={"flops_per_chip": m["flops"], "bytes_per_chip": m["bytes"],
              "flops_by_dtype_per_chip": m["flops_by_dtype"],
              "kernel_flops": m["kernel_flops"],
              "kernel_bytes": m["kernel_bytes"],
              "kernel_launches": m["kernel_launches"]},
        collectives=csum,
        roofline=roof,
        params_total=cfg.param_count(),
        params_active=cfg.active_param_count(),
    )
    if verbose:
        print(f"  {arch} x {shape_name} x {mesh_name}: "
              f"{rec['memory']['peak_gib_per_device']} GiB/dev, "
              f"dominant={roof['dominant']}, "
              f"roofline_frac={roof['roofline_fraction']:.3f}, "
              f"useful={roof['useful_ratio']:.2f}, "
              f"count={wall:.0f}s ({mode})", flush=True)
    return rec


def cell_path(arch: str, shape: str, mesh: str) -> Path:
    safe = arch.replace(".", "_")
    return RESULTS / f"{safe}__{shape}__{mesh}.json"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default="all",
                    help="architecture id or 'all'")
    ap.add_argument("--shape", default="all", help="shape name or 'all'")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--force", action="store_true",
                    help="recompute cells that already have results")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    global RESULTS
    if args.out:
        RESULTS = Path(args.out)

    archs = list(ARCHS) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    if args.list:
        for a in archs:
            for s in shapes:
                ok, why = steps.cell_is_supported(get_config(a), SHAPES[s])
                print(a, s, "OK" if ok else f"SKIP ({why})")
        return
    RESULTS.mkdir(parents=True, exist_ok=True)

    failures = []
    for a in archs:
        for s in shapes:
            for m in meshes:
                p = cell_path(a, s, m)
                if p.exists() and not args.force:
                    rec = json.loads(p.read_text())
                    print(f"  [cached] {a} x {s} x {m}: {rec['status']}")
                    if rec["status"] == "error":
                        failures.append((a, s, m))
                    continue
                rec = run_cell(a, s, m)
                p.write_text(json.dumps(rec, indent=1))
                if rec["status"] == "error":
                    failures.append((a, s, m))
                    print(f"  ERROR {a} x {s} x {m}: {rec['error']}",
                          flush=True)

    print(f"\ndone; {len(failures)} failures")
    for f in failures:
        print("  FAILED:", *f)
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
