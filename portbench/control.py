"""The readings that the correctness limits are set from, on the card.

    python3 portbench/control.py --workload <cell> --seeds 1 2 ... \
        --control-seeds 1 2 3 --out <file.jsonl>

For each seed of ``--seeds``, in one process: the cell's inputs from the
seed, its job built as a run builds it, one job through the timed path
(the window's own call, job index 0), and the comparison with the
float64 reference -- the program's readings, whose largest is a limit's
lower reading.  For each seed of ``--control-seeds``: the control, the
same reference computed in bfloat16 (the precision below the float32
that the configurations state) in the program's place, compared with the
float64 reference alike -- whose smallest reading is a limit's upper
one.  One JSON line per seed and kind goes to ``--out``; the benchmark's
own runs never run this.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def control_members(X, y, spec, members):
    """The control's members: the reference in bfloat16 on the member
    specs (lambda, key, steps) that the job has to return."""
    import torch
    from portbench.reference import sdca as ref_sdca
    return ref_sdca.tree_solve(X, y, members=members, **spec,
                               dtype=torch.bfloat16)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    from portbench.harness import cell as cell_mod
    from portbench.harness import check, data, execute
    from portbench.reference import sdca as ref_sdca

    cell = cell_mod.load_cell(args.workload)
    config, traffic = cell.config, cell.traffic
    job_mod = cell_mod.job_module(traffic["job"])
    dev = torch.device("cuda")
    out = open(args.out, "a")
    for seed in sorted(set(args.seeds) | set(args.control_seeds)):
        X, y = data.make(config, seed, dev)
        job = job_mod.Job(config, traffic, X, y, device=dev, backend="cuda",
                          spans=execute.Spans())
        got = job.members(job.run(0, seed, None))
        expected = job.expected(0, seed)
        spec = job.reference_spec()
        del job
        gc.collect()
        t0 = time.perf_counter()
        want = ref_sdca.tree_solve(X, y, members=expected, **spec)
        torch.cuda.synchronize()
        rec = {"cell": cell.name, "seed": seed,
               "ref_s": time.perf_counter() - t0}
        if seed in args.seeds:
            rec_p = dict(rec, kind="program", **check.readings(got, want))
            print(json.dumps(rec_p), file=out, flush=True)
            print(json.dumps(rec_p), flush=True)
        if seed in args.control_seeds:
            t0 = time.perf_counter()
            ctl = control_members(X, y, spec, expected)
            torch.cuda.synchronize()
            rec_c = dict(rec, kind="control", ctl_s=time.perf_counter() - t0,
                         **check.readings(ctl, want))
            print(json.dumps(rec_c), file=out, flush=True)
            print(json.dumps(rec_c), flush=True)
        del X, y, got, want
        gc.collect()
        torch.cuda.empty_cache()
    out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
