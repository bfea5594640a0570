"""Run one cell of the port's benchmark once and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds the port (``src/repro_torch``).
The cell is an entry of ``BENCHMARK.json``; its files are found by name
(``portbench/harness/cell.py``).  The last line of standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and last ``check``: each
compared number beside its limit); the compared numbers are also the last
lines of standard error.  ``--trace 0`` reports the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics, read from a
``torch.profiler`` trace of the window.

The run needs an NVIDIA GPU and exits with code 2, printing no result,
without one, or where the checkout lacks the port.  ``--debug`` runs the
cell at the harness's debug size on the CPU with the port's plain
versions (rehearsals and tests); on a machine with a card it is refused,
and its line says ``"platform": "cpu"``.  Build and kernel caches stay in
fixed directories inside the checkout (``build/``).
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _finite(obj):
    """The result with every non-finite float as +-1e300 (strict JSON)."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return 1e300 if obj > 0 or math.isnan(obj) else -1e300
    if isinstance(obj, dict):
        return {k: _finite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_finite(v) for v in obj]
    return obj


def _fail(msg: str) -> int:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    return 2


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--debug", action="store_true",
                    help="the debug size on the CPU (refused with a card)")
    args = ap.parse_args(argv)

    if not (ROOT / "src" / "repro_torch" / "__init__.py").exists():
        return _fail(f"no port at {ROOT / 'src' / 'repro_torch'}")
    build = ROOT / "build" / "portbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    import torch
    if args.debug:
        if torch.cuda.is_available():
            return _fail("--debug runs at the debug size on the CPU only")
        device = "cpu"
    else:
        if not torch.cuda.is_available():
            return _fail("no CUDA device: the benchmark measures the card")
        from portbench.harness import cell as cell_mod
        chips = next(w["chips"] for w in cell_mod.benchmark()["workloads"]
                     if w["name"] == args.workload)
        if torch.cuda.device_count() < chips:
            return _fail(f"the cell needs {chips} cards, the machine has "
                         f"{torch.cuda.device_count()}")
        device = "cuda"
    from portbench.harness import execute as ex
    import repro_torch
    if Path(repro_torch.__file__).resolve().parents[1] != \
            (ROOT / "src").resolve():
        return _fail(f"repro_torch imported from {repro_torch.__file__}, "
                     f"not from this checkout")
    result = ex.execute(args.workload, args.seed, args.seconds,
                        bool(args.trace), t_start=T_START, device=device,
                        debug=args.debug,
                        log=lambda s: print(s, file=sys.stderr, flush=True))
    found = ex.modules_found()
    if found:
        return _fail(f"the run loaded {found}: the benchmark measures the "
                     f"port alone")
    if device == "cuda":
        import subprocess
        try:
            lim = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=20).stdout.strip()
        except (OSError, subprocess.SubprocessError) as e:
            lim = f"nvidia-smi: {e}"
        print(f"portbench: card {lim}", file=sys.stderr)
    lines = result.pop("_lines")
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(_finite(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
