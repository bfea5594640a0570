"""``sdca_block.reg_w_frac``: the window's ``sdca_block`` launches whose
stepping warp kept w in registers (the NC of ``<loss, NC>`` in the device
name non-zero) over all its ``sdca_block`` launches, on both routes, read
from fake trace summaries with the profiler's raw kernel names; nothing
without a trace or a launch; and its ``per_layer`` entry."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench.harness import cell as cell_mod  # noqa: E402

METRIC = "sdca_block.reg_w_frac"
ARGS = ("(float const*, float const*, float const*, float const*, "
        "float const*, int const*, float const*, float*, float*, int, int, "
        "int, int, int, long long, float const*, float, int)")
SHARED_16 = f"void (anonymous namespace)::sdca_block_kernel<1, 16>{ARGS}"
GLOBAL_16 = f"void (anonymous namespace)::sdca_block_kernel_gmem_leaf<1, 16>{ARGS}"
SHARED_0 = f"void (anonymous namespace)::sdca_block_kernel<3, 0>{ARGS}"
GLOBAL_0 = f"void (anonymous namespace)::sdca_block_kernel_gmem_leaf<1, 0>{ARGS}"
SHARED_8 = f"void (anonymous namespace)::sdca_block_kernel<0, 8>{ARGS}"
GEMV = "void gemv2T_kernel_val<int, int, float, float, float, float, 128, 16>"


def _reader():
    return cell_mod.metric_readers([{"name": METRIC}])[METRIC]


def _trace(kernels):
    return {"window_s": 1.0, "busy_s": 0.9, "kernels": kernels}


@pytest.mark.parametrize("kernels,want", [
    ({SHARED_16: [64, 7.4]}, 1.0),
    ({GLOBAL_16: [8, 0.94], GEMV: [8, 0.01]}, 1.0),
    ({SHARED_0: [12, 0.8]}, 0.0),
    ({GLOBAL_0: [8, 0.94]}, 0.0),
    # a mixed window: 6 + 2 of 6 + 2 + 8 + 4 launches
    ({SHARED_16: [6, 0.7], GLOBAL_16: [2, 0.2], SHARED_0: [8, 0.5],
      GLOBAL_0: [4, 0.4], GEMV: [3, 0.01]}, 0.4),
    ({SHARED_8: [3, 0.1], SHARED_0: [1, 0.1]}, 0.75),
], ids=["shared-16", "global-16", "shared-0", "global-0", "mixed", "nc-8"])
def test_reads_register_w_launches_over_launches(kernels, want):
    assert _reader().read({"trace": _trace(kernels)}) == pytest.approx(want)


@pytest.mark.parametrize("trace", [
    None,                                          # no trace: a CPU run
    _trace({GEMV: [3, 0.01]}),                     # no launch in the window
], ids=["no-trace", "no-launch"])
def test_reads_nothing_without_a_launch(trace):
    assert _reader().read({"trace": trace}) is None


def test_per_layer_entry():
    entry = next(m for m in cell_mod.benchmark()["per_layer"]
                 if m["name"] == METRIC)
    assert entry == {"name": METRIC, "unit": "frac", "better": "higher",
                     "source": "device_trace",
                     "layer": "kernels/sdca csrc/sdca_block.cu",
                     "moves": "solve_s"}
