"""``tick.draw_kernel_frac``'s reader: nothing from a port without its
spans or without the draw kernel, the counted kernel ticks over the
``tick.draw`` spans from the port's snapshot, and 0 where no tick's draws
went through the kernel.  A port without the draw kernel (the parent's)
is one whose ``repro_torch.kernels.prng`` does not import."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench.harness import cell as cell_mod  # noqa: E402

METRIC = "tick.draw_kernel_frac"


def _reader():
    return cell_mod.metric_readers([{"name": METRIC}])[METRIC]


def test_reads_nothing_without_the_program_spans(monkeypatch):
    from repro_torch.core import instrument
    monkeypatch.delattr(instrument, "snapshot")
    assert _reader().read({"job_seconds": [1.0]}) is None


@pytest.mark.parametrize("counts,spans,want", [
    ({"draw.kernel_ticks": 8}, {"tick.draw": {"count": 8, "seconds": 0.1}},
     1.0),
    ({"draw.kernel_ticks": 3}, {"tick.draw": {"count": 12, "seconds": 0.1}},
     0.25),
    # the parent's port: spans, no kernel counter, no draw kernel
    ({"h2d_bytes": 10}, {"tick.draw": {"count": 8, "seconds": 0.1}}, None),
    # no solve tick in the window
    ({"draw.kernel_ticks": 0}, {}, None),
])
def test_reads_kernel_ticks_over_draw_spans(counts, spans, want,
                                            monkeypatch):
    from repro_torch.core import instrument
    if "draw.kernel_ticks" not in counts:
        _without_the_draw_kernel(monkeypatch)
    snap = {"spans": spans, "device_ms": {}, "counts": counts}
    monkeypatch.setattr(instrument, "snapshot", lambda: snap)
    assert _reader().read({"job_seconds": [1.0]}) == want


def _without_the_draw_kernel(monkeypatch):
    """The parent's port: ``repro_torch.kernels.prng`` does not import."""
    monkeypatch.setitem(sys.modules, "repro_torch.kernels.prng", None)


@pytest.mark.parametrize("counts", [{"h2d_bytes": 10}, {}])
def test_reads_zero_where_no_draw_went_through_the_kernel(counts,
                                                          monkeypatch):
    from repro_torch.core import instrument
    snap = {"spans": {"tick.draw": {"count": 8, "seconds": 0.1}},
            "device_ms": {}, "counts": counts}
    monkeypatch.setattr(instrument, "snapshot", lambda: snap)
    assert _reader().read({"job_seconds": [1.0]}) == 0.0


def test_reads_nothing_from_a_port_without_the_draw_kernel(monkeypatch):
    from repro_torch.core import instrument
    _without_the_draw_kernel(monkeypatch)
    snap = {"spans": {"tick.draw": {"count": 8, "seconds": 0.1}},
            "device_ms": {}, "counts": {"draw.kernel_ticks": 8}}
    monkeypatch.setattr(instrument, "snapshot", lambda: snap)
    assert _reader().read({"job_seconds": [1.0]}) is None
