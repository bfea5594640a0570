"""Reading a ``torch.profiler`` trace of the window.

The device's busy time is the union of its activity intervals (kernels,
copies, sets) inside the window's own span (``portbench.window``, a
``record_function`` of the harness, on the clock the device intervals are
converted to).  Kernel time is summed by name.  Each idle gap of the device
is labelled by what the host was doing: the innermost span of the harness
(``portbench.*``) around it and the host operation that overlaps it most.
"""
from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

WINDOW = "portbench.window"
SPAN_PREFIX = "portbench."
TOP = 10


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def summarize(prof) -> Dict:
    """``window_s``, ``busy_s``, ``kernels`` ({name: [count, seconds]}),
    ``device_ops`` and ``idle_gaps`` (the longest, [[name, seconds]]) of
    a finished ``torch.profiler.profile``."""
    t0 = time.perf_counter()
    events = prof.profiler.kineto_results.events()
    t_events = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    dev: List[Tuple[int, int, str]] = []
    spans: List[Tuple[int, int, str]] = []
    ops: List[Tuple[int, int, str]] = []
    window = None
    for e in events:
        s = e.start_ns()
        t = s + e.duration_ns()
        name = e.name()
        if e.device_type() == cuda:
            # the device timeline repeats the host's annotations: not work
            if not (name.startswith(SPAN_PREFIX) or e.is_user_annotation()):
                dev.append((s, t, name))
        elif name == WINDOW:
            window = (s, t)
        elif name.startswith(SPAN_PREFIX):
            spans.append((s, t, name))
        else:
            ops.append((s, t, name))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW!r} span")
    w0, w1 = window
    clipped = [(max(s, w0), min(t, w1), n) for s, t, n in dev
               if t > w0 and s < w1]
    busy = _union([(s, t) for s, t, _ in clipped])
    kernels: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    for s, t, n in clipped:
        kernels[n][0] += 1
        kernels[n][1] += (t - s) * 1e-9
    gaps, prev = [], w0
    for s, t in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, t)
    if w1 > prev:
        gaps.append((prev, w1))
    gaps.sort(key=lambda g: g[0] - g[1])
    ops.sort()
    starts = [o[0] for o in ops]
    longest = max((t - s for s, t, _ in ops), default=0)
    top_ops = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:TOP]
    return {
        "events": len(events), "events_s": t_events,
        "window_s": (w1 - w0) * 1e-9,
        "busy_s": sum(t - s for s, t in busy) * 1e-9,
        "kernels": {k: list(v) for k, v in kernels.items()},
        "device_ops": [[k[:160], v[1]] for k, v in top_ops],
        "idle_gaps": [[_label(g, spans, ops, starts, longest),
                       (g[1] - g[0]) * 1e-9] for g in gaps[:TOP]],
    }


def _label(gap, spans, ops, starts, longest) -> str:
    g0, g1 = gap
    inner = [s for s in spans if s[0] <= g0 < s[1]]
    span = min(inner, key=lambda s: s[1] - s[0])[2] if inner else "host"
    best, best_overlap = "", 0
    # the host operations that may overlap the gap: those that start
    # before it ends and no longer before it begins than the longest lasts
    lo = bisect.bisect_left(starts, g0 - longest)
    for s, t, n in ops[lo:bisect.bisect_left(starts, g1)]:
        overlap = min(t, g1) - max(s, g0)
        if overlap > best_overlap:
            best, best_overlap = n, overlap
    return f"{span}: {best or 'no host op'}"[:160]


def kernel_time(summary: Dict, fragment: str) -> Tuple[int, float]:
    """(launches, seconds) of the kernels whose name holds ``fragment``."""
    n, sec = 0, 0.0
    for name, (count, seconds) in summary["kernels"].items():
        if fragment in name:
            n += count
            sec += seconds
    return n, sec


def idle_ms_per_launch(summary: Dict) -> float | None:
    """The device's idle time in the traced window (its wall time less the
    union of device activity) per ``sdca_block`` launch, in ms."""
    n, _ = kernel_time(summary, "sdca_block_kernel")
    return (summary["window_s"] - summary["busy_s"]) / n * 1e3 if n \
        else None
