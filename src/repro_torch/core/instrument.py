"""Instrumentation for solver runs: the simulated wall-clock of the tree's
delay model and the per-root-round history, as in the JAX package's
``core/instrument.py``.

* simulated wall-clock: ``TreeNode.solve_time`` (the generalization of
  paper eq. (9)) gives the per-root-round time;
* history: a list of ``{round, time, dual, primal, gap}`` dicts wrapped in
  :class:`SolveResult`, with array accessors;
* batched histories: the sweep layer (``api/sweep.py``) stores a config
  batch's series as ``(B, T)`` arrays -- :func:`stack_histories` /
  :func:`history_row` convert between that schema and the per-run dict
  lists (NaN-padded where members recorded fewer rounds);
* spans and counters of the solve path (:func:`span`, :func:`count`,
  :func:`snapshot`, :func:`reset`): on while a ``torch.profiler`` session
  records, off otherwise.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.tree import TreeNode

Tensor = torch.Tensor

HISTORY_FIELDS = ("round", "time", "dual", "primal", "gap")


@dataclasses.dataclass
class SolveResult:
    """A solver run: final iterates + per-root-round instrumentation.

    ``next_key`` is the root RNG chain state after the run (a CPU int64
    key), so a warm-restarted continuation reproduces one longer run;
    ``lam`` records the regularization the run used, so a warm restart
    under another lambda rebuilds ``w = X^T alpha / (lam m)``."""
    alpha: torch.Tensor
    w: torch.Tensor
    history: List[dict]
    next_key: Optional[torch.Tensor] = None
    lam: Optional[float] = None

    @property
    def times(self) -> np.ndarray:
        return np.array([h["time"] for h in self.history])

    @property
    def gaps(self) -> np.ndarray:
        return np.array([h["gap"] for h in self.history])

    @property
    def duals(self) -> np.ndarray:
        return np.array([h["dual"] for h in self.history])

    @property
    def primals(self) -> np.ndarray:
        return np.array([h["primal"] for h in self.history])

    def to_dict(self) -> dict:
        """JSON-serializable form (iterates as lists, history as-is)."""
        return {
            "alpha": self.alpha.detach().cpu().tolist(),
            "w": self.w.detach().cpu().tolist(),
            "history": [dict(h) for h in self.history],
            "next_key": (None if self.next_key is None
                         else self.next_key.cpu().tolist()),
            "lam": None if self.lam is None else float(self.lam),
        }


def per_round_time(tree: TreeNode) -> float:
    """Simulated wall-clock of ONE root round (children in parallel,
    synchronous barrier; paper eq. (9) when the tree is a star)."""
    return tree.solve_time() / max(tree.rounds, 1)


def round_times(tree: TreeNode) -> np.ndarray:
    """Times of rounds 0..T (round 0 is the start-of-run record)."""
    return np.arange(tree.rounds + 1) * per_round_time(tree)


def history_from_series(
    times: Sequence[float],
    duals: Sequence[float],
    primals: Sequence[float],
) -> List[dict]:
    """Assemble the history-dict list from aligned series."""
    out = []
    for t, (tm, dv, pv) in enumerate(zip(times, duals, primals,
                                         strict=True)):
        out.append({"round": t, "time": float(tm), "dual": float(dv),
                    "primal": float(pv), "gap": float(pv) - float(dv)})
    return out


def record_round(history: List[dict], t: int, time: float, dual: float,
                 primal: float) -> None:
    """Append one history entry (host floats; the gap is their float64
    difference)."""
    history.append({"round": t, "time": time, "dual": dual,
                    "primal": primal, "gap": primal - dual})


# ---------------------------------------------------------------------------
# batched-history schema (the sweep layer's (B, T) representation)
# ---------------------------------------------------------------------------
def stack_histories(histories: Sequence[List[dict]]) -> Dict[str, np.ndarray]:
    """Stack B per-run history dict-lists into ``{field: (B, T_max)}``
    float arrays (one per :data:`HISTORY_FIELDS`), NaN-padding members that
    recorded fewer rounds -- the ``api/sweep.py::RunSet`` history
    schema.  Extra per-entry keys (async instrumentation) are dropped."""
    B = len(histories)
    t_max = max((len(h) for h in histories), default=0)
    out = {f: np.full((B, t_max), np.nan) for f in HISTORY_FIELDS}
    for b, hist in enumerate(histories):
        for t, entry in enumerate(hist):
            for f in HISTORY_FIELDS:
                out[f][b, t] = float(entry[f])
    return out


def history_row(stacked: Dict[str, np.ndarray], b: int) -> List[dict]:
    """Reconstruct member ``b``'s history dict-list from a
    :func:`stack_histories` batch (NaN padding rows are dropped)."""
    out: List[dict] = []
    rounds = stacked["round"]
    for t in range(rounds.shape[1]):
        if not np.isfinite(rounds[b, t]):
            continue
        out.append({
            "round": int(rounds[b, t]),
            "time": float(stacked["time"][b, t]),
            "dual": float(stacked["dual"][b, t]),
            "primal": float(stacked["primal"][b, t]),
            "gap": float(stacked["gap"][b, t]),
        })
    return out


# ---------------------------------------------------------------------------
# spans and counters of the solve path
# ---------------------------------------------------------------------------
# Tracing is on while a torch.profiler session records and off otherwise:
# no flag, no environment variable.  Off, a span is one check and returns a
# shared null context, and a count returns at once.  On, a span enters
# ``torch.profiler.record_function("repro_torch.<name>")`` (the range lands
# in the profiler's trace beside the device's kernels) and adds its host
# time to a per-name aggregate.  Given a CUDA ``device`` whose current
# stream still has work queued when the span opens, it also records a pair
# of CUDA events around the span's work, resolved by ``snapshot()`` and
# never inside the traced code: that work then waits behind the queue
# while the host issues it, so the pair times the device and not the
# host's issue.  A span that opens on an idle stream records no pair (the
# stream would run each launch as the host issues it).  The aggregates
# keep whatever the profiled windows recorded until ``reset()``.
#
# Names (``Session.run``, the sweep's batched groups, ``core/engine/host.py``):
#   spans    key_plan, step_mask, record, tick.draw (with device events),
#            tick.solve, tick.sync -- flat phases: inside a run no span
#            encloses another; the ``run=<n>`` argument links them
#   counters h2d_bytes (host-built operands handed to the run's device),
#            host_syncs (blocking reads of the device),
#            draw.kernel_ticks (threefry_randint launches, counted at the
#            launch: one a solve tick whose draws went through the kernel)
SPAN_PREFIX = "repro_torch."

tracing = torch.autograd._profiler_enabled

_NULL = contextlib.nullcontext()
_spans: Dict[str, List[float]] = {}        # name -> [count, host seconds]
_device_ms: Dict[str, List[float]] = {}    # name -> [count, stream ms] of
#                                            spans opened on a busy stream
_pending: List[tuple] = []                 # (name, start, end) CUDA events
_counts: Dict[str, int] = {}
_attrs: Dict[str, int] = {}                # run, round of the spans now
_run = 0


class _Span:
    __slots__ = ("name", "rf", "stream", "start", "t0")

    def __init__(self, name: str, device, attrs: dict):
        self.name = name
        args = " ".join(f"{k}={v}" for k, v in {**_attrs, **attrs}.items())
        self.rf = torch.profiler.record_function(SPAN_PREFIX + name,
                                                 args or None)
        self.stream = None
        if device is not False and torch.device(device).type == "cuda":
            self.stream = torch.cuda.current_stream(device)
        self.start = None

    def __enter__(self):
        self.rf.__enter__()
        # Stream.query() does not block: True once the stream is idle
        if self.stream is not None and not self.stream.query():
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record(self.stream)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self.t0
        if self.start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(self.stream)
            _pending.append((self.name, self.start, end))
        agg = _spans.setdefault(self.name, [0, 0.0])
        agg[0] += 1
        agg[1] += dt * 1e-9
        self.rf.__exit__(*exc)
        return False


def span(name: str, *, device=False, **attrs):
    """A context manager timing one phase ``name`` while tracing is on (a
    shared null context otherwise).  ``device`` is the device the phase's
    work runs on: on a CUDA device whose current stream is busy when the
    span opens, the phase's work is also timed on that stream.  ``attrs``
    (``tick=``, ``depth=``) join the run's ``run`` and ``round`` in the
    profiler range's arguments."""
    if not tracing():
        return _NULL
    return _Span(name, device, attrs)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` while tracing is on."""
    if tracing():
        _counts[name] = _counts.get(name, 0) + int(n)


def count_h2d(src, t: Tensor) -> None:
    """Count ``t``'s bytes under ``h2d_bytes`` when ``t`` was made from
    host data ``src`` (an array, a list, or a tensor on another device):
    a tensor the caller already holds on ``t``'s device is no copy."""
    if tracing() and not (isinstance(src, Tensor) and src.device == t.device):
        _counts["h2d_bytes"] = _counts.get("h2d_bytes", 0) + t.nbytes


def begin_run() -> None:
    """A new run identifier (``run=<n>``) for the spans that follow: one
    ``Session.run`` or one batched sweep group."""
    global _run
    if tracing():
        _run += 1
        _attrs.clear()
        _attrs["run"] = _run


def at_round(t: int) -> None:
    """The root round (``round=<t>``) of the spans that follow."""
    if tracing():
        _attrs["round"] = int(t)


def snapshot() -> dict:
    """The aggregates so far: ``{"spans": {name: {"count", "seconds"}},
    "device_ms": {name: {"count", "ms"}}, "counts": {name: n}}``;
    ``device_ms`` counts only the spans that opened on a busy stream.  The
    CUDA events recorded since the last call are resolved here (each end
    event waited for), so call it after the traced work."""
    for name, start, end in _pending:
        end.synchronize()
        agg = _device_ms.setdefault(name, [0, 0.0])
        agg[0] += 1
        agg[1] += start.elapsed_time(end)
    _pending.clear()
    return {
        "spans": {k: {"count": c, "seconds": s}
                  for k, (c, s) in _spans.items()},
        "device_ms": {k: {"count": c, "ms": ms}
                      for k, (c, ms) in _device_ms.items()},
        "counts": dict(_counts),
    }


def reset() -> None:
    """Drop every aggregate and pending event pair."""
    for d in (_spans, _device_ms, _counts, _attrs):
        d.clear()
    _pending.clear()
