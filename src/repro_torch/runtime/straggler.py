"""Straggler mitigation -- the paper's own mechanism, operationalized.

The paper's core observation (§6): when a link/worker is slow, do MORE
local work per sync (larger H) instead of letting the barrier idle the
fleet. TreeSync exposes per-level sync periods; this module turns observed
per-step timing into updated periods via the paper's eq. (12), plus a
bounded-skip barrier policy for transient stragglers.

The observation side is an interface (``StepTimer.observe``) fed by the
caller; ``StragglerPolicy`` feeds it simulated per-leaf delays.  The
decision side (re-optimizing H, skip decisions) is pure host code on
``numpy.random.default_rng([seed, runs])``, the JAX package's
``runtime/straggler.py`` decision for decision (this package keeps its own
copy).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Deque, Optional

import numpy as np

from repro_torch.core.delay import StragglerModel, optimal_h


@dataclasses.dataclass
class StepTimer:
    """Online robust timing stats per sync level (median + MAD)."""
    window: int = 64

    def __post_init__(self):
        # deque(maxlen=...) evicts the oldest sample in O(1); the previous
        # list.pop(0) was O(window) per observation
        self.samples: Deque[float] = collections.deque(maxlen=self.window)

    def observe(self, seconds: float) -> None:
        self.samples.append(seconds)

    @property
    def median(self) -> float:
        return float(np.median(self.samples)) if self.samples else 0.0

    @property
    def mad(self) -> float:
        if not self.samples:
            return 0.0
        m = self.median
        return float(np.median(np.abs(np.array(self.samples) - m)))

    def is_straggling(self, seconds: float, k: float = 5.0,
                      rel_floor: float = 0.2) -> bool:
        """Is this step an outlier vs the recent window? Requires BOTH a
        k-MAD exceedance and a minimum relative slowdown (a 1% blip on a
        perfectly steady cluster is not a straggler)."""
        if len(self.samples) < 8:
            return False
        return seconds > max(self.median + k * self.mad,
                             self.median * (1.0 + rel_floor))


@dataclasses.dataclass
class AdaptiveSchedule:
    """Re-optimize the paper's H when the observed delay drifts.

    C, delta: the convergence-bound constants of eq. (11)-(12);
    t_total: the planning horizon; re-planning uses the *measured*
    t_lp (local step) and t_delay (sync barrier) medians.

    The suggestion is live: ``Session.run(straggler=...)``
    applies it to the next chunk through the engine's runtime step-mask
    operand (H is an executor INPUT, not a compile constant), so an
    adaptive session replans with zero retraces.
    """
    C: float = 0.5
    delta: float = 1e-3
    t_total: float = 3600.0
    K: int = 2
    h_max: int = 4096
    hysteresis: float = 1.3   # only change H when >30% off current optimum

    current_h: int = 1

    def replan(self, t_lp: float, t_delay: float, t_cp: float = 0.0) -> int:
        h, _ = optimal_h(C=self.C, K=self.K, delta=self.delta,
                         t_total=self.t_total, t_lp=max(t_lp, 1e-9),
                         t_delay=max(t_delay, 0.0), t_cp=t_cp,
                         h_max=self.h_max)
        if (max(h, self.current_h) / max(min(h, self.current_h), 1)
                >= self.hysteresis):
            self.current_h = h
        return self.current_h


@dataclasses.dataclass
class BoundedSkip:
    """Transient-straggler policy: a sync round may be skipped (local work
    continues) at most `max_consecutive` times, then the barrier is forced.
    This bounds replica divergence: with period H and at most s skips, any
    two replicas are never more than H*(s+1) local steps apart -- the same
    bounded-staleness object the paper's tree analysis tolerates (each
    subtree runs more local rounds before the parent round closes)."""
    max_consecutive: int = 2
    skipped: int = 0

    def decide(self, barrier_would_stall: bool) -> bool:
        """True => skip the sync this round."""
        if barrier_would_stall and self.skipped < self.max_consecutive:
            self.skipped += 1
            return True
        self.skipped = 0
        return False


@dataclasses.dataclass
class StragglerStep:
    """One chunk's straggler decisions and simulated timing."""
    mask: np.ndarray        # (n,) float32 in {0,1}: 1 = leaf participates
    dt_async: float         # simulated round time when stragglers are dropped
    dt_sync: float          # simulated round time of the full barrier
    delays: np.ndarray      # (n,) the sampled per-leaf sync-path delays
    h_suggest: Optional[int]  # AdaptiveSchedule's replanned H (None if unset)


@dataclasses.dataclass
class StragglerPolicy:
    """Per-chunk straggler decisions for ``Session.run``.

    Each root-round chunk: sample per-leaf sync-path delays from ``model``
    (around the topology's nominal link delays), classify stragglers
    against the fleet :class:`StepTimer` window (median + MAD), let each
    leaf's :class:`BoundedSkip` decide whether the barrier drops it (at
    most ``max_consecutive`` consecutive skips, then a forced barrier), and
    account the simulated wall-clock both ways:

      * ``dt_sync``  = compute + max over ALL leaves' delays (the paper's
        synchronous barrier, throttled by the slowest link), and
      * ``dt_async`` = compute + max over PARTICIPATING leaves only (the
        straggler's uplink no longer gates the round).

    The emitted per-leaf mask covers the whole chunk -- the chunk boundary
    is the staleness point, so a dropped leaf keeps solving on its stale
    snapshots and re-joins with a bounded-staleness delta (see
    ``docs/architecture.md``).  The final chunk always runs a full barrier
    (``force_final_barrier``) so the run ends with every replica agreeing
    with ``w = A alpha``.  ``adaptive`` (optional) is re-fed the observed
    delay medians every chunk; its replanned H is reported in the step
    info AND applied by the session: ``Session.run`` feeds ``h_suggest``
    into the next chunk's runtime step-mask operand (clamped to the
    compiled H capacity -- compile with ``Schedule(h_cap=...)`` for
    headroom), so replanning never retraces."""
    model: StragglerModel = dataclasses.field(default_factory=StragglerModel)
    max_consecutive: int = 2
    seed: int = 0
    warmup: int = 1          # chunks before skip decisions kick in
    k_mad: float = 5.0
    rel_floor: float = 0.5
    force_final_barrier: bool = True
    adaptive: Optional[AdaptiveSchedule] = None

    def bind(self, base_delays, t_compute: float, t_lp: float = 0.0) -> None:
        """(Re)start per-run state: nominal per-leaf sync-path delays and
        the compute-only per-chunk time.  Called by ``Session.run``.

        Re-binding the same policy (a warm-restarted continuation run)
        advances the delay stream instead of replaying it: the first run
        is reproducible from ``seed``, and split runs sample a fresh
        continuation of the simulated network process."""
        self._base = np.asarray(base_delays, dtype=np.float64)
        self._t_compute = float(t_compute)
        self._t_lp = float(t_lp)
        self._runs = getattr(self, "_runs", -1) + 1
        self._rng = np.random.default_rng([self.seed, self._runs])
        self._timer = StepTimer()
        self._skips = [BoundedSkip(max_consecutive=self.max_consecutive)
                       for _ in range(len(self._base))]
        self._chunk = 0
        self.last_h_suggest: Optional[int] = None

    def retime(self, t_compute: float) -> None:
        """Update the per-chunk compute time mid-run.  ``Session.run``
        calls this when adaptive replanning changes the executed H, so
        the simulated async/sync clocks charge the work that actually
        runs, not the H the run started with."""
        self._t_compute = float(t_compute)

    def step(self, final: bool = False) -> StragglerStep:
        """Decide one chunk; ``final`` forces the closing full barrier."""
        n = len(self._base)
        d = self.model.sample(self._base, self._rng)
        warm = self._chunk >= self.warmup
        stall = np.array([
            warm and self._timer.is_straggling(
                float(d[i]), k=self.k_mad, rel_floor=self.rel_floor)
            for i in range(n)
        ])
        if final and self.force_final_barrier:
            for s in self._skips:
                s.skipped = 0
            skip = np.zeros(n, dtype=bool)
        else:
            skip = np.array([self._skips[i].decide(bool(stall[i]))
                             for i in range(n)])
        for i in range(n):
            self._timer.observe(float(d[i]))
        self._chunk += 1
        mask = (~skip).astype(np.float32)
        dt_sync = self._t_compute + float(d.max(initial=0.0))
        part = d[~skip]
        dt_async = self._t_compute + float(part.max(initial=0.0))
        h = None
        if self.adaptive is not None:
            h = self.adaptive.replan(
                t_lp=max(self._t_lp, 1e-9), t_delay=float(np.median(d)))
            self.last_h_suggest = h
        return StragglerStep(mask=mask, dt_async=dt_async, dt_sync=dt_sync,
                             delays=d, h_suggest=h)
