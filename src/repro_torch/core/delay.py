"""Communication-delay model and delay-aware tuning of local iterations H
(paper SS6, eq. (9)-(12)), per-level link models, the per-level
compression choice and the improvement-constant fit.

eq. (9):  t_total = (t_lp*H + t_delay + t_cp) * T
eq. (11): gap factor after T rounds = (1 - (1 - (1-delta)^H) * C/K)^T
eq. (12): minimize over H the bound with T = t_total/(t_lp*H + t_delay + t_cp)

All bound evaluations are done in log-space for numerical stability
(H up to 1e6 and T up to 1e9 appear in the paper's sweeps).

Pure numpy, the JAX package's ``core/delay.py`` function for function
(this package keeps its own copy).  The bounded-skip straggler pair
(:func:`simulate_bounded_skip`, :func:`optimal_h_bounded_skip`) replays
``runtime/straggler.py``'s decision classes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import compression as comp_mod


# ---------------------------------------------------------------------------
# paper SS6: star-network bound as a function of H
# ---------------------------------------------------------------------------
def rounds_for_budget(t_total: float, H: float, t_lp: float, t_delay: float,
                      t_cp: float) -> float:
    """eq. (10): T = t_total / (t_lp H + t_delay + t_cp)."""
    return t_total / (t_lp * H + t_delay + t_cp)


def _check_improvement_constant(C: float, K: int) -> None:
    """eq. (11)'s per-round factor g(H) = 1 - (1 - (1-delta)^H) C/K is a
    contraction only for 0 < C <= K; outside that range the "factor" goes
    negative for large H and the log-space bound silently clamps it, so the
    planners reject bad constants up front instead of optimizing garbage."""
    if not 0 < C <= K:
        raise ValueError(
            f"the improvement constant must satisfy 0 < C <= K so eq. (11)'s "
            f"per-round factor stays in (0, 1]; got C={C} with K={K}")


def _check_acceleration(acceleration: float) -> float:
    a = float(acceleration)
    if not 0.0 <= a <= 1.0:
        raise ValueError(
            f"acceleration must be in [0, 1] (0 = plain SDCA, 1 = full "
            f"Nesterov rate); got {acceleration}")
    return a


def per_round_factor(H: float, C: float, K: int, delta: float,
                     acceleration: float = 0.0) -> float:
    """eq. (11) base: g(H) = 1 - (1 - (1-delta)^H) * C/K.

    ``acceleration`` models the accelerated primal-dual flavor (Ma et al.,
    arXiv 1711.05305): momentum on the server combine improves the
    dependence on the per-round progress s = (1-(1-delta)^H) C/K toward
    its square root, so g = 1 - s^(1 - acceleration/2).  ``acceleration=0``
    recovers the plain rate exactly; ``acceleration=1`` is the full
    Nesterov exponent 1/2."""
    s = (1.0 - (1.0 - delta) ** H) * C / K
    a = _check_acceleration(acceleration)
    if a > 0.0 and s > 0.0:
        s = s ** (1.0 - 0.5 * a)
    return 1.0 - s


def log_bound(
    H: float, *, C: float, K: int, delta: float, t_total: float,
    t_lp: float, t_delay: float, t_cp: float, acceleration: float = 0.0,
) -> float:
    """log of eq. (12)'s objective: T(H) * log g(H). Lower is better (< 0)."""
    g = per_round_factor(H, C, K, delta, acceleration)
    T = rounds_for_budget(t_total, H, t_lp, t_delay, t_cp)
    # g in (0,1]; log(g) <= 0
    return T * math.log(max(g, 1e-300))


def optimal_h(
    *, C: float, K: int, delta: float, t_total: float, t_lp: float,
    t_delay: float, t_cp: float, h_min: int = 1, h_max: int = 10**7,
    acceleration: float = 0.0,
) -> Tuple[int, float]:
    """Integer minimizer of eq. (12) by coarse log-grid + local refinement.

    Returns (H*, log_bound(H*)).
    """
    _check_improvement_constant(C, K)
    _check_acceleration(acceleration)
    # coarse: log-spaced candidates
    grid = sorted(
        {int(h) for h in np.unique(np.round(
            np.logspace(math.log10(h_min), math.log10(h_max), 200)))}
    )
    vals = [
        log_bound(h, C=C, K=K, delta=delta, t_total=t_total, t_lp=t_lp,
                  t_delay=t_delay, t_cp=t_cp, acceleration=acceleration)
        for h in grid
    ]
    i = int(np.argmin(vals))
    lo = grid[max(i - 1, 0)]
    hi = grid[min(i + 1, len(grid) - 1)]
    # exact integer scan in the bracket (bracket widths are ~5% of H, cheap
    # up to ~1e6; subsample if enormous)
    if hi - lo > 200_000:
        cand: Iterable[int] = np.unique(
            np.round(np.linspace(lo, hi, 100_000)).astype(np.int64))
    else:
        cand = range(lo, hi + 1)
    best_h, best_v = grid[i], vals[i]
    for h in cand:
        v = log_bound(int(h), C=C, K=K, delta=delta, t_total=t_total,
                      t_lp=t_lp, t_delay=t_delay, t_cp=t_cp,
                      acceleration=acceleration)
        if v < best_v:
            best_h, best_v = int(h), v
    return best_h, best_v


def optimal_h_vs_delay(
    rs: Sequence[float], *, C: float, K: int, delta: float, t_total: float,
    t_lp: float, t_cp: float, h_max: int = 10**7,
) -> np.ndarray:
    """Fig. 4(b): optimal H for t_delay = r * t_lp over a sweep of r."""
    out = []
    for r in rs:
        h, _ = optimal_h(C=C, K=K, delta=delta, t_total=t_total, t_lp=t_lp,
                         t_delay=r * t_lp, t_cp=t_cp, h_max=h_max)
        out.append(h)
    return np.array(out)


# ---------------------------------------------------------------------------
# link models: used to instantiate the paper's delay model per sync level
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class LinkModel:
    """One network level: latency + inverse-bandwidth delay for a message."""
    name: str
    latency_s: float
    bw_bytes_per_s: float

    def delay(self, msg_bytes: float) -> float:
        return self.latency_s + msg_bytes / self.bw_bytes_per_s


def ring_allreduce_delay(link: LinkModel, msg_bytes: float, n: int) -> float:
    """Ring all-reduce cost over n participants: 2(n-1)/n of the bytes per
    link plus 2(n-1) latency hops."""
    if n <= 1:
        return 0.0
    return 2 * (n - 1) * link.latency_s + (
        2.0 * (n - 1) / n * msg_bytes / link.bw_bytes_per_s
    )


@dataclasses.dataclass(frozen=True)
class SyncLevel:
    """One level of a hierarchical (tree) synchronization schedule."""
    name: str
    group_size: int          # K at this level
    link: LinkModel
    msg_bytes: float         # size of the averaged state

    def round_delay(self, wire_ratio: float = 1.0) -> float:
        """Per-round collective cost; ``wire_ratio`` scales the *bytes* on the
        wire (delta compression), leaving the latency hops untouched."""
        return ring_allreduce_delay(
            self.link, self.msg_bytes * wire_ratio, self.group_size)


@dataclasses.dataclass(frozen=True)
class FixedLevel:
    """A sync level with an explicitly-given per-round delay (seconds), as
    carried by ``TreeNode.up_delay`` -- interchangeable with
    :class:`SyncLevel` wherever only ``group_size``/``round_delay`` are used
    (``plan_hierarchical_h``).

    ``latency_s`` is the part of ``delay_s`` that is pure latency (per-hop
    setup cost): compression shrinks only the bandwidth-proportional
    remainder, so ``round_delay(r) = latency_s + (delay_s - latency_s)*r``.
    The default (0) treats the whole delay as bandwidth-bound -- the most
    optimistic view of compression, matching ``TreeNode.up_delay`` which
    does not split the two."""
    name: str
    group_size: int
    delay_s: float
    latency_s: float = 0.0

    def round_delay(self, wire_ratio: float = 1.0) -> float:
        return self.latency_s + (self.delay_s - self.latency_s) * wire_ratio


def simulate_bounded_skip(
    base_delays,
    model: "StragglerModel",
    *,
    max_consecutive: int,
    rel_floor: float = 0.5,
    k_mad: float = 5.0,
    warmup: int = 1,
    n_rounds: int = 512,
    seed: int = 0,
) -> Tuple[float, float]:
    """Monte-carlo the bounded-skip barrier over sampled per-leaf delays.

    Replays the ACTUAL runtime decision machinery of
    ``runtime/straggler.py`` -- the fleet :class:`StepTimer` window
    (median + ``k_mad`` MAD, ``rel_floor`` relative slowdown, ``warmup``
    rounds before skips kick in) and one :class:`BoundedSkip` per leaf --
    over delays drawn from ``model`` around ``base_delays``, so the
    planner optimizes the same policy the session will execute.  Returns
    ``(mean per-round barrier delay -- the max over PARTICIPATING leaves
    --, mean participation fraction)``; ``max_consecutive=0`` never skips
    and reproduces the synchronous barrier (mean max over ALL leaves)."""
    # runtime decision classes; imported lazily (runtime.straggler imports
    # this module for its model/planner types)
    from repro_torch.runtime.straggler import BoundedSkip, StepTimer
    base = np.atleast_1d(np.asarray(base_delays, np.float64))
    n = base.size
    rng = np.random.default_rng(seed)
    timer = StepTimer()
    skips = [BoundedSkip(max_consecutive=max_consecutive)
             for _ in range(n)]
    delay_sum = 0.0
    part_sum = 0
    for r in range(int(n_rounds)):
        d = model.sample(base, rng)
        warm = r >= warmup
        skip = np.array([
            skips[i].decide(warm and timer.is_straggling(
                float(d[i]), k=k_mad, rel_floor=rel_floor))
            for i in range(n)
        ])
        for i in range(n):
            timer.observe(float(d[i]))
        part = ~skip
        if part.any():
            delay_sum += float(d[part].max())
        part_sum += int(part.sum())
    return delay_sum / n_rounds, part_sum / (n_rounds * n)


def optimal_h_bounded_skip(
    *,
    C: float,
    K: int,
    delta: float,
    t_total: float,
    t_lp: float,
    t_cp: float,
    base_delays,
    model: "StragglerModel",
    skip_max: int = 3,
    h_max: int = 10**6,
    rel_floor: float = 0.5,
    n_rounds: int = 512,
    seed: int = 0,
    acceleration: float = 0.0,
) -> dict:
    """The straggler-aware eq. (12): jointly optimize the local iteration
    count H and the ``runtime/straggler.py::BoundedSkip``
    threshold ``s``.

    For each candidate ``s in 0..skip_max`` the bounded-skip barrier is
    simulated over the observed/nominal per-leaf delays
    (:func:`simulate_bounded_skip`), which yields the *effective* per-round
    delay (the straggler's uplink no longer gates the round) and the mean
    participation fraction ``rho``; a dropped leaf contributes no work to
    the round, so eq. (11)'s improvement constant dilutes to ``C * rho``.
    Each ``s`` then gets its own eq.-(12) optimal H, and the (H, s) pair
    with the best log-bound wins.  Returns ``{H, skip, t_delay,
    participation, log_bound}``."""
    _check_improvement_constant(C, K)
    if skip_max < 0:
        raise ValueError(f"skip_max must be >= 0, got {skip_max}")
    best: Optional[dict] = None
    for s in range(int(skip_max) + 1):
        t_delay, rho = simulate_bounded_skip(
            base_delays, model, max_consecutive=s, rel_floor=rel_floor,
            n_rounds=n_rounds, seed=seed)
        c_eff = max(C * rho, 1e-12)
        h, v = optimal_h(C=c_eff, K=K, delta=delta, t_total=t_total,
                         t_lp=t_lp, t_delay=t_delay, t_cp=t_cp, h_max=h_max,
                         acceleration=acceleration)
        if best is None or v < best["log_bound"]:
            best = {"H": h, "skip": s, "t_delay": t_delay,
                    "participation": rho, "log_bound": v}
    return best


def _compression_mods(spec) -> Tuple[float, float]:
    """(wire_ratio, quality) of a compression spec; (1, 1) for ``None``."""
    if spec is None:
        return 1.0, 1.0
    kind, frac = comp_mod.parse_spec(spec)
    return comp_mod.wire_ratio(kind, frac), comp_mod.quality(kind, frac)


def plan_hierarchical_h(
    levels: Sequence[SyncLevel],
    *,
    C: float,
    delta: float,
    t_total: float,
    t_lp: float,
    t_cp: float = 0.0,
    h_max: int = 10**6,
    h_max0: Optional[int] = None,
    straggler: Optional["StragglerModel"] = None,
    base_delays=None,
    skip_max: int = 3,
    rel_floor: float = 0.5,
    sim_rounds: int = 512,
    seed: int = 0,
    compression: Optional[Sequence] = None,
    acceleration: float = 0.0,
) -> list[dict]:
    """Choose per-level local-round counts bottom-up with eq. (12).

    ``h_max0`` additionally caps the INNERMOST level's H (the leaves'
    local steps) -- the compiled H capacity when the schedule declares an
    ``h_cap`` -- so the whole plan (round times, the root-round budget)
    is optimized under, and stays consistent with, what the executors can
    actually run.

    Level 0 is the innermost (fastest link). For level i, the 'local
    iteration' cost is the full inner-level round time, and the 'delay' is
    this level's collective cost. Returns [{name, H, round_time}] bottom-up.

    This is the paper's SS6 applied recursively: each level treats the level
    below it as its LocalDualMethod.

    ``straggler`` switches the innermost level (the one whose barrier the
    per-leaf straggler tail actually gates) to the straggler-aware joint
    (H, skip-threshold) optimization (:func:`optimal_h_bounded_skip`) over
    ``base_delays`` (default: the level's own nominal delay per group
    member; sessions pass the per-leaf sync-PATH delays over the whole
    fleet -- the barrier the runtime ``StragglerPolicy`` actually
    operates, since it drops leaves at root-chunk granularity; exact for
    stars, a deliberate fleet-level approximation of the innermost
    barrier on deeper trees); its plan row gains ``skip``/
    ``participation`` and its ``round_time``/``delay`` use the
    bounded-skip effective barrier cost, which the outer levels then
    amortize.

    ``compression`` is an optional per-level (bottom-up, same order as
    ``levels``) list of delta-compression specs (``None``/``"none"``/
    ``"int8"``/``"topk_<frac>"``): a compressed level's delay shrinks by
    ``wire_ratio`` (via ``round_delay(wire_ratio)``) while its improvement
    constant is diluted to ``C*quality`` -- the error-feedback loop re-sends
    the truncated mass over later rounds, so each round contracts a bit
    less.  Use :func:`choose_compression` to pick the specs automatically.

    ``acceleration`` plans under the accelerated per-round factor (see
    :func:`per_round_factor`): every level contracts faster, so eq. (12)
    settles on fewer, cheaper rounds to the same bound -- the planner-side
    counterpart of ``Schedule(acceleration=)``.
    """
    _check_acceleration(acceleration)
    for lvl in levels:
        try:
            _check_improvement_constant(C, lvl.group_size)
        except ValueError as e:
            raise ValueError(f"level {lvl.name!r}: {e}") from None
    plan = []
    inner_iter_time = t_lp
    inner_delta = delta
    for i, lvl in enumerate(levels):
        spec = None
        if compression is not None and i < len(compression):
            spec = compression[i]
        ratio, qual = _compression_mods(spec)
        c_in = max(C * qual, 1e-12)
        c_lvl = c_in
        hm = h_max if (i > 0 or h_max0 is None) else min(h_max, int(h_max0))
        if i == 0 and straggler is not None:
            base = (base_delays if base_delays is not None
                    else [lvl.round_delay(ratio)] * lvl.group_size)
            row = optimal_h_bounded_skip(
                C=c_in, K=lvl.group_size, delta=inner_delta, t_total=t_total,
                t_lp=inner_iter_time, t_cp=t_cp, base_delays=base,
                model=straggler, skip_max=skip_max, h_max=hm,
                rel_floor=rel_floor, n_rounds=sim_rounds, seed=seed,
                acceleration=acceleration)
            h, t_delay = row["H"], row["t_delay"]
            c_lvl = max(c_in * row["participation"], 1e-12)
            extra = {"skip": row["skip"],
                     "participation": row["participation"]}
        else:
            t_delay = lvl.round_delay(ratio)
            h, _ = optimal_h(
                C=c_in, K=lvl.group_size, delta=inner_delta, t_total=t_total,
                t_lp=inner_iter_time, t_delay=t_delay, t_cp=t_cp,
                h_max=hm, acceleration=acceleration,
            )
            extra = {}
        if spec is not None:
            extra["compress"] = str(spec)
        round_time = inner_iter_time * h + t_delay + t_cp
        plan.append({"name": lvl.name, "H": h, "round_time": round_time,
                     "delay": t_delay, **extra})
        # the level above sees one of our rounds as its local iteration, and
        # its effective per-iteration improvement shrinks geometrically
        inner_iter_time = round_time
        inner_delta = 1.0 - per_round_factor(h, c_lvl, lvl.group_size,
                                             inner_delta, acceleration)
    return plan


#: candidate specs ``choose_compression`` evaluates per level; "none" first
#: so ties (e.g. zero-delay levels) fall back to the exact path.
DEFAULT_COMPRESSION_CANDIDATES: Tuple[str, ...] = ("none", "int8", "topk")


def choose_compression(
    levels: Sequence[SyncLevel],
    *,
    C: float,
    delta: float,
    t_total: float,
    t_lp: float,
    t_cp: float = 0.0,
    h_max: int = 10**6,
    candidates: Sequence[str] = DEFAULT_COMPRESSION_CANDIDATES,
    acceleration: float = 0.0,
) -> list[dict]:
    """Delay-aware per-level compression selection (eq. (12) extended).

    Walks the levels bottom-up like :func:`plan_hierarchical_h`, but at each
    level evaluates eq. (12)'s bound for every candidate spec: compression
    scales the level's on-wire bytes by ``wire_ratio(spec)`` (so a slow,
    bandwidth-bound hop gets cheaper rounds and can afford more of them)
    while diluting the improvement constant to ``C*quality(spec)`` (the
    error-feedback loop re-sends the truncated mass later).  The spec with
    the lowest bound wins; the level above then amortizes the *chosen*
    round time and contraction.  The net effect is the paper's trade
    automated: fast inner levels keep ``"none"`` (nothing to win, only quality to
    lose), slow outer levels pick ``"int8"``/``"topk"``.

    Returns ``[{name, spec, H, round_time, delay, bound}]`` bottom-up.  Feed
    the ``spec`` column (bottom-up = innermost-first) to
    ``Schedule(compression=[...])`` or reverse it for ``compile_tree``'s
    root-first per-depth form.

    ``acceleration`` evaluates every candidate under the accelerated
    per-round factor (:func:`per_round_factor`), matching the rate the
    ``"sdca_acc"`` method actually runs.
    """
    _check_acceleration(acceleration)
    for lvl in levels:
        try:
            _check_improvement_constant(C, lvl.group_size)
        except ValueError as e:
            raise ValueError(f"level {lvl.name!r}: {e}") from None
    if not candidates:
        raise ValueError("need at least one candidate compression spec")
    plan = []
    inner_iter_time = t_lp
    inner_delta = delta
    for lvl in levels:
        best = None
        for spec in candidates:
            ratio, qual = _compression_mods(spec)
            c_eff = max(C * qual, 1e-12)
            t_delay = lvl.round_delay(ratio)
            h, bound = optimal_h(
                C=c_eff, K=lvl.group_size, delta=inner_delta,
                t_total=t_total, t_lp=inner_iter_time, t_delay=t_delay,
                t_cp=t_cp, h_max=h_max, acceleration=acceleration,
            )
            if best is None or bound < best["bound"]:
                best = {"name": lvl.name, "spec": str(spec), "H": h,
                        "round_time": inner_iter_time * h + t_delay + t_cp,
                        "delay": t_delay, "bound": bound, "_c": c_eff}
        c_eff = best.pop("_c")
        plan.append(best)
        inner_iter_time = best["round_time"]
        inner_delta = 1.0 - per_round_factor(best["H"], c_eff,
                                             lvl.group_size, inner_delta,
                                             acceleration)
    return plan


# ---------------------------------------------------------------------------
# eq. (11) calibration: estimate C from an observed run
# ---------------------------------------------------------------------------
def fit_C(history, *, K: int, H: float, delta: float,
          floor: float = 1e-3, c_max: Optional[float] = None) -> float:
    """Estimate eq. (11)'s improvement constant C from observed per-round
    duality-gap contractions.

    eq. (11) predicts ``gap_{t+1} / gap_t ~= g = 1 - (1 - (1-delta)^H) C/K``
    per round; inverting with the (robust) median observed ratio gives
    ``C = (1 - g) K / (1 - (1-delta)^H)``.  ``history`` is a solver history
    (list of ``{..., "gap"}`` dicts, a :class:`~repro_torch.core.instrument.
    SolveResult`, or a plain gap sequence) with at least two entries.  The
    estimate is clipped to ``[floor, c_max]`` (default ``c_max=K``) so
    downstream planners (:func:`plan_hierarchical_h`) always receive an
    admissible constant -- hierarchical planners must pass the SMALLEST
    group size over their levels as ``c_max``, since the same C is checked
    against every level's K."""
    cap = float(K) if c_max is None else float(c_max)
    if hasattr(history, "history"):
        history = history.history
    gaps = [float(h["gap"]) if isinstance(h, dict) else float(h)
            for h in history]
    gaps = [g for g in gaps if math.isfinite(g) and g > 0.0]
    if len(gaps) < 2:
        raise ValueError(
            "fit_C needs at least two positive finite gap observations; "
            f"got {len(gaps)} (record a longer pilot history)")
    ratios = [b / a for a, b in zip(gaps, gaps[1:], strict=False) if b < a]
    if not ratios:
        return floor          # no contraction observed at all
    g = float(np.median(ratios))
    eff = 1.0 - (1.0 - delta) ** H          # -> 1 for large H
    if eff <= 0.0:
        raise ValueError(f"delta={delta}, H={H} give no per-round progress")
    C = (1.0 - g) * K / eff
    return float(min(max(C, floor), cap))


# ---------------------------------------------------------------------------
# checkpoint-period planning: write cost vs. expected rework after a crash
# ---------------------------------------------------------------------------
def checkpoint_period(t_round: float, t_write: float, mtbf: float, *,
                      max_period: Optional[int] = None) -> int:
    """The checkpoint period (in ROOT ROUNDS) minimizing expected lost +
    overhead time on preemptible hardware: the Young/Daly optimum
    ``tau = sqrt(2 * t_write * MTBF)`` converted to rounds of length
    ``t_round`` and clamped to ``[1, max_period]``.

    Checkpointing every round pays ``t_write`` per round; never
    checkpointing loses half the run (in expectation) per failure.  The
    square-root optimum balances the amortized write cost
    (``t_write / tau``) against the expected rework (``tau / (2 MTBF)``).
    This is the term the eq.-(12) round-time model adds when a
    ``DelayModel`` declares ``ckpt_write``/``mtbf``: the per-round charge
    becomes ``t_round + t_write / period``, so ``rounds="auto"``'s time
    budget accounts the checkpoint overhead it planned."""
    if not t_round > 0:
        raise ValueError(f"t_round must be > 0, got {t_round}")
    if t_write < 0 or mtbf <= 0:
        raise ValueError(
            f"need t_write >= 0 and mtbf > 0, got {t_write}, {mtbf}")
    if t_write == 0:
        return 1                      # free writes: checkpoint every round
    tau = math.sqrt(2.0 * t_write * mtbf)
    period = max(1, int(round(tau / t_round)))
    if max_period is not None:
        period = min(period, int(max_period))
    return period


# ---------------------------------------------------------------------------
# straggler delay sampling: randomized per-leaf sync-path delays
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class StragglerModel:
    """Randomized per-leaf uplink delays around the topology's nominal ones.

    The paper's SS6 model treats the link delay as a constant; real networks
    have a heavy straggler tail on top.  Each round, a leaf's sync-path
    delay is its nominal base (the topology's up-link delays, typically
    derived from a :class:`LinkModel`'s ``delay(msg_bytes)``) with
    log-normal ``jitter``, and with probability ``slow_prob`` the leaf
    straggles: its delay is multiplied by ``slow_factor``.  This is the
    observation side that feeds ``runtime/straggler.py``'s decision
    policies in simulated (containerized) runs."""
    slow_prob: float = 0.1
    slow_factor: float = 20.0
    jitter: float = 0.05

    def __post_init__(self):
        if not 0.0 <= self.slow_prob <= 1.0:
            raise ValueError(f"slow_prob must be in [0, 1]: {self.slow_prob}")
        if self.slow_factor < 1.0:
            raise ValueError(
                f"slow_factor must be >= 1 (a straggler is slower, not "
                f"faster): {self.slow_factor}")

    def sample(self, base, rng: np.random.Generator) -> np.ndarray:
        """One round's per-leaf delays: ``base`` is the (n,) nominal
        sync-path delay per leaf (seconds)."""
        base = np.asarray(base, dtype=np.float64)
        d = base * np.exp(rng.normal(0.0, self.jitter, size=base.shape))
        slow = rng.random(base.shape) < self.slow_prob
        return np.where(slow, d * self.slow_factor, d)

    @classmethod
    def for_link(cls, link: LinkModel, msg_bytes: float, **kw) -> tuple:
        """Convenience: (nominal delay of one message on ``link``, model) --
        the base to hand :meth:`sample` when the topology's ``up_delay``
        values came from this link."""
        return link.delay(msg_bytes), cls(**kw)
