"""Runtime guard: strict mode for ``Session`` and ``LMSession`` (the JAX
package's ``analysis/trace_guard.py``).

The engine's performance story is "one built executor per plan and
variant; schedules, learning rates, masks and periods are runtime
operands".  An executor-cache miss where a hit was expected means that
contract broke: something that should be a runtime operand leaked into a
cache key.  Strict mode turns such a miss into an error at the point of
the miss, with a field-by-field diff of the offending key against the
nearest cached one.

Three guards, bundled by :class:`TraceGuard`:

  * :func:`no_retrace` -- a context manager holding an executor-cache
    miss budget (default 0) over a region, across the host, mesh and LM
    caches (``core/engine/host.py``, ``core/engine/mesh.py``,
    ``core/engine/lm.py``); exceeding it raises
    :class:`UnexpectedRetraceError` with the key diffs.
  * host-sync guard -- ``torch.cuda.set_sync_debug_mode("error")`` scoped
    to an executor dispatch region: a ``.item()``, ``float()`` or a copy
    to the host of a card tensor inside it raises :class:`HostSyncError`.
    ``Session.run`` (SDCA) guards its executor steps; the LM path draws
    its data on the host side of the step by design, as the reference
    does, and is not guarded.  Tensors on the CPU never sync.
  * :func:`check_finite` -- opt-in NaN/Inf check of a state, raising
    :class:`NonFiniteError` naming the first offending leaf (one device
    sync per check).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterator, List, Optional

import torch


class UnexpectedRetraceError(RuntimeError):
    """An executor-cache miss happened where strict mode budgeted none;
    ``misses`` holds the offending named keys, each with a ``diff``
    against the nearest key already in its cache."""

    def __init__(self, message: str, misses: List[dict]):
        super().__init__(message)
        self.misses = misses


class HostSyncError(RuntimeError):
    """A device-to-host synchronization happened inside a guarded
    dispatch region."""


class NonFiniteError(FloatingPointError):
    """The sanitizer found NaN/Inf; ``where`` names the leaf."""

    def __init__(self, message: str, where: str):
        super().__init__(message)
        self.where = where


# ---------------------------------------------------------------------------
# retrace guard
# ---------------------------------------------------------------------------
def _caches():
    """(stats, keys, miss log) of each executor cache."""
    from repro_torch.core.engine import host as host_mod
    from repro_torch.core.engine import lm as lm_mod
    from repro_torch.core.engine import mesh as mesh_mod
    return [
        (host_mod.host_executor_cache_stats, host_mod.executor_cache_keys,
         host_mod.host_executor_miss_log),
        (mesh_mod.mesh_executor_cache_stats, mesh_mod.mesh_executor_cache_keys,
         lambda: list(mesh_mod._MISS_LOG)),
        (lm_mod.lm_executor_cache_stats, lm_mod.lm_executor_cache_keys,
         lm_mod.lm_executor_miss_log),
    ]


def _total_misses() -> int:
    return sum(stats()["misses"] for stats, _, _ in _caches())


def _key_diff(new: dict, cached: List[dict]) -> Optional[dict]:
    """Field-by-field diff of ``new`` against its nearest neighbour in
    ``cached`` (fewest differing fields wins): {field: (new, cached)}."""
    best = None
    for old in cached:
        if set(old) != set(new):
            continue
        delta = {f: (new[f], old[f]) for f in new if new[f] != old[f]}
        if best is None or len(delta) < len(best):
            best = delta
    return best


@contextlib.contextmanager
def no_retrace(budget: int = 0) -> Iterator[None]:
    """Assert at most ``budget`` executor-cache misses (host, mesh and LM
    caches) happen inside the ``with`` body; raise
    :class:`UnexpectedRetraceError` with key diffs otherwise."""
    caches = _caches()
    before = _total_misses()
    logs_before = [len(log()) for _, _, log in caches]
    yield
    new = _total_misses() - before
    if new <= budget:
        return
    entries = []
    for (_, keys, log), n0 in zip(caches, logs_before, strict=True):
        for e in log()[n0:]:
            others = [k for k in keys() if k != e["key"]]
            entries.append(dict(e, diff=_key_diff(e["key"], others)))
    lines = []
    for e in entries:
        lines.append(f"  [{e['backend']}] key = {e['key']}")
        for f, (nv, ov) in (e["diff"] or {}).items():
            lines.append(f"      {f}: {nv!r} (cached: {ov!r})")
    detail = "\n".join(lines) or "  (miss in a cache without a miss log)"
    raise UnexpectedRetraceError(
        f"{new} executor-cache miss(es) in a region budgeted for "
        f"{budget}: an operand that should be a runtime input leaked into "
        "a cache key (or the cache was cleared mid-session).  Offending "
        f"keys, with field diffs against the nearest cached key:\n{detail}",
        entries)


# ---------------------------------------------------------------------------
# host-sync guard
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def no_host_sync() -> Iterator[None]:
    """Make a host synchronization with the card raise inside the body
    (``torch.cuda.set_sync_debug_mode("error")``, restored after), as
    :class:`HostSyncError`.  Without a card it guards nothing."""
    if not torch.cuda.is_available():
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    except RuntimeError as e:
        if "synchroniz" not in str(e).lower():
            raise
        raise HostSyncError(
            "host synchronization inside the dispatch region: a card value "
            "was pulled to the host (.item(), float(), .cpu(), ...), which "
            "stalls the launch queue.  Move the read out of the guarded "
            f"region.  Original: {e}") from e
    finally:
        torch.cuda.set_sync_debug_mode(prev)


# ---------------------------------------------------------------------------
# NaN/Inf sanitizer
# ---------------------------------------------------------------------------
def _leaves_with_path(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_path(tree[k], f"{prefix}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_path(v, f"{prefix}[{i}]")
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _leaves_with_path(getattr(tree, f.name),
                                         f"{prefix}.{f.name}")
    elif isinstance(tree, torch.Tensor):
        yield prefix, tree


def check_finite(tree, where: str = "value") -> None:
    """Raise :class:`NonFiniteError` if any float tensor of ``tree`` (dicts,
    lists, tuples, dataclasses) holds NaN/Inf."""
    for path, leaf in _leaves_with_path(tree):
        if not leaf.is_floating_point():
            continue
        bad = ~torch.isfinite(leaf)
        n_bad = int(bad.sum())
        if n_bad:
            loc = f"{where}{path}"
            raise NonFiniteError(
                f"non-finite values in {loc}: {n_bad}/{leaf.numel()} "
                "entries are NaN/Inf.  The run diverged -- lower "
                "lambda/lr, shrink H, or inspect the history up to here.",
                loc)


# ---------------------------------------------------------------------------
# the bundle sessions thread through their loops
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class TraceGuard:
    """Strict-mode policy for one session (``compile(strict=True)``
    installs ``TraceGuard()``).  Fields:

      * ``error_on_retrace`` -- unexpected executor-cache misses raise
        :class:`UnexpectedRetraceError`; the first fetch of each variant
        is budgeted one build, every later fetch none.
      * ``miss_budget`` -- extra allowed misses per guarded region.
      * ``guard_host_sync`` -- host syncs inside an SDCA executor
        dispatch raise.
      * ``sanitize`` -- check the state for NaN/Inf after every round
        (one device sync each; off by default).
    """
    error_on_retrace: bool = True
    miss_budget: int = 0
    guard_host_sync: bool = True
    sanitize: bool = False

    def retrace_region(self, budget: Optional[int] = None):
        if not self.error_on_retrace:
            return contextlib.nullcontext()
        return no_retrace(self.miss_budget if budget is None else budget)

    def dispatch_region(self):
        if not self.guard_host_sync:
            return contextlib.nullcontext()
        return no_host_sync()

    def check_carry(self, tree, where: str = "carry") -> None:
        if self.sanitize:
            check_finite(tree, where)


def as_trace_guard(strict) -> Optional[TraceGuard]:
    """Normalize a ``compile(strict=...)`` argument: falsy -> None, True ->
    the default :class:`TraceGuard`, a TraceGuard -> itself."""
    if not strict:
        return None
    if strict is True:
        return TraceGuard()
    if isinstance(strict, TraceGuard):
        return strict
    raise TypeError(
        f"strict must be a bool or a TraceGuard, got {type(strict).__name__}")
