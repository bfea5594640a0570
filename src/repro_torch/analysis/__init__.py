"""Static and runtime analysis of the schedule engine: the plan-IR
verifier :mod:`repro_torch.analysis.plan_check` (structural invariants
of ``TreePlan`` / ``SchedulePlan`` and the fingerprint-soundness audit),
which ``Session.compile`` runs on every plan, and the strict runtime mode
:mod:`repro_torch.analysis.trace_guard` (``compile(strict=...)``).  The
JAX package's AST lint rules (``rules``, ``python -m repro.analysis``)
are not ported yet (ROADMAP A8); that lint already covers this package's
sources."""
from repro_torch.analysis.plan_check import (  # noqa: F401
    AnalysisError, Finding, audit_fingerprint, check_schedule_plan,
    check_tree_plan, verify_plan)
from repro_torch.analysis.trace_guard import (  # noqa: F401
    HostSyncError, NonFiniteError, TraceGuard, UnexpectedRetraceError,
    as_trace_guard, check_finite, no_host_sync, no_retrace)

__all__ = ["AnalysisError", "Finding", "audit_fingerprint",
           "check_schedule_plan", "check_tree_plan", "verify_plan",
           "HostSyncError", "NonFiniteError", "TraceGuard",
           "UnexpectedRetraceError", "as_trace_guard", "check_finite",
           "no_host_sync", "no_retrace"]
