"""Static and runtime analysis of the schedule engine: the plan-IR
verifier :mod:`repro_torch.analysis.plan_check` (structural invariants
of ``TreePlan`` / ``SchedulePlan`` and the fingerprint-soundness audit),
which ``Session.compile`` runs on every plan, the strict runtime mode
:mod:`repro_torch.analysis.trace_guard` (``compile(strict=...)``), and
the port's AST lint :mod:`repro_torch.analysis.rules` (``python -m
repro_torch.analysis``: the JAX package's rules retargeted to PyTorch
step bodies and tick loops, plus ``compile-outside-engine`` and
``host-sync-in-tick``)."""
from repro_torch.analysis.plan_check import (  # noqa: F401
    AnalysisError, Finding, audit_fingerprint, check_schedule_plan,
    check_tree_plan, verify_plan)
from repro_torch.analysis.trace_guard import (  # noqa: F401
    HostSyncError, NonFiniteError, TraceGuard, UnexpectedRetraceError,
    as_trace_guard, check_finite, no_host_sync, no_retrace)
from repro_torch.analysis.rules import lint_paths  # noqa: F401

__all__ = ["AnalysisError", "Finding", "audit_fingerprint",
           "check_schedule_plan", "check_tree_plan", "verify_plan",
           "HostSyncError", "NonFiniteError", "TraceGuard",
           "UnexpectedRetraceError", "as_trace_guard", "check_finite",
           "no_host_sync", "no_retrace", "lint_paths"]
