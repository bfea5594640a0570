"""Static analysis of the schedule engine.  Ported so far:
:mod:`repro_torch.analysis.plan_check`, the plan-IR verifier
(structural invariants of ``TreePlan`` / ``SchedulePlan`` and the
fingerprint-soundness audit), which ``Session.compile`` runs on every
plan.  The JAX package's strict runtime mode (``trace_guard``) and its
AST lint rules (``rules``, ``python -m repro.analysis``) are not ported
yet (ROADMAP A8)."""
from repro_torch.analysis.plan_check import (  # noqa: F401
    AnalysisError, Finding, audit_fingerprint, check_schedule_plan,
    check_tree_plan, verify_plan)

__all__ = ["AnalysisError", "Finding", "audit_fingerprint",
           "check_schedule_plan", "check_tree_plan", "verify_plan"]
