"""``python -m repro_torch.analysis [--strict] PATH...`` -- run the port's
static analysis over source trees; exit 1 on any finding (the JAX
package's ``python -m repro.analysis``).

Default: the AST lint rules (``repro_torch.analysis.rules``) over every
``.py`` under the given paths.  ``--strict`` also runs the plan-IR audits
that need no plan instance: the fingerprint-registry classification audit
and a verifier self-check on a representative compiled plan (the
reference's: 3 levels, heterogeneous leaf sizes and H, mixed per-depth
compression), so a plan.py regression fails even when no test builds
that shape.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.analysis import plan_check, rules


def _strict_audits() -> int:
    """Plan-IR audits that run without user input; returns #findings."""
    findings = plan_check.audit_fingerprint(None)
    from repro_torch.core.engine.plan import compile_tree
    from repro_torch.core.tree import TreeNode
    leaves_a = tuple(
        TreeNode(name=f"a{i}", rounds=2 + i, data_size=5 + i)
        for i in range(2))
    leaves_b = tuple(
        TreeNode(name=f"b{i}", rounds=3, data_size=4) for i in range(3))
    tree = TreeNode(name="root", rounds=2, children=(
        TreeNode(name="ga", rounds=2, children=leaves_a),
        TreeNode(name="gb", rounds=1, children=leaves_b),
    ))
    plan = compile_tree(tree, compression=(None, "int8"))
    findings += plan_check.check_tree_plan(plan)
    for f in findings:
        print(f"plan-ir: {f}", file=sys.stderr)
    return len(findings)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="the port's static analysis: AST lint rules, plus "
                    "(--strict) the plan-IR fingerprint/verifier audits")
    ap.add_argument("paths", nargs="+", help="files or directories to lint")
    ap.add_argument("--strict", action="store_true",
                    help="also run the plan-IR self-audits")
    args = ap.parse_args(argv)

    findings = rules.lint_paths(args.paths)
    for f in findings:
        print(str(f), file=sys.stderr)
    n = len(findings)
    if args.strict:
        n += _strict_audits()
    if n:
        print(f"repro_torch.analysis: {n} finding(s)", file=sys.stderr)
        return 1
    print("repro_torch.analysis: clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
