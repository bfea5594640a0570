"""``session.compile_s``: the benchmark's host-clock span around
``Session.compile`` (``api/session.py``: the plan from
``core/engine/plan.py::compile_tree``, ``analysis/plan_check.py``'s
verifier, the executor from the cache, the blocked layout)."""


def read(ctx):
    return ctx["spans"].get("session.compile")
