"""The tree-schedule engine: any ``TreeNode`` topology lowered to a flat
static plan (``plan``) and run tick by tick on one device (``host``)::

    plan = compile_tree(tree)            # the static schedule (the IR)
    keys = key_plan(tree, plan, key)     # legacy-RNG per-solve key replay
    ex   = get_host_executor(plan, loss=loss, backend="cuda", device=dev)
    alpha, w = ex(ex.prepare(X, y), keys, alpha0, w0, participation, steps,
                  regularizer_scale(lam, m))

Backends: ``"cuda"`` (the hand-written ``sdca_block`` leaf kernel) and
``"torch"`` (its plain version).
"""
from repro_torch.core.engine.host import (  # noqa: F401
    BACKENDS, HostExecutor, execute_plan, get_host_executor,
    regularizer_scale)
from repro_torch.core.engine.plan import (  # noqa: F401
    LevelSpec, TreePlan, chunked_key_plan,
    compile_tree, full_participation, full_steps, index_plan, key_plan,
    steps_for_h)

__all__ = ["BACKENDS", "HostExecutor", "execute_plan", "get_host_executor",
           "regularizer_scale", "LevelSpec", "TreePlan",
           "chunked_key_plan", "compile_tree",
           "full_participation", "full_steps", "index_plan", "key_plan",
           "steps_for_h"]
