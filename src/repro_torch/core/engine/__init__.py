"""The tree-schedule engine: any ``TreeNode`` topology lowered to a flat
static plan (``plan``) and run tick by tick on one device (``host``)::

    plan = compile_tree(tree)            # the static schedule (the IR)
    keys = key_plan(tree, plan, key)     # legacy-RNG per-solve key replay
    ex   = get_host_executor(plan, loss=loss, backend="cuda", device=dev)
    alpha, w = ex(ex.prepare(X, y), keys, alpha0, w0, participation, steps,
                  regularizer_scale(lam, m))

Backends: ``"cuda"`` (the hand-written ``sdca_block`` leaf kernel) and
``"torch"`` (its plain version).  ``get_host_executor(batched=True)``
adds a leading config axis (one kernel launch per tick for every config)
and ``accelerated=True`` the ``sdca_acc`` server momentum; ``method``
registers the two methods (``get_method("sdca" | "sdca_acc")``).
``mesh.get_mesh_executor`` / ``mesh.execute_plan_mesh`` run a
level-homogeneous plan as a ``torch.distributed`` program, one rank per
leaf (used by ``core/treedual_mesh.py`` and ``Session.compile(backend=
"mesh")``).  Executors are cached (``host.executor_cache_stats`` reads
every cache's counters), and :func:`solve` is the reference's legacy
one-call entry point, over ``api.solve``.
"""
from __future__ import annotations

from repro_torch.core.dual import Loss
from repro_torch.core.engine.host import (  # noqa: F401
    BACKENDS, HostExecutor, clear_executor_cache, execute_plan,
    executor_cache_keys, executor_cache_stats, executor_miss_log,
    get_host_executor, regularizer_scale)
from repro_torch.core.engine.mesh import (  # noqa: F401
    execute_plan_mesh, get_mesh_executor)
from repro_torch.core.engine.method import (  # noqa: F401
    Method, get_method, register_method)
from repro_torch.core.engine.plan import (  # noqa: F401
    LevelSpec, SchedulePlan, TreePlan, balanced_tree, chunk_participation,
    chunked_key_plan, compile_tree, full_participation, full_steps,
    index_plan, key_plan, plan_diff, schedule_view, steps_for_h,
    tree_from_level_plan)

__all__ = ["BACKENDS", "HostExecutor", "execute_plan", "get_host_executor",
           "regularizer_scale", "executor_cache_stats",
           "executor_cache_keys", "executor_miss_log",
           "clear_executor_cache", "solve", "execute_plan_mesh",
           "get_mesh_executor",
           "Method", "get_method", "register_method",
           "LevelSpec", "SchedulePlan", "TreePlan", "balanced_tree",
           "chunk_participation", "chunked_key_plan", "compile_tree",
           "full_participation", "full_steps", "index_plan", "key_plan",
           "plan_diff", "schedule_view", "steps_for_h",
           "tree_from_level_plan"]


def solve(tree, X, y, *, loss: Loss, lam: float, key=None,
          record_history: bool = True, backend: str = "cuda",
          weighting: str = "uniform", device=None):
    """Algorithm 3 at the root of ``tree`` (a ``core/tree.py::TreeNode``):
    the reference's legacy entry point, a shim over ``api.solve`` -- the
    tree runs as per-root-round chunks of one cached executor, as every
    other entry point does.  ``backend`` is ``"cuda"`` (the ``sdca_block``
    kernel) or ``"torch"`` (its plain version); ``device`` defaults to
    X's.  Returns a ``SolveResult``."""
    from repro_torch import api   # api is layered above the engine
    m = X.shape[0]
    assert tree.total_data() == m, (
        f"tree data sizes {tree.total_data()} != m={m}")
    return api.solve(
        api.Problem(X, y, loss=loss, lam=lam),
        api.Topology.from_tree(tree),
        api.Schedule(weighting=weighting),
        backend=backend, device=X.device if device is None else device,
        key=key, record_history=record_history)
