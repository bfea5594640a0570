"""The Method protocol: what a workload plugs into the schedule IR.

The plan IR (``core/engine/plan.py``) is method-agnostic -- tree shape,
per-level rounds, step masks, participation, compression specs, RNG
chaining.  A *Method* supplies the two method-specific pieces the paper's
TreeDualMethod leaves open: the **local step** a leaf runs H times
between syncs, and the **per-level combine** a tree level applies to its
children.  Registered here:

  ``"sdca"``      -- the paper's dual coordinate ascent: local step =
                     Procedure P over a coordinate block, combine =
                     (dalpha keep-own, dw sum/average); the executors of
                     ``core/engine/host.py`` and, for ``backend="mesh"``,
                     of ``core/engine/mesh.py`` (one rank per leaf).
  ``"sdca_acc"``  -- the accelerated primal-dual flavor (Ma et al., arXiv
                     1711.05305): the same local step, but every server
                     combine extrapolates BOTH sides of the primal-dual
                     pair with one momentum coefficient (a runtime scalar
                     of the executor; ``acceleration=0`` is bit-identical
                     to ``"sdca"``).  The same executors, built with
                     ``accelerated=True``.

  ``"lm_treesync"`` -- LM training (``core/engine/lm.py``): local step =
                     one optimizer update on this rank's replica, combine
                     = a (masked) parameter / optimizer-state mean over
                     the level's sync group; mesh backend only, one rank
                     per replica.

Every method's executors are cached; ``cache_stats`` reads the counters
(the SDCA methods: the merged table of ``core/engine/host.py``; the LM
method: its own cache's).
"""
from __future__ import annotations

from typing import Dict

from repro_torch.core.engine import host as host_mod
from repro_torch.core.engine import mesh as mesh_mod


class Method:
    """A workload on the schedule IR: ``executor(**kw)`` returns the
    executor for one (plan, backend, variant) tuple, ``cache_stats()``
    its executor cache's counters."""

    name: str = "?"

    def executor(self, **kw):
        raise NotImplementedError

    def cache_stats(self) -> Dict:
        raise NotImplementedError


class SDCAMethod(Method):
    """The paper's tree-DCA on the host executor (backends ``"cuda"`` and
    ``"torch"``, see ``core/engine/host.py``) or the mesh executor
    (``"mesh"``: ``mesh=``, ``axes=``, ``use_kernel=``, ``sync=``, see
    ``core/engine/mesh.py``)."""

    name = "sdca"

    def executor(self, *, plan, backend="cuda", **kw):
        if backend in host_mod.BACKENDS:
            return host_mod.get_host_executor(plan, backend=backend, **kw)
        if backend == "mesh":
            return mesh_mod.get_mesh_executor(plan, kw.pop("mesh", None),
                                              **kw)
        raise ValueError(f"sdca: unknown backend {backend!r}")

    def cache_stats(self) -> Dict:
        return host_mod.executor_cache_stats()


class SDCAAccMethod(SDCAMethod):
    """Accelerated tree-DCA: the ``"sdca"`` executors built with
    ``accelerated=True`` (``step`` gains a trailing runtime
    ``acceleration`` scalar, the state the per-depth momentum anchors).
    Selected by ``Schedule(acceleration=...)``."""

    name = "sdca_acc"

    def executor(self, *, plan, backend="cuda", **kw):
        kw["accelerated"] = True
        return super().executor(plan=plan, backend=backend, **kw)


class LMTreeSyncMethod(Method):
    """Replica-per-rank LM training on the mesh backend (``executor(cfg=,
    optimizer=, level_sizes=, compression=, average_opt_state=, masked=,
    with_lr=, batched=, mesh=, axes=)``, see ``core/engine/lm.py``)."""

    name = "lm_treesync"

    def executor(self, **kw):
        from repro_torch.core.engine import lm as lm_mod
        return lm_mod.get_lm_executor(**kw)

    def cache_stats(self) -> Dict[str, int]:
        from repro_torch.core.engine import lm as lm_mod
        return lm_mod.lm_executor_cache_stats()


_REGISTRY: Dict[str, Method] = {}


def register_method(method: Method) -> Method:
    _REGISTRY[method.name] = method
    return method


register_method(SDCAMethod())
register_method(SDCAAccMethod())
register_method(LMTreeSyncMethod())


def get_method(name: str) -> Method:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown method {name!r}; registered: {sorted(_REGISTRY)}"
        ) from None
