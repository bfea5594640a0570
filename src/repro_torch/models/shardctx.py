"""Tensor and data parallelism inside the model code (the JAX package's
``models/shardctx.py``).

The model modules are mesh-agnostic.  A step enters
``activation_sharding(mesh, rules)`` and every rank then runs the model on
its own shards, Megatron style: parameters arrive cut by
``launch/sharding.py::param_specs`` (FSDP over ``data``, TP over
``model``), the batch by ``batch_specs`` (rows over ``pod`` x ``data``),
and the collectives are the ``torch.autograd.Function``s below, built on
``core/engine/mesh.py::GroupComm`` (gloo: every collective an
``all_reduce``; NCCL: native):

* :func:`copy_to_model` -- identity forward, all-reduce backward: where a
  tensor replicated over ``model`` enters a rank's own share of the work
  (a column-parallel input, a replicated weight used on local heads);
* :func:`reduce_from_model` -- all-reduce forward, identity backward: a
  row-parallel output's partial sums (and the vocab-parallel embedding);
* :func:`gather_from_model` -- all-gather forward, reduce-scatter
  backward, over ``model`` (RG-LRU's gate input, logits);
* :func:`gather_params` -- FSDP's gather over the batch axes (the same
  all-gather / reduce-scatter pair over ``data``; a parameter replicated
  over a batch axis has its gradient summed over it), once per step;
* :func:`sum_over_model` -- all-reduce forward and backward: a partial
  sum whose total each rank uses on its own share (the sum of squares of
  :func:`rms_norm_over_model`, RWKV6's ``ln_x`` over split channels);
* :func:`reduce_scatter_over_model` / :func:`gather_whole_over_model` --
  partial sums onto this rank's chunk of a dim (all-gather backward), and
  the chunks made whole for a use every rank shares (its own chunk of the
  gradient backward): RWKV6's channel mix.

:func:`expert_range` is this rank's block of an expert-parallel MoE
layer's experts.

Which of a sub-layer's dims run split over ``model`` is read from the
parameter specs the context computed (:func:`split_over_model`, by the
leaf's path), never from the shapes the sub-layer is handed; a leaf whose
dim fell back to replicated is cut to this rank's share at use
(:func:`model_share`).

Outside a context every one of them is the identity, and
:func:`constrain` is a no-op: one rank runs the model as it always did.
The context is process-wide (one rank is one process), so the backward
-- and a remat recompute inside it, on the autograd engine's own thread
for CUDA tensors -- sees it while the step's ``with`` block is open.

``constrain(x, *logical)`` marks the reference's six block boundaries
(after the embedding and after each block, in train, prefill and decode).
There the port's layout is already the one the reference pins: rows local
over ``pod`` x ``data``, ``d_model`` whole and replicated over ``model``,
because each sub-layer reduces its row-parallel partial sums at its own
output (Megatron's ``g``) before the residual add -- the residual stream
and its norms need whole sums.  So ``constrain`` moves nothing; it checks
the rank of x.

Collective seconds are kept per axis (``ShardContext.seconds``): host
clock around each call, after a device synchronize on a gloo group (whose
collectives on card tensors block anyway), so the wait for earlier
kernels is not charged to the collective.
"""
from __future__ import annotations

import contextlib
import itertools
import time
from collections import defaultdict
from typing import Dict, Optional, Tuple

import torch

from repro_torch.launch.mesh import axis_size, mesh_coords

Tensor = torch.Tensor

class _Active:
    """The context in force, process-wide: not a ``contextvars`` variable,
    because the autograd engine runs a CUDA backward (and the remat
    recompute inside it) on its own thread, which must see it too."""

    ctx = None
# GroupComms by (mesh ranks, mesh axes, group axes); building one is a
# collective, so every rank of the world builds the same ones in order
_GROUPS: Dict[tuple, object] = {}
BATCH_AXES = ("pod", "data")


def _fibers(mesh, axes: Tuple[str, ...]):
    """Every group of ranks that differ only in ``axes`` (ranks ordered
    with ``axes[0]`` major)."""
    names = tuple(mesh.mesh_dim_names)
    on = [names.index(a) for a in axes]
    off = [i for i in range(len(names)) if i not in on]
    n = 1
    for i in on:
        n *= int(mesh.shape[i])
    return mesh.mesh.permute(off + on).reshape(-1, n).tolist()


def _group(mesh, axes: Tuple[str, ...]):
    """This rank's ``GroupComm`` over ``axes`` (None when it is not in the
    mesh), built once per mesh and axes."""
    import torch.distributed as dist

    from repro_torch.core.engine.mesh import GROUP_TIMEOUT, GroupComm
    key = (tuple(mesh.mesh.flatten().tolist()), tuple(mesh.mesh_dim_names),
           tuple(mesh.shape), axes)
    if key not in _GROUPS:
        fibers = _fibers(mesh, axes)
        group, _ = dist.new_subgroups_by_enumeration(fibers,
                                                     timeout=GROUP_TIMEOUT)
        me = dist.get_rank()
        mine = next((f for f in fibers if me in f), None)
        comm = None if mine is None else GroupComm(group, mine)
        if comm is not None and comm.order is not None:
            raise ValueError(f"the ranks of {axes} groups in {mesh} must "
                             f"ascend with their coordinates")
        _GROUPS[key] = comm
    return _GROUPS[key]


class ShardContext:
    """A mesh, its rules, this rank's coordinates and one ``GroupComm`` for
    every set of the mesh's axes of size > 1 (built on construction, a
    collective of the whole world: every rank constructs the same
    contexts in the same order, a rank outside the mesh included).  With
    ``axes`` only those of the mesh's axes are live: the model code runs
    split over them and treats the others as absent."""

    def __init__(self, mesh, rules, axes: Optional[Tuple[str, ...]] = None):
        self.mesh, self.rules = mesh, rules
        names = tuple(mesh.mesh_dim_names or ())
        # ``axes`` limits the live axes (a TreeSync replica: ``("model",)``,
        # its rows its own, no batch axis summed over)
        self.live = tuple(a for a in names if axis_size(mesh, a) > 1
                          and (axes is None or a in axes))
        self.comms: Dict[Tuple[str, ...], object] = {}
        for k in range(1, len(self.live) + 1):
            for axes in itertools.combinations(self.live, k):
                self.comms[axes] = _group(mesh, axes)
        try:
            self.coords = mesh_coords(mesh)
        except ValueError:
            self.coords = None                 # a rank outside the mesh
        self.seconds: Dict[str, float] = defaultdict(float)
        self.calls: Dict[str, int] = defaultdict(int)
        self._pspecs: Dict = {}
        self._model_dims: Dict = {}

    @property
    def member(self) -> bool:
        return self.coords is not None

    def size(self, axes) -> int:
        n = 1
        for a in axes:
            n *= axis_size(self.mesh, a)
        return n

    def index(self, axes) -> int:
        """This rank's chunk of a dim split over ``axes`` (first major)."""
        i = 0
        for a in axes:
            i = i * axis_size(self.mesh, a) + self.coords.get(a, 0)
        return i

    def _comm(self, axes):
        live = tuple(a for a in axes if a in self.live)
        order = tuple(a for a in self.live if a in live)
        if live != order:
            raise NotImplementedError(
                f"a dim split over {axes} against the mesh's axis order "
                f"{self.live}")
        return live, (self.comms[live] if live else None)

    def _timed(self, live, comm, x: Tensor, fn):
        if x.is_cuda and not comm.native:
            torch.cuda.synchronize(x.device)
        t0 = time.perf_counter()
        out = fn()
        if out.is_cuda and not comm.native:
            torch.cuda.synchronize(out.device)
        key = "+".join(live)
        self.seconds[key] += time.perf_counter() - t0
        self.calls[key] += 1
        return out

    # ---- plain collectives (no autograd) --------------------------------
    def all_reduce(self, x: Tensor, axes) -> Tensor:
        live, comm = self._comm(axes)
        if comm is None:
            return x
        return self._timed(live, comm, x, lambda: comm.all_reduce(x))

    def gather(self, x: Tensor, dim: int, axes) -> Tensor:
        """Concatenate every member's ``x`` along ``dim`` in coordinate
        order."""
        live, comm = self._comm(axes)
        if comm is None:
            return x
        dim = dim % x.dim()

        def run():
            rows = comm.gather_rows(x.contiguous().reshape(1, -1))
            full = rows.reshape((comm.size,) + tuple(x.shape))
            return full.movedim(0, dim).flatten(dim, dim + 1)

        return self._timed(live, comm, x, run)

    def reduce_scatter(self, x: Tensor, dim: int, axes) -> Tensor:
        """This rank's chunk along ``dim`` of the members' sum."""
        live, comm = self._comm(axes)
        if comm is None:
            return x
        dim = dim % x.dim()
        shape = list(x.shape)
        shape[dim] //= comm.size

        def run():
            # (G, *shape): chunk i of the dim first, as reduce_scatter keeps
            flat = x.unflatten(dim, (comm.size, shape[dim])).movedim(dim, 0)
            return comm.reduce_scatter(flat.reshape(1, -1)).reshape(shape)

        return self._timed(live, comm, x, run)

    # ---- specs of a config ----------------------------------------------
    def param_specs(self, cfg):
        """``param_specs`` of ``cfg`` on this mesh (stacked layout)."""
        if cfg not in self._pspecs:
            from repro_torch.launch import sharding
            from repro_torch.launch.steps import params_shape
            self._pspecs[cfg] = sharding.param_specs(
                cfg, params_shape(cfg), self.mesh, self.rules)
        return self._pspecs[cfg]

    def model_dims(self, cfg, leaf: Tuple[str, ...]) -> Tuple[bool, ...]:
        """Per dim of the parameter leaves whose path ends with ``leaf``
        (the stacked blocks' leading dim left out): whether their spec
        splits it over ``model``.  Every such leaf must agree."""
        key = (cfg, leaf)
        if key not in self._model_dims:
            from repro_torch.launch.sharding import entry_axes, flat_with_path
            found = {tuple("model" in entry_axes(e)
                           for e in (spec[1:] if path[0] == "blocks"
                                     else spec))
                     for path, spec in flat_with_path(self.param_specs(cfg))
                     if tuple(path[-len(leaf):]) == leaf}
            if len(found) != 1:
                raise KeyError(f"{cfg.name}'s parameter leaves "
                               f"{'/'.join(leaf)}: {len(found)} layouts")
            self._model_dims[key] = found.pop()
        return self._model_dims[key]

    def batch_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in BATCH_AXES if a in self.live)

    def reset_timing(self) -> None:
        self.seconds.clear()
        self.calls.clear()


# ---------------------------------------------------------------------------
# the context
# ---------------------------------------------------------------------------
_CONTEXTS: Dict[tuple, ShardContext] = {}


def context_for(mesh, rules, axes: Optional[Tuple[str, ...]] = None
                ) -> ShardContext:
    """The :class:`ShardContext` of ``(mesh, rules, axes)``, built on first
    use (a collective of the whole world)."""
    ranks = getattr(mesh, "mesh", None)
    key = (None if ranks is None else tuple(ranks.flatten().tolist()),
           tuple(mesh.mesh_dim_names), tuple(mesh.shape), rules,
           None if axes is None else tuple(axes))
    if key not in _CONTEXTS:
        _CONTEXTS[key] = ShardContext(mesh, rules, axes)
    return _CONTEXTS[key]


@contextlib.contextmanager
def activation_sharding(mesh, rules, axes: Optional[Tuple[str, ...]] = None):
    """Run the model code inside on this rank's shards of ``mesh`` (split
    over ``axes`` alone when given)."""
    ctx = context_for(mesh, rules, axes)
    prev, _Active.ctx = _Active.ctx, ctx
    try:
        yield ctx
    finally:
        _Active.ctx = prev


def current() -> Optional[ShardContext]:
    return _Active.ctx


def constrain(x: Tensor, *logical: Optional[str]) -> Tensor:
    """Mark a block boundary: x's layout by logical axis names (None =
    unconstrained dim).  No-op outside an activation_sharding context;
    inside it, x is already rows-local and replicated over ``model`` (see
    the module docstring), so this checks the rank."""
    if _Active.ctx is not None and len(logical) != x.dim():
        raise ValueError(f"constrain: {len(logical)} logical axes for a "
                         f"tensor of shape {tuple(x.shape)}")
    return x


# ---------------------------------------------------------------------------
# the collectives as autograd Functions
# ---------------------------------------------------------------------------
class _Copy(torch.autograd.Function):
    """Identity forward, all-reduce backward (Megatron's ``f``)."""

    @staticmethod
    def forward(ctx, x, sc, axes):
        ctx.sc, ctx.axes = sc, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.sc.all_reduce(g, ctx.axes), None, None


class _Reduce(torch.autograd.Function):
    """All-reduce forward, identity backward (Megatron's ``g``)."""

    @staticmethod
    def forward(ctx, x, sc, axes):
        return sc.all_reduce(x, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Gather(torch.autograd.Function):
    """All-gather along a dim forward, reduce-scatter backward."""

    @staticmethod
    def forward(ctx, x, sc, dim, axes):
        ctx.sc, ctx.dim, ctx.axes = sc, dim, axes
        return sc.gather(x, dim, axes)

    @staticmethod
    def backward(ctx, g):
        return ctx.sc.reduce_scatter(g, ctx.dim, ctx.axes), None, None, None


class _SumBoth(torch.autograd.Function):
    """All-reduce forward and backward: a partial sum whose total each rank
    uses on its own share of the work (a norm over split channels)."""

    @staticmethod
    def forward(ctx, x, sc, axes):
        ctx.sc, ctx.axes = sc, axes
        return sc.all_reduce(x, axes)

    @staticmethod
    def backward(ctx, g):
        return ctx.sc.all_reduce(g, ctx.axes), None, None


class _ReduceScatter(torch.autograd.Function):
    """Reduce-scatter along a dim forward, all-gather backward: partial sums
    onto this rank's chunk of the dim."""

    @staticmethod
    def forward(ctx, x, sc, dim, axes):
        ctx.sc, ctx.dim, ctx.axes = sc, dim, axes
        return sc.reduce_scatter(x, dim, axes)

    @staticmethod
    def backward(ctx, g):
        return ctx.sc.gather(g, ctx.dim, ctx.axes), None, None, None


class _GatherWhole(torch.autograd.Function):
    """All-gather along a dim forward, this rank's chunk backward: the
    chunks made whole where every rank then uses the whole alike (the
    residual stream), so the gradient is the same on every rank."""

    @staticmethod
    def forward(ctx, x, sc, dim, axes):
        ctx.dim, ctx.n = dim, x.shape[dim]
        ctx.i = sc.index(sc._comm(axes)[0])
        return sc.gather(x, dim, axes)

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(ctx.dim, ctx.i * ctx.n, ctx.n).contiguous(), None,
                None, None)


def model_size() -> int:
    ctx = _Active.ctx
    return 1 if ctx is None else axis_size(ctx.mesh, "model")


def model_rank() -> int:
    ctx = _Active.ctx
    return 0 if ctx is None else ctx.coords.get("model", 0)


def copy_to_model(x: Tensor) -> Tensor:
    ctx = _Active.ctx
    if ctx is None or "model" not in ctx.live:
        return x
    return _Copy.apply(x, ctx, ("model",))


def reduce_from_model(x: Tensor) -> Tensor:
    ctx = _Active.ctx
    if ctx is None or "model" not in ctx.live:
        return x
    return _Reduce.apply(x, ctx, ("model",))


def gather_from_model(x: Tensor, dim: int) -> Tensor:
    ctx = _Active.ctx
    if ctx is None or "model" not in ctx.live:
        return x
    return _Gather.apply(x, ctx, dim, ("model",))


def sum_over_model(x: Tensor) -> Tensor:
    """The sum of every rank's partial ``x`` over ``model``, all-reduced in
    the backward too (each rank's use of the total is its own share)."""
    ctx = _Active.ctx
    if ctx is None or "model" not in ctx.live:
        return x
    return _SumBoth.apply(x, ctx, ("model",))


def reduce_scatter_over_model(x: Tensor, dim: int) -> Tensor:
    """This rank's chunk along ``dim`` of the sum over ``model`` of every
    rank's partial ``x``."""
    ctx = _Active.ctx
    if ctx is None or "model" not in ctx.live:
        return x
    return _ReduceScatter.apply(x, ctx, dim % x.dim(), ("model",))


def gather_whole_over_model(x: Tensor, dim: int) -> Tensor:
    """Every rank's chunk of ``dim`` made whole, for a use that is the same
    on every rank (its gradient cut back to this rank's chunk)."""
    ctx = _Active.ctx
    if ctx is None or "model" not in ctx.live:
        return x
    return _GatherWhole.apply(x, ctx, dim % x.dim(), ("model",))


def rms_norm_over_model(x: Tensor, scale: Tensor, eps: float = 1e-6
                        ) -> Tensor:
    """``models/common.py::rms_norm`` of a tensor whose last dim is split
    over ``model`` (``scale`` this rank's share of the gain): the sum of
    squares runs over the whole width, all-reduced."""
    dt = x.dtype
    xf = x.float()
    ss = sum_over_model(torch.sum(xf * xf, dim=-1, keepdim=True))
    var = ss / (x.shape[-1] * model_size())
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(dt)


def expert_range(cfg) -> Tuple[int, int]:
    """(first expert, expert count) of this rank in an expert-parallel MoE
    layer: the specs split the expert dim over ``model`` (``(0, E)``
    when they do not)."""
    E = cfg.num_experts
    if not split_over_model(cfg, ("ffn", "w_up"), 0):
        return 0, E
    n = E // model_size()
    return model_rank() * n, n


def own_chunk(x: Tensor, dim: int) -> Tensor:
    """This rank's chunk along ``dim`` of a tensor whole on every rank (no
    collective)."""
    c = x.shape[dim] // model_size()
    return x.narrow(dim, model_rank() * c, c)


def split_over_model(cfg, leaf: Tuple[str, ...], dim: int) -> bool:
    """Whether ``param_specs`` splits dim ``dim`` of the parameter leaf
    whose path ends with ``leaf`` (``("mix", "wq")``) over ``model``;
    False outside a context or on a ``model`` axis of 1."""
    ctx = _Active.ctx
    if ctx is None or "model" not in ctx.live:
        return False
    return ctx.model_dims(cfg, leaf)[dim]


def model_share(cfg, leaf: Tuple[str, ...], t: Tensor, dim: int) -> Tensor:
    """This rank's share along ``dim`` of the leaf ``t`` (path ending with
    ``leaf``) in a sub-layer that runs split over ``model``: ``t`` as it
    is when its spec split the dim, else (the leaf fell back to
    replicated) this rank's slice, its gradient summed over ``model``."""
    if split_over_model(cfg, leaf, dim):
        return t
    c = t.shape[dim] // model_size()
    return copy_to_model(t).narrow(dim, model_rank() * c, c)


def reduce_from_batch(x: Tensor) -> Tensor:
    """Sum over the batch axes, identity backward (a loss's partial sums)."""
    ctx = _Active.ctx
    if ctx is None or not ctx.batch_axes():
        return x
    return _Reduce.apply(x, ctx, ctx.batch_axes())


def batch_rows() -> Tuple[int, int]:
    """(this rank's chunk, chunks) of the batch rows."""
    ctx = _Active.ctx
    if ctx is None or not ctx.batch_axes():
        return 0, 1
    axes = ctx.batch_axes()
    return ctx.index(axes), ctx.size(axes)


def gather_from_batch(x: Tensor, dim: int = 0) -> Tensor:
    ctx = _Active.ctx
    if ctx is None or not ctx.batch_axes():
        return x
    return _Gather.apply(x, ctx, dim, ctx.batch_axes())


def local_range(n: int, logical: str) -> Tuple[int, int]:
    """(start, length) of this rank's share of a dim of size ``n`` that
    the rules put on ``logical`` (the whole dim when it falls back)."""
    ctx = _Active.ctx
    if ctx is None:
        return 0, n
    from repro_torch.launch.sharding import _fit, entry_axes
    axes = ctx.rules.get(logical)
    got = _fit(n, axes, ctx.mesh, set(), None) if axes else None
    if got is None:
        return 0, n
    axes = entry_axes(got)
    c = n // ctx.size(axes)
    return ctx.index(axes) * c, c


def gather_params(cfg, params):
    """FSDP's gather: ``params`` (this rank's shards, either layout) whole
    over the batch axes and still split over ``model``.  Each gathered dim
    is an all-gather forward and a reduce-scatter backward; a leaf
    replicated over a batch axis gets its gradient summed over that axis.

    The steps call it once, at the start of a step, for every leaf; the
    reference's XLA program gathers each block's leaves where it uses
    them.  So between that gather and the step's end a rank holds the
    whole parameters split only over ``model``, and FSDP saves parameter
    memory only between steps (the optimizer state stays sharded)."""
    ctx = _Active.ctx
    if ctx is None or not ctx.batch_axes():
        return params
    from repro_torch.launch.sharding import (entry_axes, for_layout,
                                             map_with_path, spec_axes)
    baxes = ctx.batch_axes()
    specs = for_layout(ctx.param_specs(cfg), params)

    def use(_path, spec, t):
        rep = tuple(a for a in baxes if a not in spec_axes(spec))
        if rep:
            t = _Copy.apply(t, ctx, rep)
        for dim, entry in enumerate(spec):
            axes = entry_axes(entry)
            on = tuple(a for a in axes if a in baxes)
            if not on:
                continue
            if on != axes:
                raise NotImplementedError(
                    f"a parameter dim split over both batch and model axes "
                    f"({axes})")
            t = _Gather.apply(t, ctx, dim, axes)
        return t

    return map_with_path(use, specs, params)


class LeafShard:
    """What a sharded optimizer step needs of one parameter leaf: its
    global ``shape`` and ``sum(x, dims)``, the all-reduce of a partial sum
    over the mesh axes that split the leaf's ``dims`` (all dims when
    None)."""

    def __init__(self, spec, shape, ctx: ShardContext):
        self.spec, self.shape, self.ctx = tuple(spec), tuple(shape), ctx

    def sum(self, x: Tensor, dims=None) -> Tensor:
        from repro_torch.launch.sharding import entry_axes
        nd = len(self.shape)
        picked = range(nd) if dims is None else [d % nd for d in dims]
        axes = tuple(a for a in self.ctx.live
                     if any(a in entry_axes(self.spec[d]) for d in picked))
        return self.ctx.all_reduce(x, axes) if axes else x


def leaf_shards(cfg, params):
    """One :class:`LeafShard` per leaf of ``params`` (the stacked layout),
    in ``tree_leaves`` order; None outside a context."""
    ctx = _Active.ctx
    if ctx is None:
        return None
    from repro_torch.launch.sharding import flat_with_path, for_layout
    from repro_torch.launch.steps import params_shape
    specs = flat_with_path(for_layout(ctx.param_specs(cfg), params))
    shapes = flat_with_path(params_shape(cfg), is_leaf=lambda x: False)
    return [LeafShard(s, tuple(t.shape), ctx)
            for (_, s), (_, t) in zip(specs, shapes, strict=True)]
