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
* :func:`gather_params` -- FSDP's gather over the axes that are not
  tensor parallel (the same all-gather / reduce-scatter pair, over
  ``data``, or over ``data`` and ``model`` at once for a dim split over
  both; a parameter replicated over such an axis has its gradient summed
  over it), once per step;
* :func:`optimizer_step` -- the optimizer on this rank's shards, and
  under ZeRO-1 rules (``zero1``) on this rank's cut of each parameter
  whose state the rules split further, the cuts all-gathered after;
* :func:`sum_over_model` -- all-reduce forward and backward: a partial
  sum whose total each rank uses on its own share (the sum of squares of
  :func:`rms_norm_over_model`, RWKV6's ``ln_x`` over split channels);
* :func:`reduce_scatter_over_model` / :func:`gather_whole_over_model` --
  partial sums onto this rank's chunk of a dim (all-gather backward), and
  the chunks made whole for a use every rank shares (its own chunk of the
  gradient backward): RWKV6's channel mix.

:func:`expert_range` is this rank's block of an expert-parallel MoE
layer's experts.

The batch axes of a context are the live axes its rules put in
``act_batch``.  ``model`` is tensor parallel unless it is one of them:
under pure-FSDP rules (``launch/perf.py::_FSDP_PURE``) it is a batch axis,
every parameter dim split over it is gathered at the step's start like
one split over ``data``, and no tensor-parallel code runs.  The decode
cache's rows are split over the batch axes in ``cache_batch``; where that
leaves the cache whole over some (``serve_headdata``), a rank decodes its
own rows of it (:func:`own_rows`) and gathers every row's new entries
over those axes (:func:`rows_to_cache`).

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

A context on a mesh with no ranks (``launch/mesh.py::AbstractMesh``)
stands in for one rank (``rank``, its row-major position, 0 by default)
in a single process, with no process group: every group is a
:class:`CountingComm`, which takes ``meta`` tensors, returns outputs of
the right shape and records each call (op, result bytes, the axes it
crossed and the group's positions) in ``ShardContext.collectives``.
Pricing those calls is ``launch/roofline.py``'s.
"""
from __future__ import annotations

import contextlib
import itertools
import time
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.launch.mesh import AbstractMesh, axis_size, mesh_coords

Tensor = torch.Tensor

class _Active:
    """The context in force, process-wide: not a ``contextvars`` variable,
    because the autograd engine runs a CUDA backward (and the remat
    recompute inside it) on its own thread, which must see it too."""

    ctx = None
# GroupComms by (mesh ranks, mesh axes, group axes); building one is a
# collective, so every rank of the world builds the same ones in order
_GROUPS: Dict[tuple, object] = {}


def _fibers(mesh, axes: Tuple[str, ...]):
    """Every group of ranks that differ only in ``axes`` (ranks ordered
    with ``axes[0]`` major); a mesh with no ranks numbers its positions
    row-major."""
    names = tuple(mesh.mesh_dim_names)
    on = [names.index(a) for a in axes]
    off = [i for i in range(len(names)) if i not in on]
    n = 1
    for i in on:
        n *= int(mesh.shape[i])
    ranks = getattr(mesh, "mesh", None)
    if ranks is None:
        ranks = torch.arange(_numel(mesh.shape)).reshape(tuple(mesh.shape))
    return ranks.permute(off + on).reshape(-1, n).tolist()


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


class CommCall(NamedTuple):
    """One collective a counting comm took: its op (the JAX package's HLO
    name), result bytes, the mesh axes its group spans and the group's
    row-major positions."""
    op: str
    result_bytes: int
    axes: Tuple[str, ...]
    ranks: Tuple[int, ...]

    @property
    def group_size(self) -> int:
        return len(self.ranks)


class CountingComm:
    """One group of a mesh as one rank sees it, in a single process with no
    process group: ``GroupComm``'s forms on ``meta`` tensors.  Each call
    returns an empty output of the right shape and appends a
    :class:`CommCall` to ``log``: all-reduce result bytes are the
    tensor's, all-gather's the gathered whole, reduce-scatter's this
    rank's chunk (the JAX package's HLO conventions)."""

    native = True

    def __init__(self, axes: Tuple[str, ...], ranks, log: list):
        self.axes, self.ranks = tuple(axes), tuple(int(r) for r in ranks)
        self.size = len(self.ranks)
        self.log = log

    def _record(self, op: str, out: Tensor) -> Tensor:
        if out.device.type != "meta":
            raise ValueError(f"a counting comm takes meta tensors, got "
                             f"{out.device}")
        self.log.append(CommCall(op, out.numel() * out.element_size(),
                                 self.axes, self.ranks))
        return out

    def all_reduce(self, x: Tensor) -> Tensor:
        return self._record("all-reduce", torch.empty_like(
            x, memory_format=torch.contiguous_format))

    def gather_rows(self, x: Tensor) -> Tensor:
        """(1, k) -> (G, k)."""
        return self._record("all-gather", x.new_empty(
            (self.size,) + tuple(x.shape[1:])))

    def reduce_scatter(self, x: Tensor) -> Tensor:
        """(1, G p) -> (1, p)."""
        return self._record("reduce-scatter", x.new_empty(
            (1, x.shape[-1] // self.size)))


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
    split over them and treats the others as absent.

    On a mesh with no ranks every group is a :class:`CountingComm` of the
    rank at row-major position ``rank`` (0 by default), and no process
    group is built."""

    def __init__(self, mesh, rules, axes: Optional[Tuple[str, ...]] = None,
                 *, rank: int = 0):
        self.mesh, self.rules = mesh, rules
        names = tuple(mesh.mesh_dim_names or ())
        # ``axes`` limits the live axes (a TreeSync replica: ``("model",)``,
        # its rows its own, no batch axis summed over)
        self.live = tuple(a for a in names if axis_size(mesh, a) > 1
                          and (axes is None or a in axes))
        # the rows' axes, from the rules (AxisRules' default without
        # them); "model" is tensor parallel unless it is one (pure FSDP)
        rows = ("pod", "data") if rules is None else \
            rules.get("act_batch") or ()
        self.batch = tuple(a for a in self.live if a in rows)
        self.tp = "model" in self.live and "model" not in self.batch
        # the batch axes the decode cache's rows are split over
        # (``cache_batch``); the cache is whole over the others
        crows = rows if rules is None else rules.get("cache_batch") or ()
        self.cache_batch = tuple(a for a in self.batch if a in crows)
        self.counting = getattr(mesh, "mesh", None) is None
        self.collectives: List[CommCall] = []
        self.comms: Dict[Tuple[str, ...], object] = {}
        pos = int(rank)
        for k in range(1, len(self.live) + 1):
            for axes in itertools.combinations(self.live, k):
                if self.counting:
                    mine = next(f for f in _fibers(mesh, axes)
                                if pos in f)
                    self.comms[axes] = CountingComm(axes, mine,
                                                    self.collectives)
                else:
                    self.comms[axes] = _group(mesh, axes)
        if self.counting:
            self.coords = mesh_coords(mesh, pos)
        else:
            try:
                self.coords = mesh_coords(mesh)
            except ValueError:
                self.coords = None             # a rank outside the mesh
        self.seconds: Dict[str, float] = defaultdict(float)
        self.calls: Dict[str, int] = defaultdict(int)
        self._pspecs: Dict = {}
        self._model_dims: Dict = {}
        self._zero1: Dict = {}

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

    def zero1_specs(self, cfg, optimizer):
        """Under ZeRO-1 rules, for ``optimizer`` on ``cfg`` (computed once):
        the parameter specs with the zero1 axes added (the cut of each
        parameter a rank updates, stacked layout), and the flat optimizer
        state specs as held (``opt_state_specs``) and as the update uses
        them (laid out like the cut)."""
        key = (cfg, optimizer)
        if key not in self._zero1:
            from repro_torch.launch import sharding as sh
            from repro_torch.launch.steps import params_shape
            pshape = params_shape(cfg)
            oshape = optimizer.init(pshape)
            cut = sh.map_with_path(
                lambda _p, spec, t: sh.zero1_extend(
                    spec, tuple(t.shape), self.mesh, self.rules),
                self.param_specs(cfg), pshape)
            held = [s for _, s in sh.flat_with_path(sh.opt_state_specs(
                cfg, oshape, pshape, self.mesh, self.rules))]
            used = [s for _, s in sh.flat_with_path(sh.state_specs_of(
                oshape, pshape, cut))]
            self._zero1[key] = (cut, held, used)
        return self._zero1[key]

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
        """The live axes the rows are split over."""
        return self.batch

    def fsdp_axes(self) -> Tuple[str, ...]:
        """The live axes parameters are gathered over: all but a tensor
        parallel ``model``."""
        return tuple(a for a in self.live if a != "model" or not self.tp)

    def reset_timing(self) -> None:
        self.seconds.clear()
        self.calls.clear()
        self.collectives.clear()


def positions(mesh) -> AbstractMesh:
    """``mesh``'s axes and sizes with no ranks: a context on it counts."""
    return AbstractMesh(mesh.shape, mesh.mesh_dim_names)


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


def activation_sharding(mesh, rules, axes: Optional[Tuple[str, ...]] = None):
    """Run the model code inside on this rank's shards of ``mesh`` (split
    over ``axes`` alone when given)."""
    return activate(context_for(mesh, rules, axes))


@contextlib.contextmanager
def activate(ctx: ShardContext):
    """Run the model code inside under ``ctx``."""
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
    """The tensor-parallel ``model`` axis' size (1 where it is not)."""
    ctx = _Active.ctx
    return 1 if ctx is None or not ctx.tp else axis_size(ctx.mesh, "model")


def model_rank() -> int:
    ctx = _Active.ctx
    return 0 if ctx is None or not ctx.tp else ctx.coords.get("model", 0)


def copy_to_model(x: Tensor) -> Tensor:
    ctx = _Active.ctx
    if ctx is None or not ctx.tp:
        return x
    return _Copy.apply(x, ctx, ("model",))


def reduce_from_model(x: Tensor) -> Tensor:
    ctx = _Active.ctx
    if ctx is None or not ctx.tp:
        return x
    return _Reduce.apply(x, ctx, ("model",))


def gather_from_model(x: Tensor, dim: int) -> Tensor:
    ctx = _Active.ctx
    if ctx is None or not ctx.tp:
        return x
    return _Gather.apply(x, ctx, dim, ("model",))


def sum_over_model(x: Tensor) -> Tensor:
    """The sum of every rank's partial ``x`` over ``model``, all-reduced in
    the backward too (each rank's use of the total is its own share)."""
    ctx = _Active.ctx
    if ctx is None or not ctx.tp:
        return x
    return _SumBoth.apply(x, ctx, ("model",))


def reduce_scatter_over_model(x: Tensor, dim: int) -> Tensor:
    """This rank's chunk along ``dim`` of the sum over ``model`` of every
    rank's partial ``x``."""
    ctx = _Active.ctx
    if ctx is None or not ctx.tp:
        return x
    return _ReduceScatter.apply(x, ctx, dim % x.dim(), ("model",))


def gather_whole_over_model(x: Tensor, dim: int) -> Tensor:
    """Every rank's chunk of ``dim`` made whole, for a use that is the same
    on every rank (its gradient cut back to this rank's chunk)."""
    ctx = _Active.ctx
    if ctx is None or not ctx.tp:
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
    False outside a context, on a ``model`` axis of 1 or one that is a
    batch axis."""
    ctx = _Active.ctx
    if ctx is None or not ctx.tp:
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
    the rules put on ``logical`` (the whole dim when it falls back); the
    batch axes split the rows, never such a dim (as ``launch/sharding.py::
    cache_specs`` keeps them)."""
    ctx = _Active.ctx
    if ctx is None:
        return 0, n
    from repro_torch.launch.sharding import _fit, entry_axes
    axes = ctx.rules.get(logical)
    got = _fit(n, axes, ctx.mesh, set(ctx.batch_axes()), None) \
        if axes else None
    if got is None:
        return 0, n
    axes = entry_axes(got)
    c = n // ctx.size(axes)
    return ctx.index(axes) * c, c


def gather_params(cfg, params):
    """FSDP's gather: ``params`` (this rank's shards, either layout) whole
    over the axes that are not tensor parallel (``fsdp_axes``) and still
    split over a tensor-parallel ``model``.  Each gathered dim is an
    all-gather forward and a reduce-scatter backward, over all of its
    entry's axes at once (major first, as :meth:`ShardContext.index`
    orders them); a leaf replicated over such an axis gets its gradient
    summed over that axis.

    The steps call it once, at the start of a step, for every leaf; the
    reference's XLA program gathers each block's leaves where it uses
    them.  So between that gather and the step's end a rank holds the
    whole parameters split only over ``model``, and FSDP saves parameter
    memory only between steps (the optimizer state stays sharded)."""
    ctx = _Active.ctx
    if ctx is None or not ctx.fsdp_axes():
        return params
    from repro_torch.launch.sharding import (entry_axes, for_layout,
                                             map_with_path, spec_axes)
    faxes = ctx.fsdp_axes()
    specs = for_layout(ctx.param_specs(cfg), params)

    def use(_path, spec, t):
        rep = tuple(a for a in faxes if a not in spec_axes(spec))
        if rep:
            t = _Copy.apply(t, ctx, rep)
        for dim, entry in enumerate(spec):
            axes = entry_axes(entry)
            on = tuple(a for a in axes if a in faxes)
            if not on:
                continue
            if on != axes:
                raise NotImplementedError(
                    f"a parameter dim split over both a batch axis and the "
                    f"tensor-parallel model axis ({axes})")
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


def _cache_whole_over() -> Tuple[str, ...]:
    """The batch axes the decode cache's rows are whole over (where
    ``cache_batch`` leaves them out of the batch's, ``serve_headdata``)."""
    ctx = _Active.ctx
    if ctx is None or ctx.cache_batch == ctx.batch:
        return ()
    if ctx.batch[:len(ctx.cache_batch)] != ctx.cache_batch:
        raise NotImplementedError(
            f"a decode cache whose rows are split over {ctx.cache_batch}, "
            f"the batch over {ctx.batch}: the cache's axes must be the "
            f"batch's major ones")
    return ctx.batch[len(ctx.cache_batch):]


def own_rows(t: Tensor) -> Tensor:
    """This rank's rows (dim 0) of a decode-cache tensor whose rows are
    whole over some batch axes (:func:`_cache_whole_over`): a view, so a
    write into it lands in the cache."""
    axes = _cache_whole_over()
    if not axes:
        return t
    ctx = _Active.ctx
    c = t.shape[0] // ctx.size(axes)
    return t.narrow(0, ctx.index(axes) * c, c)


def rows_to_cache(t: Tensor) -> Tensor:
    """The cache's rows (dim 0) of ``t``, computed on this rank's rows:
    every rank's gathered over the batch axes the cache is whole over."""
    axes = _cache_whole_over()
    if not axes:
        return t
    return _Active.ctx.gather(t, 0, axes)


def move_dim(ctx: ShardContext, t: Tensor, dim: int, src, dst) -> Tensor:
    """``t``, split along ``dim`` over the axes of spec entry ``src``, as
    split over those of ``dst``: gathered whole over ``src``, then this
    rank's chunk of ``dst`` (no collective when the two agree)."""
    from repro_torch.launch.sharding import entry_axes
    was, now = entry_axes(src), entry_axes(dst)
    if was == now:
        return t
    if was:
        t = ctx.gather(t, dim, was)
    if now:
        c = t.shape[dim] // ctx.size(now)
        t = t.narrow(dim, ctx.index(now) * c, c).contiguous()
    return t


def _respec(ctx: ShardContext, t: Tensor, src, dst) -> Tensor:
    """``t``, this rank's shard under spec ``src``, as its shard under
    ``dst``: :func:`move_dim` on every dim."""
    for dim, (a, b) in enumerate(zip(src, dst, strict=True)):
        t = move_dim(ctx, t, dim, a, b)
    return t


def optimizer_step(cfg, optimizer, params, grads, opt_state, lr=None):
    """``optimizer.update`` on this rank's shards (``shards=`` from
    :func:`leaf_shards`; outside a context, on the whole tree).

    Under rules with ``zero1`` set, ``opt_state`` is cut by
    ``launch/sharding.py::opt_state_specs``, which splits a leaf's state
    over the zero1 axes where its parameter is whole over them.  Then the
    optimizer runs on this rank's cut of each such parameter and of its
    gradient (reduced over the batch axes already), against its own shard
    of the state, and the updated cuts are all-gathered over the zero1
    axes, so that every rank holds its whole shard of the parameter again:
    the reference's update under any layout.  A state leaf whose zero1 cut
    lies on another dim than its parameter's (Adafactor's ``vc`` of a leaf
    cut along its rows) is laid out as the parameter's cut for the update
    and back after; the optimizers stay layout-blind, their sums over a
    leaf crossing the zero1 axes through :class:`LeafShard`."""
    ctx = _Active.ctx
    if ctx is None:
        return optimizer.update(params, grads, opt_state, lr=lr)
    from repro_torch.launch import sharding as sh
    from repro_torch.optim.api import tree_leaves, tree_unflatten
    shards = leaf_shards(cfg, params)
    if not ctx.rules.get("zero1"):
        return optimizer.update(params, grads, opt_state, lr=lr,
                                shards=shards)
    cut_specs, held, used = ctx.zero1_specs(cfg, optimizer)
    pspecs = ctx.param_specs(cfg)
    flat_cut = [s for _, s in sh.flat_with_path(sh.for_layout(cut_specs,
                                                              params))]
    flat_p = [s for _, s in sh.flat_with_path(sh.for_layout(pspecs, params))]
    cut = [_respec(ctx, t, a, b) for t, a, b in
           zip(tree_leaves(params), flat_p, flat_cut, strict=True)]
    gcut = [_respec(ctx, t, a, b) for t, a, b in
            zip(tree_leaves(grads), flat_p, flat_cut, strict=True)]
    state = [_respec(ctx, t, a, b) for t, a, b in
             zip(tree_leaves(opt_state), held, used, strict=True)]
    new_p, new_s = optimizer.update(
        tree_unflatten(params, cut), tree_unflatten(grads, gcut),
        tree_unflatten(opt_state, state), lr=lr,
        shards=[LeafShard(c, s.shape, ctx) for c, s in
                zip(flat_cut, shards, strict=True)])
    new_p = [_respec(ctx, t, b, a) for t, a, b in
             zip(tree_leaves(new_p), flat_p, flat_cut, strict=True)]
    new_s = [_respec(ctx, t, b, a) for t, a, b in
             zip(tree_leaves(new_s), held, used, strict=True)]
    return (tree_unflatten(params, new_p),
            tree_unflatten(opt_state, new_s))
