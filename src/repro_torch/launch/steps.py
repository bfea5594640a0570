"""Step functions and the per-cell sharded programs (the JAX package's
``launch/steps.py``):

  train_4k     -> train_step(params, opt_state, batch)
  prefill_32k  -> prefill_step(params, batch)           (builds the cache)
  decode_32k   -> serve_step(params, cache, tokens)     (one new token)
  long_500k    -> serve_step with a 512k-token cache    (sub-quadratic only)

:func:`build_cell` makes one (cfg x shape x mesh) cell: FSDP over ``data``
and TP over ``model`` (``launch/sharding.py``, ``models/shardctx.py``:
Megatron-style for attention, MLPs and RG-LRU, expert parallel for MoE,
head parallel for RWKV6).
Its program runs one step on this rank's shards of the parameters,
optimizer state, batch and cache, cut by the specs in ``in_shardings``.
The parameters are gathered over ``data`` once, at the start of a step,
not block by block where they are used as the reference's XLA program
does: during a step a rank holds them whole but for the ``model`` split.
Every rule set of ``launch/perf.py::VARIANTS`` lays out: under ZeRO-1
rules the optimizer updates this rank's cut of each parameter and the
cuts are all-gathered (``shardctx.optimizer_step``); under pure-FSDP
rules ``model`` is a batch axis; where ``cache_batch`` leaves the cache
whole over an axis the tokens are split over (``serve_headdata``),
prefill hands its cache out so, and each rank decodes its rows of the
tokens against its rows of the cache and gathers the new cache entries
of every row over that axis (``shardctx.own_rows`` / ``rows_to_cache``).
The shape stand-ins (``params_shape`` and friends) are meta tensors from
the init functions themselves: no memory and no draw.
:meth:`CellProgram.lower` runs one rank's step on them and counts its
flops, bytes, peak memory and collectives (``launch/lowered.py``): what
the dry-run (``launch/dryrun.py``) reads.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.core import prng
from repro_torch.launch import sharding as sh
from repro_torch.models import shardctx, transformer
from repro_torch.optim import Optimizer, get_optimizer
from repro_torch.optim.api import tree_leaves, tree_unflatten

PyTree = Any

# ---------------------------------------------------------------------------
# input specs (meta tensors -- no allocation; stand-ins)
# ---------------------------------------------------------------------------
def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """Model-input stand-ins for one shape cell.

    [audio]/[vlm] backbones take precomputed frame/patch embeddings for
    full-sequence passes (the modality frontend is a stub per assignment);
    decode always feeds tokens through the text embedding table.
    """
    B, S = shape.global_batch, shape.seq_len
    ii32 = functools.partial(torch.empty, dtype=torch.int32, device="meta")
    if shape.kind == "decode":
        return {"tokens": ii32((B, 1))}
    batch: Dict[str, Any] = {}
    if cfg.input_mode == "embeddings":
        batch["embeds"] = torch.empty((B, S, cfg.d_model),
                                      dtype=torch.bfloat16, device="meta")
    else:
        batch["tokens"] = ii32((B, S))
    if shape.kind == "train":
        batch["labels"] = ii32((B, S))
    return batch


@functools.lru_cache(maxsize=64)
def params_shape(cfg: ModelConfig) -> PyTree:
    """The parameters' shapes and dtypes, as meta tensors in the
    reference's (stacked) layout.  Cached: do not modify the result."""
    return transformer.stack_blocks(
        transformer.init_params(cfg, prng.PRNGKey(0), device="meta"))


def cache_shape(cfg: ModelConfig, batch: int, max_len: int) -> PyTree:
    """The decode cache's shapes, stacked as the reference's (``pos`` a
    0-d int32)."""
    cache = transformer.stack_blocks(
        transformer.init_cache(cfg, batch, max_len, device="meta"))
    cache["pos"] = torch.empty((), dtype=torch.int32, device="meta")
    return cache


def opt_shape(cfg: ModelConfig, optimizer: Optimizer) -> PyTree:
    return optimizer.init(params_shape(cfg))


# ---------------------------------------------------------------------------
# step functions
# ---------------------------------------------------------------------------
def _shard_scope(shard_ctx: Optional[shardctx.ShardContext]):
    """Context entered inside each step so model-level collectives and
    ``constrain(...)`` calls resolve; no-op when shard_ctx is None."""
    if shard_ctx is None:
        return contextlib.nullcontext()
    return shardctx.activate(shard_ctx)


def grads_of(cfg: ModelConfig, params, batch, plain_recurrence: bool = False):
    """(grads shaped like ``params``, metrics) of ``forward_train``'s total
    loss; the parameters are used through aliases that require grad, so
    the caller's tensors are left as they are.  A parameter the loss does
    not reach (the token embedding of a model fed embeddings) gets a zero
    gradient, as under ``jax.grad``.  Inside a shard context the aliases
    are this rank's shards, gathered over the batch axes at use."""
    flat = tree_leaves(params)
    live = [p.detach().requires_grad_(True) for p in flat]
    with torch.enable_grad():
        used = shardctx.gather_params(cfg, tree_unflatten(params, live))
        total, metrics = transformer.forward_train(cfg, used, batch,
                                                   plain_recurrence)
        grads = torch.autograd.grad(total, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(live, grads, strict=True)]
    return (tree_unflatten(params, grads),
            {k: v.detach() for k, v in metrics.items()})


def make_train_step(cfg: ModelConfig, optimizer: Optional[Optimizer] = None,
                    shard_ctx=None, microbatches: int = 1) -> Callable:
    """``train_step(params, opt_state, batch, lr=None) -> (params,
    opt_state, metrics)``.  microbatches > 1 = gradient accumulation: the
    global batch is split along dim 0 and grads are averaged across
    sequential microbatch passes (activation memory shrinks by the
    factor; FLOPs are unchanged).  With ``shard_ctx`` every argument is
    this rank's shards (``build_cell``)."""
    optimizer = optimizer or get_optimizer(cfg)

    def train_step(params, opt_state, batch, lr=None):
        with _shard_scope(shard_ctx):
            if microbatches == 1:
                grads, metrics = grads_of(cfg, params, batch)
            else:
                mbs = {k: v.reshape((microbatches,
                                     v.shape[0] // microbatches)
                                    + tuple(v.shape[1:]))
                       for k, v in batch.items()}
                acc, metrics = grads_of(cfg, params,
                                        {k: v[0] for k, v in mbs.items()})
                flat = tree_leaves(acc)
                for i in range(1, microbatches):
                    g_i, m_i = grads_of(cfg, params,
                                        {k: v[i] for k, v in mbs.items()})
                    for a, g in zip(flat, tree_leaves(g_i), strict=True):
                        a.add_(g)
                    metrics = {k: metrics[k] + m_i[k] for k in metrics}
                grads = tree_unflatten(acc, [g / microbatches for g in flat])
                metrics = {k: v / microbatches for k, v in metrics.items()}
            params, opt_state = shardctx.optimizer_step(
                cfg, optimizer, params, grads, opt_state, lr=lr)
            return params, opt_state, metrics

    return train_step


def _serving_layout(params) -> PyTree:
    """``params`` (or a cache) with ``blocks`` a list of per-block dicts
    (views of a stacked ``blocks``), the layout prefill and decode walk."""
    if not isinstance(params.get("blocks"), dict):
        return params
    n = tree_leaves(params["blocks"])[0].shape[0]
    return dict(params, blocks=[transformer.block_params(params, i)
                                for i in range(n)])


def make_prefill_step(cfg: ModelConfig, max_len: Optional[int] = None,
                      shard_ctx=None) -> Callable:
    """``prefill_step(params, batch) -> (last-position logits, cache)``;
    params in either layout."""

    def prefill_step(params, batch):
        with _shard_scope(shard_ctx):
            params = shardctx.gather_params(cfg, _serving_layout(params))
            return transformer.prefill(cfg, params, batch, max_len=max_len)

    return prefill_step


def make_serve_step(cfg: ModelConfig, shard_ctx=None,
                    max_len: Optional[int] = None) -> Callable:
    """One decode step: greedy next token + updated cache (the cache in
    either layout; returned in prefill's).  ``max_len`` is the cache's
    context length (needed when a shard context splits its slots)."""

    def serve_step(params, cache, tokens):
        with _shard_scope(shard_ctx):
            params = shardctx.gather_params(cfg, _serving_layout(params))
            logits, cache = transformer.decode_step(
                cfg, params, _serving_layout(cache), tokens, max_len=max_len)
            next_tokens = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
            return next_tokens, cache

    return serve_step


# ---------------------------------------------------------------------------
# the sharded program of one (cfg x shape x mesh) cell
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class CellProgram:
    """One cell's step on this rank's shards.  ``step`` (also the
    program's ``__call__``) takes the arguments ``arg_shapes`` describes
    (meta stand-ins of the whole values), each cut for this rank by the
    spec tree of the same position in ``in_shardings`` (:meth:`local`).
    ``make_step(ctx)`` builds the step under another shard context (what
    :meth:`lower` counts)."""
    kind: str
    step: Callable
    arg_shapes: Tuple[Any, ...]
    in_shardings: Tuple[Any, ...]
    notes: Dict[str, Any]
    ctx: Any = None
    make_step: Optional[Callable] = None

    def __call__(self, *args):
        if self.ctx is not None and not self.ctx.member:
            raise ValueError(f"this rank is not in the cell's mesh "
                             f"{self.ctx.mesh}")
        return self.step(*args)

    def local(self, i: int, tree: PyTree, coords=None) -> PyTree:
        """This rank's (or the rank at ``coords``') shards of argument
        ``i`` given whole."""
        return sh.shard_tree(tree, self.in_shardings[i], self.ctx.mesh,
                             coords)

    def lower(self, rank: int = 0):
        """Run the step once on meta stand-ins of ``arg_shapes`` cut to the
        shards of the rank at row-major position ``rank`` of the mesh,
        with counting comms in place of the mesh's groups (no process
        group is used), and count it: a ``launch/lowered.py::LoweredCell``
        whose ``cost_analysis()``, ``memory_analysis()`` and
        ``collectives()`` stand where the reference's compiled XLA
        program's do."""
        from repro_torch.launch.lowered import count_step
        ctx = shardctx.ShardContext(shardctx.positions(self.ctx.mesh),
                                    self.ctx.rules, rank=rank)
        args = [self.local(i, t, ctx.coords)
                for i, t in enumerate(self.arg_shapes)]
        if self.kind == "decode":
            # the cache's position is a host int in the port: the new
            # token takes the last of the seq_len slots
            args[1] = dict(args[1], pos=self.notes["seq_len"] - 1)
        return count_step(self.make_step(ctx), tuple(args), ctx)


def _whole_batch(step: Callable, ctx, bspecs, i: int) -> Callable:
    """``step`` with its argument ``i`` (the batch) made whole along every
    trailing dim its spec splits (``embeds`` over ``act_seq``, the
    reference's sequence-parallel boundary): the port runs no sequence
    parallelism, so each rank's rows enter the model whole."""
    split = {k: [(d, sh.entry_axes(e)) for d, e in enumerate(spec)
                 if d and sh.entry_axes(e)]
             for k, spec in bspecs.items()}
    if not any(split.values()):
        return step

    def run(*args, **kw):
        args = list(args)
        batch = dict(args[i])
        for k, dims in split.items():
            for d, axes in dims:
                batch[k] = ctx.gather(batch[k], d, axes)
        args[i] = batch
        return step(*args, **kw)

    return run


def _cache_rows_out(step: Callable, ctx) -> Callable:
    """The prefill ``step`` with the cache it builds on this rank's rows
    handed out on the cache's rows, as ``cache_specs`` cuts it: every leaf
    with a batch dim (dim 0 of the serving layout) through
    ``shardctx.rows_to_cache``."""

    def run(params, batch):
        logits, cache = step(params, batch)
        with _shard_scope(ctx):
            return logits, sh.map_with_path(
                lambda path, t: shardctx.rows_to_cache(t)
                if path[-1] in sh.BATCHED_CACHE else t,
                cache, is_leaf=lambda x: False)

    return run


def build_cell(cfg: ModelConfig, shape: ShapeSpec, mesh,
               rules: sh.AxisRules = sh.DEFAULT_RULES,
               optimizer: Optional[Optimizer] = None,
               microbatches: int = 1) -> CellProgram:
    """The sharded step, its arguments' specs and stand-ins for one cell
    (FSDP's gather once per step: see the module docstring).
    Building it is a collective of the whole world (the mesh's groups):
    every rank builds the same cells in the same order, a rank outside
    ``mesh`` included (its program refuses to run).  On a mesh with no
    ranks (``launch/mesh.py::make_abstract_mesh``) it builds no group:
    the program is rank 0's, with counting comms, for :meth:`CellProgram.
    lower`.  An MoE layer runs
    expert parallel over ``model`` and an RWKV6 layer head parallel
    (``models/mlp.py``, ``models/rwkv6.py``)."""
    pshape = params_shape(cfg)
    pspecs = sh.param_specs(cfg, pshape, mesh, rules)
    batch = input_specs(cfg, shape)
    bspecs = sh.batch_specs(cfg, mesh, batch, rules)
    notes: Dict[str, Any] = {
        "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
        "seq_len": shape.seq_len}
    ctx = shardctx.context_for(mesh, rules)

    if shape.kind == "train":
        optimizer = optimizer or get_optimizer(cfg)
        oshape = optimizer.init(pshape)
        ospecs = sh.opt_state_specs(cfg, oshape, pshape, mesh, rules)
        def make(c):
            return _whole_batch(make_train_step(
                cfg, optimizer, shard_ctx=c, microbatches=microbatches),
                c, bspecs, 2)

        return CellProgram("train", make(ctx), (pshape, oshape, batch),
                           (pspecs, ospecs, bspecs), notes, ctx, make)

    cshape = cache_shape(cfg, shape.global_batch, shape.seq_len)
    cspecs = sh.cache_specs(cfg, cshape, mesh, rules)
    b_ax = sh._batch_axes(mesh, rules, shape.global_batch)
    notes["out_shardings"] = (sh.P(b_ax, None), cspecs)
    if shape.kind == "prefill":
        def make(c):
            return _cache_rows_out(_whole_batch(make_prefill_step(
                cfg, max_len=shape.seq_len, shard_ctx=c), c, bspecs, 1), c)

        return CellProgram("prefill", make(ctx), (pshape, batch),
                           (pspecs, bspecs), notes, ctx, make)

    # decode: one new token against a seq_len-deep cache; each rank decodes
    # its rows of the tokens, against its rows of a cache that may hold
    # more (``shardctx.own_rows``)
    def make(c):
        return make_serve_step(cfg, shard_ctx=c, max_len=shape.seq_len)

    tok_spec = sh.P(b_ax, None)
    notes["out_shardings"] = (tok_spec, cspecs)
    return CellProgram("decode", make(ctx), (pshape, cshape, batch["tokens"]),
                       (pspecs, cspecs, tok_spec), notes, ctx, make)


def cell_is_supported(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """long_500k needs sub-quadratic sequence mixing (see DESIGN.md §5)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("full-attention arch: 512k dense-KV decode skipped "
                       "(DESIGN.md §5 Arch-applicability)")
    return True, ""
