"""Sharding rules: map every parameter / activation / cache tensor onto a
mesh (the JAX package's ``launch/sharding.py``), and cut or gather trees
of tensors by them.

Scheme (MaxText-flavored 2D "FSDP x TP"):
  * "model" axis  -- tensor parallelism: attention heads, FFN hidden dim,
    MoE expert dim, vocab dim, recurrent channel dim.
  * "data" axis   -- batch parallelism for activations AND fully-sharded
    (FSDP/ZeRO-3) parameter+optimizer-state storage along d_model.
  * "pod" axis    -- pure data parallelism across pods (params replicated).

Every rule is *guarded by divisibility*: an axis is applied to a tensor dim
only if the dim divides evenly (and, for attention-head dims, only if the
head count itself divides, so shards stay head-aligned).  Otherwise that
dim falls back to replication -- recorded by :func:`explain_shardings`.

The spec layer is pure Python on shapes and equals the reference entry
for entry: a spec is a :class:`P` (a tuple whose entries are ``None``, an
axis name or a tuple of axis names), specs are defined on the reference's
layout, with ``blocks`` stacked on a leading axis (``transformer.
stack_blocks``); a serving tree whose ``blocks`` is a list takes each
block's spec with that leading entry removed (:func:`for_layout`).

The torch side: :func:`local_shard` is this rank's slice of a full tensor
(an entry of several axes splits its dim with the first axis major, as
jax does), :func:`shard_tree` / :func:`gather_tree` move a whole tree
between full and local (the gather through ``GroupComm``'s collective
forms), and :func:`param_shardings` (the reference's ``to_named`` of the
parameter specs) pairs each spec with the mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import axis_size, mesh_coords

PyTree = Any

MeshAxes = Optional[Tuple[str, ...]]  # value of one logical axis


class P(tuple):
    """A partition spec: one entry per dim, ``None`` (replicated), an axis
    name, or a tuple of axis names (the first major)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __getnewargs__(self):          # pickles as P(*entries)
        return tuple(self)

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(e) for e in self) + ")"


@dataclasses.dataclass(frozen=True)
class AxisRules:
    """logical axis name -> mesh axes (None = replicate)."""
    embed: MeshAxes = ("data",)        # d_model dim of weights (FSDP)
    heads: MeshAxes = ("model",)       # fused q-heads dim
    kv_heads: MeshAxes = ("model",)    # fused kv-heads dim
    ffn: MeshAxes = ("model",)         # MLP hidden
    vocab_in: MeshAxes = ("model",)    # embedding-table vocab dim
    vocab_out: MeshAxes = ("model",)   # unembedding vocab dim
    expert: MeshAxes = ("model",)      # MoE expert dim
    ffn_moe: MeshAxes = None           # per-expert hidden (after expert split)
    lru: MeshAxes = ("model",)         # RG-LRU channel dim
    rwkv_out: MeshAxes = ("model",)    # RWKV projection output dim
    layers: MeshAxes = None            # stacked-layer dim of scanned blocks
    # activations
    act_batch: MeshAxes = ("pod", "data")  # filtered per-mesh automatically
    act_seq: MeshAxes = None           # sequence dim (sequence parallelism)
    act_embed: MeshAxes = None         # activation d_model dim
    act_heads: MeshAxes = ("model",)   # activation heads dim
    # kv-cache
    cache_batch: MeshAxes = ("pod", "data")
    cache_seq: MeshAxes = ("model",)   # context slots (decode memory)
    cache_heads: MeshAxes = None
    # ZeRO-1: optimizer state gets an extra shard axis beyond its param's
    zero1: MeshAxes = None

    def get(self, name: str) -> MeshAxes:
        return getattr(self, name)


DEFAULT_RULES = AxisRules()


# ---------------------------------------------------------------------------
# parameter rules: leaf name -> logical axes of its trailing dims.
# Leading (stacked-layer) dims get the `layers` logical axis (default: none).
# ---------------------------------------------------------------------------
_PARAM_LOGICAL: Dict[str, Tuple[Optional[str], ...]] = {
    # top level
    "embed": ("vocab_in", "embed"),
    "unembed": ("embed", "vocab_out"),
    # attention
    "wq": ("embed", "heads"),
    "wk": ("embed", "kv_heads"),
    "wv": ("embed", "kv_heads"),
    "wo": ("heads", "embed"),
    "bq": ("heads",),
    "bk": ("kv_heads",),
    "bv": ("kv_heads",),
    # dense MLP
    "w_gate": ("embed", "ffn"),
    "w_up": ("embed", "ffn"),
    "w_down": ("ffn", "embed"),
    # MoE (3-D expert-stacked weights override the dense names by ndim)
    "router": ("embed", None),
    # RG-LRU
    "w_in": ("embed", "lru"),
    "conv": (None, "lru"),
    "w_a": ("embed", "lru"),
    "w_x": ("embed", "lru"),
    "w_out": ("lru", "embed"),
    # RWKV6
    "wr": ("embed", "rwkv_out"),
    "wg": ("embed", "rwkv_out"),
    "mix_lora_a": ("embed", None),
    "cm_wk": ("embed", "ffn"),
    "cm_wv": ("ffn", "embed"),
    "cm_wr": ("embed", "rwkv_out"),
}
# names resolved by surrounding context
_MOE_LOGICAL: Dict[str, Tuple[Optional[str], ...]] = {
    "w_gate": ("expert", "embed", "ffn_moe"),
    "w_up": ("expert", "embed", "ffn_moe"),
    "w_down": ("expert", "ffn_moe", "embed"),
}
_RWKV_SHARED = {"wk": ("embed", "rwkv_out"), "wv": ("embed", "rwkv_out"),
                "wo": ("rwkv_out", "embed")}


def _names(mesh) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names or ())


def _head_counts(cfg: ModelConfig) -> Dict[str, int]:
    return {"heads": max(cfg.num_heads, 1), "kv_heads": max(cfg.num_kv_heads, 1)}


def _resolve(logical: Sequence[Optional[str]], shape: Tuple[int, ...], mesh,
             rules: AxisRules, cfg: ModelConfig,
             dropped: Optional[list] = None, path: str = "") -> P:
    """Turn trailing-dim logical axes into a full spec with guards."""
    n_lead = len(shape) - len(logical)
    spec: list = []
    lead_axes = rules.get("layers")
    for i in range(n_lead):
        spec.append(None if not lead_axes else _fit(
            shape[i], lead_axes, mesh, set(), None))
    used: set = {a for s in spec if s
                 for a in (s if isinstance(s, tuple) else (s,))}
    heads = _head_counts(cfg)
    for dim, name in zip(shape[n_lead:], logical, strict=False):
        if name is None:
            spec.append(None)
            continue
        axes = rules.get(name)
        if axes is None:
            spec.append(None)
            continue
        got = _fit(dim, axes, mesh, used, heads.get(name))
        if got is None and dropped is not None:
            dropped.append((path, name, dim, axes))
        spec.append(got)
        if got:
            used.update(got if isinstance(got, tuple) else (got,))
    return P(*spec)


def _fit(dim: int, axes: Tuple[str, ...], mesh, used: set,
         head_align: Optional[int]):
    """Largest prefix of `axes` that evenly divides `dim` (and head count)."""
    ok = []
    prod = 1
    for a in axes:
        if a not in _names(mesh) or a in used:
            continue
        n = axis_size(mesh, a)
        if n == 1:
            continue
        if dim % (prod * n) != 0:
            break
        if head_align is not None and head_align % (prod * n) != 0:
            break
        ok.append(a)
        prod *= n
    if not ok:
        return None
    return tuple(ok) if len(ok) > 1 else ok[0]


# ---------------------------------------------------------------------------
# trees: nested dicts / lists, leaves visited in jax.tree order (dict keys
# sorted), paths as the reference writes them ("blocks/sub0/mix/wq")
# ---------------------------------------------------------------------------
def _is_spec(x) -> bool:
    return isinstance(x, P)


def map_with_path(fn: Callable, tree, *rest, is_leaf=_is_spec,
                  path: Tuple = ()):
    """``fn(path, leaf, *rest_leaves)`` over ``tree`` (and trees of the same
    structure), visiting dict keys in sorted order; the result keeps each
    dict's own key order."""
    if isinstance(tree, dict) and not is_leaf(tree):
        out = {k: map_with_path(fn, tree[k], *[r[k] for r in rest],
                                is_leaf=is_leaf, path=path + (k,))
               for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, (list, tuple)) and not is_leaf(tree):
        return type(tree)(
            map_with_path(fn, t, *[r[i] for r in rest], is_leaf=is_leaf,
                          path=path + (i,))
            for i, t in enumerate(tree))
    return fn(path, tree, *rest)


def flat_with_path(tree, is_leaf=_is_spec) -> List[Tuple[Tuple, Any]]:
    """``[(path, leaf)]`` in jax.tree order."""
    out: list = []
    map_with_path(lambda p, x: out.append((p, x)), tree, is_leaf=is_leaf)
    return out


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(getattr(leaf, "shape", ()))


def path_str(path) -> str:
    return "/".join(str(k) for k in path)


# ---------------------------------------------------------------------------
# public API: specs
# ---------------------------------------------------------------------------
def param_specs(cfg: ModelConfig, params_shape: PyTree, mesh,
                rules: AxisRules = DEFAULT_RULES,
                dropped: Optional[list] = None) -> PyTree:
    """Spec tree matching ``params_shape`` (shape stand-ins, the
    reference's stacked layout)."""

    def visit(path, leaf):
        keys = list(path)
        name = keys[-1]
        shape = _shape(leaf)
        in_moe = cfg.is_moe and "ffn" in keys and "dense" not in keys
        if in_moe and name in _MOE_LOGICAL:
            logical = _MOE_LOGICAL[name]
        elif cfg.is_rwkv and name in _RWKV_SHARED:
            logical = _RWKV_SHARED[name]
        elif name in _PARAM_LOGICAL:
            logical = _PARAM_LOGICAL[name]
        else:
            # norms, biases, scalars, loras: replicate trailing dims
            logical = tuple(None for _ in shape)
        # guard: logical longer than shape (e.g. unstacked smoke shapes)
        logical = logical[-len(shape):] if shape else ()
        return _resolve(logical, shape, mesh, rules, cfg, dropped,
                        path_str(path))

    return map_with_path(visit, params_shape)


def param_shardings(cfg: ModelConfig, params_shape: PyTree, mesh,
                    rules: AxisRules = DEFAULT_RULES,
                    dropped: Optional[list] = None) -> PyTree:
    """``(mesh, spec)`` per leaf: the reference's ``NamedSharding`` tree
    of the parameter specs."""
    specs = param_specs(cfg, params_shape, mesh, rules, dropped)
    return map_with_path(lambda _p, s: (mesh, s), specs)


def zero1_extend(spec: P, shape, mesh, rules: AxisRules) -> P:
    """``spec`` with the rules' zero1 axes added to the first unsharded,
    divisible dim of ``shape`` (``spec`` as it is when the rules have
    none, padded to ``shape``'s rank when none fits)."""
    z = rules.get("zero1")
    if not z:
        return spec
    out = list(spec) + [None] * (len(shape) - len(spec))
    used = {a for s in out if s
            for a in (s if isinstance(s, tuple) else (s,))}
    for i, (dim, s) in enumerate(zip(shape, out, strict=False)):
        if s is not None:
            continue
        got = _fit(dim, z, mesh, used, None)
        if got is not None:
            out[i] = got
            return P(*out)
    return P(*out)


def opt_state_specs(cfg: ModelConfig, opt_shape: PyTree, params_shape: PyTree,
                    mesh, rules: AxisRules = DEFAULT_RULES) -> PyTree:
    """Optimizer-state specs: moments inherit their parameter's spec;
    Adafactor factored vectors inherit the spec minus the reduced dim;
    scalars replicate; each then extended by the zero1 axes
    (:func:`zero1_extend`)."""
    return state_specs_of(
        opt_shape, params_shape, param_specs(cfg, params_shape, mesh, rules),
        lambda spec, shape: zero1_extend(spec, shape, mesh, rules))


def state_specs_of(opt_shape: PyTree, params_shape: PyTree, pspecs: PyTree,
                   extend: Callable = lambda spec, shape: spec) -> PyTree:
    """The optimizer-state specs that :func:`opt_state_specs` derives from
    the parameter specs ``pspecs``, each passed through ``extend(spec,
    shape)`` (the identity: the state laid out as the parameters are)."""
    flat_p = {path: spec for path, spec in flat_with_path(pspecs)}
    flat_shapes = {path: _shape(leaf)
                   for path, leaf in flat_with_path(params_shape)}

    def match(keys, cand, shape):
        if cand not in flat_p:
            return None
        spec, pshape = flat_p[cand], flat_shapes[cand]
        if shape == pshape:
            return extend(spec, shape)
        if keys[-1] == "vr" and shape == pshape[:-1]:
            return extend(P(*spec[:-1]), shape)
        if keys[-1] == "vc" and shape == pshape[:-2] + pshape[-1:]:
            return extend(P(*(spec[:-2] + spec[-1:])), shape)
        return None

    def visit(path, leaf):
        keys = tuple(path)
        shape = _shape(leaf)
        if not shape:
            return P()
        # strip the state-kind prefix ('mu'/'nu'/'v'/'mom') to find the
        # param; vr/vc live one level deeper than the param name
        for cut in (0, 1):
            for start in range(len(keys)):
                got = match(keys, keys[start + 1:len(keys) - cut], shape)
                if got is not None:
                    return got
        return P(*(None for _ in shape))

    return map_with_path(visit, opt_shape)


# ---------------------------------------------------------------------------
# activations / batches / caches
# ---------------------------------------------------------------------------
def _batch_axes(mesh, rules: AxisRules, b: int,
                which: str = "act_batch") -> MeshAxes:
    axes = tuple(a for a in (rules.get(which) or ()) if a in _names(mesh))
    return _fit(b, axes, mesh, set(), None)


def batch_specs(cfg: ModelConfig, mesh, batch_shape: Dict[str, Any],
                rules: AxisRules = DEFAULT_RULES) -> Dict[str, P]:
    """Specs for a train/prefill/decode input batch dict."""
    out = {}
    for k, v in batch_shape.items():
        shape = _shape(v)
        b_ax = _batch_axes(mesh, rules, shape[0])
        trailing = [None] * (len(shape) - 1)
        if k == "embeds" and len(shape) == 3:
            trailing = [rules.get("act_seq") and _fit(
                shape[1], rules.get("act_seq"), mesh, set(), None), None]
        out[k] = P(b_ax, *trailing)
    return out


BATCHED_CACHE = ("k", "v", "h", "conv", "wkv", "tm_prev", "cm_prev")


def cache_specs(cfg: ModelConfig, cache_shape: PyTree, mesh,
                rules: AxisRules = DEFAULT_RULES) -> PyTree:
    """Decode-cache specs. Attention caches (stacked: (L, B, n, kv, hd)):
    batch over data axes, context slots over `cache_seq`; recurrent states
    (L, B, W)/(L, B, H, N, N): batch over data, channel/head over model.

    An axis the batch dim takes is not given to a later dim of the same
    cache (the slots, heads or channels): the reference's specs map it
    twice where ``cache_batch`` holds ``model`` (``fsdp_pure``), which jax
    refuses (``DuplicateSpecError``); under every other rule set the two
    agree."""
    batch = next((_shape(leaf)[1 if "blocks" in path else 0]
                  for path, leaf in flat_with_path(cache_shape)
                  if path[-1] in BATCHED_CACHE), None)
    used = set() if batch is None else set(entry_axes(
        _batch_axes(mesh, rules, batch, "cache_batch")))

    def visit(path, leaf):
        keys = list(path)
        name = keys[-1]
        shape = _shape(leaf)
        if not shape:
            return P()
        stacked = "blocks" in keys  # leading L dim present
        lead = 1 if stacked else 0
        spec: list = [None] * len(shape)
        if name in ("k", "v"):
            spec[lead] = _batch_axes(mesh, rules, shape[lead], "cache_batch")
            cs = rules.get("cache_seq")
            if cs:
                spec[lead + 1] = _fit(shape[lead + 1], cs, mesh, used, None)
            ch = rules.get("cache_heads")
            if ch:
                spec[lead + 2] = _fit(shape[lead + 2], ch, mesh, used,
                                      cfg.num_kv_heads)
        elif name == "slot_pos":
            cs = rules.get("cache_seq")
            if cs:
                spec[lead] = _fit(shape[lead], cs, mesh, used, None)
        elif name in BATCHED_CACHE:
            spec[lead] = _batch_axes(mesh, rules, shape[lead], "cache_batch")
            # trailing channel dim over model when divisible
            got = _fit(shape[-1], ("model",), mesh, used, None)
            if name == "wkv" and len(shape) > lead + 1:
                # (L, B, H, N, N): shard heads
                spec[lead + 1] = _fit(shape[lead + 1], ("model",), mesh,
                                      used, None)
            elif got is not None and len(shape) - 1 > lead:
                spec[-1] = got
        return P(*spec)

    return map_with_path(visit, cache_shape)


def explain_shardings(cfg: ModelConfig, params_shape: PyTree, mesh,
                      rules: AxisRules = DEFAULT_RULES) -> Dict[str, Any]:
    """Report what was sharded and what fell back to replication."""
    dropped: list = []
    specs = param_specs(cfg, params_shape, mesh, rules, dropped)
    total = 0
    sharded = 0
    for (_path, leaf), (_, spec) in zip(
            flat_with_path(params_shape), flat_with_path(specs),
            strict=True):
        n = 1
        for d in _shape(leaf):
            n *= d
        total += n
        sharded += n // shard_count(spec, mesh)
    return {
        "params_total": total,
        "params_per_device_max": sharded,
        "replicated_fallbacks": [
            {"path": p, "logical": n, "dim": d, "axes": list(a)}
            for p, n, d, a in dropped
        ],
    }


# ---------------------------------------------------------------------------
# the torch side: cut and gather by specs
# ---------------------------------------------------------------------------
def entry_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry, major first."""
    if not entry:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def spec_axes(spec) -> Tuple[str, ...]:
    """Every mesh axis a spec shards over."""
    return tuple(a for e in spec for a in entry_axes(e))


def shard_count(spec, mesh) -> int:
    n = 1
    for a in spec_axes(spec):
        n *= axis_size(mesh, a)
    return n


def entry_index(entry, mesh, coords: Dict[str, int]) -> Tuple[int, int]:
    """(this rank's chunk, number of chunks) of a dim split by ``entry``."""
    idx, n = 0, 1
    for a in entry_axes(entry):
        s = axis_size(mesh, a)
        idx = idx * s + coords[a]
        n *= s
    return idx, n


def local_shard(t: torch.Tensor, spec, mesh,
                coords: Optional[Dict[str, int]] = None) -> torch.Tensor:
    """This rank's slice of the full tensor ``t`` under ``spec`` (a view;
    ``coords`` default to this process's coordinates in ``mesh``)."""
    if not isinstance(t, torch.Tensor) or not spec:
        return t
    coords = mesh_coords(mesh) if coords is None else coords
    for dim, entry in enumerate(spec):
        idx, n = entry_index(entry, mesh, coords)
        if n == 1:
            continue
        if t.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                             f"into {n} for spec {spec}")
        c = t.shape[dim] // n
        t = t.narrow(dim, idx * c, c)
    return t


def for_layout(specs: PyTree, tree: PyTree) -> PyTree:
    """``specs`` (on the stacked layout) for ``tree``'s layout: where
    ``tree["blocks"]`` is a list of per-block dicts, each block's spec is
    the stacked spec with its leading entry removed."""
    if not isinstance(tree, dict) or not isinstance(tree.get("blocks"), list) \
            or isinstance(specs.get("blocks"), list):
        return specs
    per_block = map_with_path(lambda _p, s: P(*s[1:]), specs["blocks"])
    return dict(specs, blocks=[per_block for _ in tree["blocks"]])


def shard_tree(tree: PyTree, specs: PyTree, mesh,
               coords: Optional[Dict[str, int]] = None) -> PyTree:
    """This rank's shards of a full tree, as compact copies."""
    coords = mesh_coords(mesh) if coords is None else coords
    specs = for_layout(specs, tree)

    def cut(_p, spec, t):
        if not isinstance(t, torch.Tensor):
            return t
        s = local_shard(t, spec, mesh, coords)
        return s.clone(memory_format=torch.contiguous_format) \
            if s is not t else t

    return map_with_path(cut, specs, tree)


def gather_tree(tree: PyTree, specs: PyTree, mesh) -> PyTree:
    """The full tree from every rank's shards, on every rank of the mesh:
    each sharded dim all-gathered over its axes through the mesh's
    ``GroupComm`` collectives (``models/shardctx.py::context_for``, which
    builds the mesh's groups on first use -- a collective)."""
    from repro_torch.models import shardctx
    ctx = shardctx.context_for(mesh, DEFAULT_RULES)
    specs = for_layout(specs, tree)

    def full(_p, spec, t):
        if not isinstance(t, torch.Tensor):
            return t
        for dim, entry in enumerate(spec):
            axes = entry_axes(entry)
            if shard_count(P(entry), mesh) > 1:
                t = ctx.gather(t, dim, axes)
        return t

    return map_with_path(full, specs, tree)
