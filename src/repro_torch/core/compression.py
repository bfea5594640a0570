"""Delta compression for slow tree edges, with error feedback (the CoCoA
communication-efficiency lineage, arXiv:1409.1458 / arXiv:1711.05305).

The JAX package's ``core/compression.py``, scheme for scheme:

  * int8 blockwise quantization (32-element blocks along the last axis,
    absmax scaling): 4x fewer bytes than f32 on the wire;
  * top-k magnitude sparsification: the k largest-|.| entries of each row
    survive.

Both come as plain torch ops: the executors' shape-static roundtrips
(:func:`int8_roundtrip`, :func:`topk_roundtrip`: compress then decompress
in one call, the receiver's view of a compressed edge) and the pytree
:class:`Compressor` API over dicts and lists of tensors.  Two points are
held to the reference as it runs, under ``jit``:

  * the block scale is ``amax * float32(1/127)``: XLA rewrites the
    source's ``amax / 127.0`` into that multiply, which differs in the
    last ulp for some blocks (and so in every dequantized value of such a
    block), while the codes agree either way;
  * top-k ties go to the lower index, as ``jax.lax.top_k`` breaks them:
    the selection is a stable descending sort of ``|x|``
    (``torch.topk`` promises no order among equal values).

Edge specs are strings: ``"none"``, ``"int8"``, ``"topk"`` (default
fraction) or ``"topk_<frac>"``; :func:`parse_spec` normalizes them to the
``(kind, frac)`` pairs the plan IR stores per (depth, leaf).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Tensor = torch.Tensor
PyTree = Any

BLOCK = 32

# kind codes stored in the plan IR's (D, n) ``compress_kind`` array
KIND_NONE = 0
KIND_INT8 = 1
KIND_TOPK = 2

DEFAULT_TOPK_FRAC = 0.01

# wire bytes / f32 bytes: int8 codes + one f32 absmax scale per BLOCK
INT8_RATIO = 0.25 + 4.0 / BLOCK / 4.0

# the block scale's factor, as XLA folds the reference's "/ 127.0"
_INV127 = np.float32(1.0) / np.float32(127.0)


# ---------------------------------------------------------------------------
# spec parsing: "none" | "int8" | "topk" | "topk_<frac>" -> (kind, frac)
# ---------------------------------------------------------------------------
def parse_spec(spec) -> Tuple[int, float]:
    """Normalize an edge-compression spec to ``(kind, frac)``.  Accepts
    ``None`` (no compression), the registry names, ``"topk_<frac>"``, or an
    already-parsed ``(kind, frac)`` pair."""
    if spec is None or spec == "" or spec == "none":
        return KIND_NONE, 0.0
    if isinstance(spec, tuple):
        kind, frac = int(spec[0]), float(spec[1])
        if kind not in (KIND_NONE, KIND_INT8, KIND_TOPK):
            raise ValueError(f"unknown compression kind code {kind}")
        return kind, frac
    if not isinstance(spec, str):
        raise TypeError(f"compression spec must be a string, got {spec!r}")
    if spec == "int8":
        return KIND_INT8, 0.0
    if spec == "topk":
        return KIND_TOPK, DEFAULT_TOPK_FRAC
    if spec.startswith("topk_"):
        frac = float(spec[len("topk_"):])
        if not 0.0 < frac <= 1.0:
            raise ValueError(f"top-k fraction must be in (0, 1], got {frac}")
        return KIND_TOPK, frac
    raise ValueError(
        f"unknown compression spec {spec!r}; use 'none', 'int8', 'topk' "
        "or 'topk_<frac>'")


def spec_name(kind: int, frac: float = 0.0) -> str:
    """The canonical string form of a ``(kind, frac)`` pair."""
    if kind == KIND_NONE:
        return "none"
    if kind == KIND_INT8:
        return "int8"
    if kind == KIND_TOPK:
        return f"topk_{frac:g}"
    raise ValueError(f"unknown compression kind code {kind}")


def wire_ratio(kind: int, frac: float = 0.0) -> float:
    """Wire bytes / f32 bytes of one compressed message: the factor the
    delay model scales an edge's bandwidth term by.  Top-k ships (value,
    index) pairs: 2 * frac."""
    if kind == KIND_NONE:
        return 1.0
    if kind == KIND_INT8:
        return INT8_RATIO
    if kind == KIND_TOPK:
        return min(2.0 * frac, 1.0)
    raise ValueError(f"unknown compression kind code {kind}")


def quality(kind: int, frac: float = 0.0) -> float:
    """A modeling knob in (0, 1]: how much of one round's eq.-(11)
    improvement a compressed aggregation retains; the delay planner
    (``core/delay.py::choose_compression``) trades it against the cheaper
    round.  int8 is nearly lossless per round, top-k degrades with
    sparsity."""
    if kind == KIND_NONE:
        return 1.0
    if kind == KIND_INT8:
        return 0.95
    if kind == KIND_TOPK:
        return min(max(frac, 1e-6), 1.0) ** 0.5
    raise ValueError(f"unknown compression kind code {kind}")


# ---------------------------------------------------------------------------
# int8 blockwise
# ---------------------------------------------------------------------------
def quantize_int8(x: Tensor, keep_leading: int = 0) -> Tuple[Tensor, Tensor]:
    """x (float) -> (int8 codes, f32 block scales).  Blocks along the last
    dim; ``keep_leading`` keeps that many leading dims un-flattened (one
    message per row of a per-leaf ``(n, d)`` stack)."""
    lead = tuple(x.shape[:keep_leading])
    flat = x.float().reshape(lead + (-1,))
    flat = F.pad(flat, (0, (-flat.shape[-1]) % BLOCK))
    blocks = flat.reshape(lead + (-1, BLOCK))
    scale = blocks.abs().amax(dim=-1, keepdim=True) * _INV127
    codes = torch.round(blocks / torch.clamp(scale, min=1e-12))
    return codes.to(torch.int8), scale[..., 0]


def dequantize_int8(codes: Tensor, scale: Tensor, shape, dtype,
                    keep_leading: int = 0) -> Tensor:
    shape = tuple(shape)
    flat = (codes.to(scale.dtype) * scale[..., None]).reshape(
        shape[:keep_leading] + (-1,))
    n = int(np.prod(shape[keep_leading:], dtype=np.int64))
    return flat[..., :n].reshape(shape).to(dtype)


def int8_residual(target: Tensor, codes: Tensor, scale: Tensor,
                  keep_leading: int = 0) -> Tensor:
    """``target - dequantize(codes, scale)`` rounded once, as XLA computes
    it in the reference's jitted compressors: it contracts the dequantizing
    multiply and the subtraction into one fused multiply-add.  The float64
    product of an int8 code and a float32 scale is exact, so the float64
    difference rounded to float32 is that fused result."""
    exact = dequantize_int8(codes.double(), scale.double(), target.shape,
                            torch.float64, keep_leading=keep_leading)
    return (target.double() - exact).float()


def int8_roundtrip(x: Tensor, keep_leading: int = 0) -> Tensor:
    """What the receiver reconstructs from an int8-quantized ``x``:
    quantize + dequantize (shape- and dtype-preserving), the executors'
    model of the compressed edge."""
    codes, scale = quantize_int8(x, keep_leading=keep_leading)
    return dequantize_int8(codes, scale, x.shape, x.dtype,
                           keep_leading=keep_leading)


# ---------------------------------------------------------------------------
# top-k sparsification
# ---------------------------------------------------------------------------
def topk_count(size: int, frac: float) -> int:
    """The k for a ``frac`` sparsification of a ``size`` vector: at least
    one entry (so tiny arrays still make progress), never more than the
    array holds."""
    if size <= 0:
        return 0
    return min(max(int(size * frac), 1), size)


def topk_indices(x: Tensor, k: int) -> Tensor:
    """Indices of the ``k`` largest-|.| entries along the last axis, in
    descending order of magnitude, ties to the lower index (the order of
    ``jax.lax.top_k``): a stable descending sort."""
    order = torch.sort(x.abs(), dim=-1, descending=True, stable=True)[1]
    return order[..., :k]


def topk_sparsify(x: Tensor, frac: float) -> Tuple[Tensor, Tensor]:
    """Keep the ``frac`` largest-magnitude entries of ``x`` (flattened).
    Returns (f32 values, int32 indices); k is clamped to [1, size] (empty
    inputs return empty pairs)."""
    flat = x.float().reshape(-1)
    k = topk_count(flat.numel(), frac)
    if k == 0:
        return flat, torch.zeros((0,), dtype=torch.int32, device=x.device)
    idx = topk_indices(flat, k)
    return flat[idx], idx.to(torch.int32)


def topk_densify(vals: Tensor, idx: Tensor, shape, dtype) -> Tensor:
    n = int(np.prod(tuple(shape), dtype=np.int64))
    flat = torch.zeros(n, dtype=torch.float32, device=vals.device)
    flat[idx.long()] = vals.float()
    return flat.reshape(tuple(shape)).to(dtype)


def topk_roundtrip(x: Tensor, k: int) -> Tensor:
    """What the receiver reconstructs from a top-``k`` sparsification of
    each ROW of ``x`` (last axis): the k largest-|.| entries survive, the
    rest are zeroed."""
    k = min(max(int(k), 1), x.shape[-1])
    idx = topk_indices(x, k)
    return torch.zeros_like(x).scatter_(-1, idx, x.gather(-1, idx))


# ---------------------------------------------------------------------------
# error-feedback compressor over trees of tensors (dicts, lists, tuples)
# ---------------------------------------------------------------------------
def _map(fn: Callable, tree: PyTree, *rest: PyTree,
         is_leaf: Callable = lambda t: False):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), keeping the dict / list / tuple structure."""
    if is_leaf(tree) or not isinstance(tree, (dict, list, tuple)):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k], *(r[k] for r in rest), is_leaf=is_leaf)
                for k in tree}
    out = [_map(fn, t, *(r[i] for r in rest), is_leaf=is_leaf)
           for i, t in enumerate(tree)]
    return type(tree)(out) if isinstance(tree, tuple) else out


def _unzip(tree: PyTree, pairs: PyTree):
    """Split a tree of ``(a, b)`` leaf pairs (shaped like ``tree``) into
    two trees."""
    return (_map(lambda t, p: p[0], tree, pairs),
            _map(lambda t, p: p[1], tree, pairs))


@dataclasses.dataclass(frozen=True)
class Compressor:
    """compress(delta + residual) -> (wire, new_residual); decompress(wire).

    Subclasses are plain frozen dataclasses; ``name`` and ``ratio`` (wire
    bytes / f32 bytes, for the delay model) are derived fields each
    subclass pins in ``__post_init__``."""
    name: str = dataclasses.field(init=False, default="none")
    ratio: float = dataclasses.field(init=False, default=1.0)

    def init_residual(self, tree: PyTree) -> PyTree:
        return _map(lambda t: torch.zeros(t.shape, dtype=torch.float32,
                                          device=t.device), tree)

    def compress(self, tree: PyTree, residual: PyTree
                 ) -> Tuple[PyTree, PyTree]:
        raise NotImplementedError

    def decompress(self, wire: PyTree) -> PyTree:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class NoCompression(Compressor):
    def __post_init__(self):
        object.__setattr__(self, "name", "none")
        object.__setattr__(self, "ratio", 1.0)

    def compress(self, tree, residual):
        return tree, residual

    def decompress(self, wire):
        return wire


@dataclasses.dataclass(frozen=True)
class Int8Compressor(Compressor):
    def __post_init__(self):
        object.__setattr__(self, "name", "int8")
        object.__setattr__(self, "ratio", INT8_RATIO)

    def compress(self, tree, residual):
        def one(t, r):
            target = t.float() + r
            codes, scale = quantize_int8(target)
            return ({"codes": codes, "scale": scale,
                     "shape": tuple(t.shape), "dtype": t.dtype},
                    int8_residual(target, codes, scale))
        return _unzip(tree, _map(one, tree, residual))

    def decompress(self, wire):
        return _map(
            lambda m: dequantize_int8(m["codes"], m["scale"], m["shape"],
                                      m["dtype"]),
            wire, is_leaf=lambda x: isinstance(x, dict) and "codes" in x)


@dataclasses.dataclass(frozen=True)
class TopKCompressor(Compressor):
    frac: float = DEFAULT_TOPK_FRAC

    def __post_init__(self):
        if not 0.0 < self.frac <= 1.0:
            raise ValueError(
                f"top-k fraction must be in (0, 1], got {self.frac}")
        object.__setattr__(self, "name", f"topk_{self.frac:g}")
        object.__setattr__(self, "ratio", min(2.0 * self.frac, 1.0))

    def compress(self, tree, residual):
        def one(t, r):
            target = t.float() + r
            vals, idx = topk_sparsify(target, self.frac)
            approx = topk_densify(vals, idx, t.shape, torch.float32)
            return ({"vals": vals, "idx": idx,
                     "shape": tuple(t.shape), "dtype": t.dtype},
                    target - approx)
        return _unzip(tree, _map(one, tree, residual))

    def decompress(self, wire):
        return _map(
            lambda m: topk_densify(m["vals"], m["idx"], m["shape"],
                                   m["dtype"]),
            wire, is_leaf=lambda x: isinstance(x, dict) and "vals" in x)


COMPRESSORS = {
    "none": NoCompression,
    "int8": Int8Compressor,
    "topk": TopKCompressor,
}


def get_compressor(spec) -> Compressor:
    """Instantiate a :class:`Compressor` from an edge spec string
    (``"none"`` / ``"int8"`` / ``"topk"`` / ``"topk_<frac>"``)."""
    kind, frac = parse_spec(spec)
    if kind == KIND_TOPK:
        return TopKCompressor(frac)
    return COMPRESSORS[spec_name(kind)]()

