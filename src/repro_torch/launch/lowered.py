"""One rank's step counted on ``meta`` stand-ins: the port's counterpart of
a lowered XLA program's ``cost_analysis()`` / ``memory_analysis()`` and
collective list (``launch/steps.py::CellProgram.lower`` makes one).

:func:`count_step` runs ``fn(*args)`` once on meta tensors under three
counters together:

* :class:`DtypeFlops`, a ``torch.utils.flop_counter.FlopCounterMode`` --
  the flops of matrix products and convolutions, forward and backward,
  also split by the dtype of each product's first operand (a roofline
  prices bf16 and f32 products at different peaks);
* :class:`OpBytes` -- a ``TorchDispatchMode`` that adds, per aten op, the
  bytes of its tensor inputs and outputs (views and fresh allocations
  free; an indexed in-place write moves its slice, not its destination),
  and follows every storage an op allocates until it is freed, for the
  peak of live bytes;
* ``kernels/counting.py`` -- the hand-written kernels' wrappers add their
  own ``cost()`` (flops under the dtype they compute in) and launches by
  shape;

and the counting comm of the step's shard context (``models/shardctx.py``)
records the collectives.
"""
from __future__ import annotations

import dataclasses
import math
import time
import weakref
from collections import defaultdict
from typing import Any, Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.kernels import counting
from repro_torch.launch import roofline as rf

_FREE_OPS = ("empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided")
# in-place writes through an index: (the source's argument, whether the
# slice is read too)
_SLICE_WRITES = {"index_put_": ("values", False),
                 "_index_put_impl_": ("values", False),
                 "index_copy_": ("source", False),
                 "index_add_": ("source", True),
                 "scatter_": ("index", False),
                 "scatter_add_": ("index", True),
                 "scatter_reduce_": ("index", True)}


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def storage_bytes(tree) -> int:
    """Bytes of the distinct storages of the tensors in ``tree``."""
    seen = {}
    for t in _tensors(tree):
        seen[_key(t)] = t.untyped_storage().nbytes()
    return sum(seen.values())


def _is_view(func) -> bool:
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)


def _slice_numel(name: str, args, kwargs) -> int:
    """Elements an indexed in-place write (``_SLICE_WRITES``) writes: its
    source's, or for ``index_put_`` the indices' broadcast times the dims
    they leave whole (the values' own count where a mask indexes)."""
    src, _ = _SLICE_WRITES[name]
    if src == "values":
        dest, indices = args[0], args[1]
        values = args[2] if len(args) > 2 else kwargs["values"]
        idx = [t for t in indices if t is not None]
        if any(t.dtype in (torch.bool, torch.uint8) for t in idx):
            return values.numel()
        whole = [d for d, t in zip(dest.shape, list(indices)
                                   + [None] * dest.dim()) if t is None]
        return math.prod(torch.broadcast_shapes(*(t.shape for t in idx))) \
            * math.prod(whole)
    pos = {"source": 3, "index": 2}[src]
    t = args[pos] if len(args) > pos else kwargs[src]
    return t.numel()


def _op_bytes(func, args, kwargs, outs) -> int:
    """Bytes one aten op moves: its tensor inputs read and outputs
    written, an indexed in-place write (``_SLICE_WRITES``) counting its
    destination as the slice written (and read, where it accumulates)."""
    name = func.overloadpacket.__name__
    if name not in _SLICE_WRITES:
        return sum(t.numel() * t.element_size()
                   for t in _tensors((args, kwargs)) + outs)
    dest = args[0]
    n = _slice_numel(name, args, kwargs) * dest.element_size()
    rest = _tensors((args[1:], kwargs))
    return sum(t.numel() * t.element_size() for t in rest) \
        + n * (2 if _SLICE_WRITES[name][1] else 1)


class DtypeFlops(FlopCounterMode):
    """``FlopCounterMode`` whose count is also kept by the dtype of each
    counted op's first tensor operand: ``by_dtype`` (``"bfloat16"``,
    ``"float32"``, ...)."""

    def __init__(self):
        super().__init__(display=False)
        self.by_dtype: Dict[str, int] = defaultdict(int)

    def _count_flops(self, func_packet, out, args, kwargs):
        before = self.get_total_flops()
        out = super()._count_flops(func_packet, out, args, kwargs)
        n = self.get_total_flops() - before
        if n:
            first = _tensors((args, kwargs))[0]
            self.by_dtype[counting.dtype_name(first.dtype)] += n
        return out


class OpBytes(TorchDispatchMode):
    """Bytes per aten op (:func:`_op_bytes`; a view or an ``empty*``
    allocation moves none) and the live bytes of the storages ops
    allocate: ``bytes``, ``live``, ``peak``.  Storages of tensors made
    before the mode (``known``) are not followed."""

    def __init__(self, known=()):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._known = set(known)
        self._owned: Dict[int, int] = {}

    def _free(self, key: int) -> None:
        self.live -= self._owned.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = _tensors(out)
        if not _is_view(func) and \
                func.overloadpacket.__name__ not in _FREE_OPS:
            self.bytes += _op_bytes(func, args, kwargs or {}, outs)
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in self._owned or key in self._known:
                continue
            n = st.nbytes()
            self._owned[key] = n
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key)
        return out


@dataclasses.dataclass
class MemoryAnalysis:
    """XLA's ``memory_analysis()`` fields, for one rank's step: the
    arguments, the outputs newly allocated, the outputs that are
    arguments (updated in place), and the temporaries live at the peak
    beside the outputs; ``peak_bytes`` = arguments + the peak of live
    allocations."""
    argument_size_in_bytes: int
    output_size_in_bytes: int
    alias_size_in_bytes: int
    temp_size_in_bytes: int
    peak_bytes: int


@dataclasses.dataclass
class LoweredCell:
    """What :func:`count_step` counted.  ``flops`` and ``bytes`` include the
    kernels' (``kernel_flops``, ``kernel_bytes``), ``flops_by_dtype``
    splits ``flops`` by the dtype they are computed in; ``launches`` is
    the kernels' counted launches by shape; ``calls`` the counting
    comm's records in call order."""
    flops: int
    bytes: int
    flops_by_dtype: Dict[str, int]
    kernel_flops: int
    kernel_bytes: int
    launches: Dict[str, Dict[tuple, int]]
    memory: MemoryAnalysis
    calls: list
    seconds: float
    notes: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def cost_analysis(self) -> Dict[str, float]:
        return {"flops": float(self.flops),
                "bytes accessed": float(self.bytes),
                "flops by dtype": {k: float(v) for k, v in
                                   self.flops_by_dtype.items()}}

    def memory_analysis(self) -> MemoryAnalysis:
        return self.memory

    def collectives(self) -> List[rf.CollectiveOp]:
        """The collectives merged by (op, result bytes, group size, link),
        each with its count (the reference's ``parse_collectives``)."""
        return rf.aggregate(self.calls)[0]

    def collective_summary(self) -> Dict[str, Any]:
        """``roofline.collective_summary`` with each op's link."""
        return rf.collective_summary(*rf.aggregate(self.calls))


def count_step(fn, args, ctx=None) -> LoweredCell:
    """Run ``fn(*args)`` once on meta tensors and count it (module
    docstring).  ``ctx`` is the step's counting shard context, whose
    collectives the result takes (none without one)."""
    known = {_key(t) for t in _tensors(args)}
    t0 = time.perf_counter()
    with counting.counting() as kc, \
            DtypeFlops() as fc, OpBytes(known) as ob:
        out = fn(*args)
    seconds = time.perf_counter() - t0
    arg_bytes = storage_bytes(args)
    new_out, alias = {}, {}
    for t in _tensors(out):
        (alias if _key(t) in known else new_out)[_key(t)] = \
            t.untyped_storage().nbytes()
    output_bytes = sum(new_out.values())
    memory = MemoryAnalysis(
        argument_size_in_bytes=arg_bytes,
        output_size_in_bytes=output_bytes,
        alias_size_in_bytes=sum(alias.values()),
        temp_size_in_bytes=max(ob.peak - output_bytes, 0),
        peak_bytes=arg_bytes + ob.peak)
    calls = list(ctx.collectives) if ctx is not None else []
    by_dtype = defaultdict(int, fc.by_dtype)
    for k, v in kc.flops_by_dtype.items():
        by_dtype[k] += v
    return LoweredCell(
        flops=fc.get_total_flops() + kc.flops, bytes=ob.bytes + kc.bytes,
        flops_by_dtype=dict(sorted(by_dtype.items())),
        kernel_flops=kc.flops, kernel_bytes=kc.bytes,
        launches=kc.by_shape(), memory=memory, calls=calls,
        seconds=seconds)
