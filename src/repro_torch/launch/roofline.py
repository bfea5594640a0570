"""Roofline analysis of one cell's counted step (the JAX package's
``launch/roofline.py``, priced on ``launch/hw.py``'s H100).

Three terms per (arch x shape x mesh) cell, all in seconds for one rank
(lower = the floor set by that resource):

  compute    = sum over dtypes of flops / that dtype's peak
  memory     = bytes / HBM_BW
  collective = wire bytes per GPU over NVLink / NVLINK_BW
             + wire bytes per GPU over the network / NETWORK_BW

The counts come from ``launch/steps.py::CellProgram.lower``, which runs
rank 0's step on ``meta`` stand-ins; there is no XLA program here, so the
reference's HLO readers (``parse_collectives``, ``shape_bytes``) have no
counterpart, and the counting comm's records (``models/shardctx.py::
CountingComm``) take their place.

* flops: ``torch.utils.flop_counter.FlopCounterMode`` over the aten ops
  (matrix products and convolutions; elementwise work is not counted),
  plus the hand-written kernels' own formulas (their ``cost()``), each
  kept by the dtype it is computed in and priced at that dtype's peak
  (:func:`peak_flops`: bf16 / f16 on the tensor cores, f32 outside them,
  as PyTorch runs f32 products without TF32 by default).
* bytes: per aten op, its tensor inputs read plus its outputs written,
  with views and fresh allocations free and an indexed in-place write
  counted as its slice; plus the kernels' formulas.  That is what the
  eager program moves, op by op and unfused, and it is not comparable
  with XLA's fused ``bytes accessed``.  The bound therefore depends on
  how the program is split into ops: fusing two ops lowers it along with
  the time, so it measures a program against itself.  A share that
  holds across programs is :func:`mfu`, the model's flops over the
  measured step at the bf16 peak.
* collectives: each call of the rank's groups, with ring wire formulas per
  op:

  all-reduce          2 (n-1)/n * bytes     (reduce-scatter + all-gather)
  all-gather            (n-1)/n * result bytes
  reduce-scatter        (n-1)   * result bytes (the scattered shard)
  all-to-all            (n-1)/n * bytes
  collective-permute              bytes

  each priced by the link its group crosses: NVLink when every rank of
  the group shares a node of ``GPUS_PER_NODE``, the network otherwise.

MODEL_FLOPS = 6 N D (train) / 2 N D (forward-only), N = active params --
the usefulness ratio MODEL_FLOPS/flops exposes remat and redundant
compute.  ``roofline_fraction`` (the reference's key) is the model's
flops at the bf16 peak over the step's lower bound.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.launch import hw as hw_h100

LINKS = ("nvlink", "network")


@dataclasses.dataclass
class CollectiveOp:
    op: str
    result_bytes: int
    group_size: int
    count: int = 1

    def wire_bytes_per_chip(self) -> float:
        """Ring-collective bytes each chip must push over its link."""
        n = max(self.group_size, 1)
        b = self.result_bytes
        if n == 1:
            return 0.0
        if self.op.startswith("all-reduce"):
            return 2.0 * (n - 1) / n * b
        if self.op.startswith("all-gather"):
            return (n - 1) / n * b
        if self.op.startswith("reduce-scatter"):
            # result is the scattered shard; operand was n x larger
            return (n - 1) * b
        if self.op.startswith(("all-to-all", "ragged-all-to-all")):
            return (n - 1) / n * b
        if self.op.startswith("collective-permute"):
            return float(b)
        return float(b)


def link_of(ranks: Sequence[int], hw=hw_h100) -> str:
    """"nvlink" when every rank of a group (row-major mesh positions, a
    node holding ``hw.GPUS_PER_NODE`` consecutive ones) shares a node,
    else "network"."""
    return "nvlink" if len({int(r) // hw.GPUS_PER_NODE
                            for r in ranks}) == 1 else "network"


def aggregate(calls, hw=hw_h100) -> Tuple[List[CollectiveOp], List[str]]:
    """Merge a counting comm's calls (``models/shardctx.py::CommCall``s,
    in call order) into one ``CollectiveOp`` per (op, result bytes, group
    size, link) with its count; returns the ops and their links."""
    agg: Dict[tuple, CollectiveOp] = {}
    for c in calls:
        key = (c.op, c.result_bytes, c.group_size, link_of(c.ranks, hw))
        if key in agg:
            agg[key].count += 1
        else:
            agg[key] = CollectiveOp(c.op, c.result_bytes, c.group_size)
    return list(agg.values()), [k[3] for k in agg]


def collective_summary(ops: List[CollectiveOp],
                       links: Optional[Sequence[str]] = None
                       ) -> Dict[str, Any]:
    """The reference's summary of ``ops``; with ``links`` (one per op)
    also ``by_link``, the wire bytes per GPU on each link."""
    by_op: Dict[str, Dict[str, float]] = defaultdict(
        lambda: {"count": 0, "result_bytes": 0, "wire_bytes_per_chip": 0.0})
    for c in ops:
        d = by_op[c.op]
        d["count"] += c.count
        d["result_bytes"] += c.result_bytes * c.count
        d["wire_bytes_per_chip"] += c.wire_bytes_per_chip() * c.count
    total_wire = sum(d["wire_bytes_per_chip"] for d in by_op.values())
    total_result = sum(d["result_bytes"] for d in by_op.values())
    out = {"by_op": dict(by_op), "wire_bytes_per_chip": total_wire,
           "result_bytes": total_result,
           "n_ops": sum(d["count"] for d in by_op.values())}
    if links is not None:
        by_link = {k: 0.0 for k in LINKS}
        for c, link in zip(ops, links, strict=True):
            by_link[link] += c.wire_bytes_per_chip() * c.count
        out["by_link"] = by_link
    return out


# ---------------------------------------------------------------------------
# MODEL_FLOPS
# ---------------------------------------------------------------------------
def model_flops(cfg, shape) -> float:
    """6 N D for training, 2 N D forward-only; N = active params,
    D = tokens processed by the step."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch


# ---------------------------------------------------------------------------
# the three terms
# ---------------------------------------------------------------------------
def collective_seconds(collectives: Dict[str, Any], hw=hw_h100) -> float:
    """Wire bytes over their links' rates; a summary without ``by_link``
    is priced at ``NVLINK_BW`` (every group inside a node)."""
    by_link = collectives.get("by_link")
    if by_link is None:
        return collectives["wire_bytes_per_chip"] / hw.NVLINK_BW
    return (by_link.get("nvlink", 0.0) / hw.NVLINK_BW
            + by_link.get("network", 0.0) / hw.NETWORK_BW)


def peak_flops(dtype: str, hw=hw_h100) -> float:
    """The peak rate of products in ``dtype`` (``"bfloat16"``, ...): f32
    at ``PEAK_FLOPS_F32``, any other at ``PEAK_FLOPS_BF16`` (the fastest
    the table prices, so the bound stays a bound)."""
    return hw.PEAK_FLOPS_F32 if dtype == "float32" else hw.PEAK_FLOPS_BF16


def compute_seconds(cost: Dict[str, Any], hw=hw_h100) -> float:
    """Flops over their dtypes' peaks; a cost without ``"flops by
    dtype"`` (the reference's) is priced at ``PEAK_FLOPS_BF16``."""
    by_dtype = cost.get("flops by dtype")
    if by_dtype is None:
        return float(cost.get("flops", 0.0)) / hw.PEAK_FLOPS_BF16
    return sum(float(f) / peak_flops(d, hw) for d, f in by_dtype.items())


def mfu(mflops: float, seconds: float, n_chips: int = 1,
        hw=hw_h100) -> float:
    """Model-flops share of a measured step: ``mflops`` (:func:`
    model_flops`) over ``seconds`` at ``n_chips`` bf16 peaks."""
    return mflops / (n_chips * hw.PEAK_FLOPS_BF16 * seconds)


def roofline(cost: Dict[str, Any], collectives: Dict[str, Any],
             n_chips: int, mflops: float, hw=hw_h100) -> Dict[str, Any]:
    """The three terms of one rank's counted step (``cost`` and
    ``collectives`` are per rank), its dominant term, the usefulness ratio
    and the model-flops share of the step's lower bound."""
    flops = float(cost.get("flops", 0.0))
    nbytes = float(cost.get("bytes accessed", 0.0))
    compute_s = compute_seconds(cost, hw)
    memory_s = nbytes / hw.HBM_BW
    collective_s = collective_seconds(collectives, hw)
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dominant = max(terms, key=terms.get)
    step_s = max(terms.values())
    ideal_s = mflops / (n_chips * hw.PEAK_FLOPS_BF16)
    return {
        **terms,
        "dominant": dominant,
        "model_flops": mflops,
        "hlo_flops": flops,
        "hlo_bytes": nbytes,
        "useful_ratio": (mflops / (flops * n_chips)
                         if flops else 0.0),
        "roofline_fraction": ideal_s / step_s if step_s else 0.0,
        "step_time_lower_bound_s": step_s,
    }
