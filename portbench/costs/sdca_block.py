"""The least work of one ``sdca_block`` launch (``csrc/sdca_block.cu``):
B configs x K leaves, each leaf running H sequential coordinate steps over
its block of m_b rows of d float32 features.

A frozen copy of ``kernels/sdca/kernel.py::cost`` in the port, so that a
later change of the kernel's file moves no share this benchmark reports,
plus :func:`expected_rows`, the distinct rows the draws of one launch name.
"""
from __future__ import annotations

from typing import Tuple

from portbench.costs import h100


def cost(rows: float, B: int, K: int, m_b: int, d: int, H: int
         ) -> Tuple[float, float]:
    """(flops, bytes) of the least work of one launch: ``rows`` distinct
    sampled rows (summed over the leaves) read once, y read once, each
    config's alpha, xsq and delta-alpha and its w and delta-w read or
    written once, the draws and the step mask read once; 4 flops per row
    element per step (the dot product and the update of w)."""
    nbytes = rows * d * 4 + K * m_b * 4 + B * K * (3 * m_b + 2 * d) * 4 \
        + B * K * H * 8
    return 4.0 * B * K * H * d, nbytes


def expected_rows(K: int, m_b: int, draws: float) -> float:
    """The expected number of distinct rows of K leaves of m_b rows each
    when every leaf draws ``draws`` row indices uniformly with replacement
    (the union over the configs of a launch that reads them)."""
    return K * m_b * (1.0 - (1.0 - 1.0 / m_b) ** draws)


def least_seconds(shape: dict) -> float:
    """The least time of one launch of ``shape`` (``B``, ``K``, ``m_b``,
    ``d``, ``H`` and the ``draws`` whose distinct rows it reads) at the
    H100 peaks: bytes or flops, whichever bounds."""
    rows = expected_rows(shape["K"], shape["m_b"], shape["draws"])
    flops, nbytes = cost(rows, shape["B"], shape["K"], shape["m_b"],
                         shape["d"], shape["H"])
    return h100.least_seconds(flops, nbytes)
