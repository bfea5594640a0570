"""The kernels' counting route: what a wrapper does when its inputs lie on
the ``meta`` device.

A cost count (``launch/steps.py::CellProgram.lower``) runs a step on meta
stand-ins.  There a kernel wrapper launches nothing: it adds the launch
by shape and its cost formula's flops (under the dtype the kernel computes
in) and bytes to every open :class:`KernelCount`, and returns an empty meta output of the right shape
and dtype.  It touches none of its own counters (``LAUNCHES``,
``LAUNCHES_BY_SHAPE``): those count kernels launched on the card.  On ``cuda`` and
``cpu`` tensors the wrappers do what they always did.

The counts are process-wide, not per thread: autograd may run a backward
(and the reverse-time scan launched in it) on its own thread.
"""
from __future__ import annotations

import contextlib
from collections import defaultdict
from typing import Dict, List, Tuple

import torch


class KernelCount:
    """Flops (in all and by dtype), bytes and launches by shape of the
    kernels counted while it is open (:func:`counting`)."""

    def __init__(self):
        self.flops = 0
        self.bytes = 0
        self.flops_by_dtype: Dict[str, int] = defaultdict(int)
        self.launches: Dict[str, Dict[Tuple[int, ...], int]] = \
            defaultdict(lambda: defaultdict(int))

    def add(self, name: str, key: Tuple[int, ...], flops: int,
            nbytes: int, dtype: str) -> None:
        self.flops += int(flops)
        self.bytes += int(nbytes)
        self.flops_by_dtype[dtype] += int(flops)
        self.launches[name][key] += 1

    def by_shape(self) -> Dict[str, Dict[Tuple[int, ...], int]]:
        return {k: dict(v) for k, v in self.launches.items()}


_OPEN: List[KernelCount] = []


@contextlib.contextmanager
def counting():
    """Open a :class:`KernelCount` for the kernels counted inside."""
    count = KernelCount()
    _OPEN.append(count)
    try:
        yield count
    finally:
        _OPEN.remove(count)


def record(name: str, key: Tuple[int, ...], flops: int, nbytes: int,
           dtype: torch.dtype) -> None:
    """One counted launch of kernel ``name`` at ``key``, computing in
    ``dtype``, into every open count."""
    for count in _OPEN:
        count.add(name, key, flops, nbytes, dtype_name(dtype))


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.bfloat16`` -> ``"bfloat16"``."""
    return str(dtype).removeprefix("torch.")
