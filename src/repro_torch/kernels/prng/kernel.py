"""Wrapper of the Hopper threefry draw kernel (``csrc/threefry_randint.cu``).

A solve tick draws ``randint(key_l, (H_l,), 0, m_b_l)`` for every (config,
leaf) row of its key plan.  On CUDA tensors :func:`randint_rows` checks
what the kernel takes (int64 keys, int32 H and m_b per leaf, contiguous,
one device, shapes) and launches it once for every row, raising on
anything else -- there is no fallback.  On CPU tensors it runs the plain
version (``ref.randint_rows_ref``, over ``core/prng.py::randint``),
because only there is no kernel to launch.  ``LAUNCHES`` counts kernel
launches, so a run can show that its draws went through the kernel; while
a profiler records, each launch also counts ``draw.kernel_ticks`` (a solve
tick's draws are one launch), which ``tick.draw_kernel_frac`` reads.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.core import instrument
from repro_torch.kernels.prng.ref import Groups, randint_rows_ref

Tensor = torch.Tensor

LAUNCHES = 0            # kernel launches since the last reset
# 32-bit integer operations a draw: two threefry-2x32 blocks of 72 each,
# the XOR of each block's words and three remainders by the row's span
# (counted from csrc/threefry_randint.cu)
OPS_PER_DRAW = 170

_lib = None


def _library():
    global _lib
    if _lib is None:
        from repro_torch.kernels import _build
        lib = _build.load("threefry_randint")
        p = ctypes.c_void_p
        lib.threefry_randint_launch.argtypes = [
            p, p, p, p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, p]
        lib.threefry_randint_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(name: str, t: Tensor, dtype, device):
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def cost(rows: int, draws: int, width: int) -> Tuple[int, int]:
    """(integer operations, bytes) of one launch over ``rows`` (config,
    leaf) rows of ``width`` columns holding ``draws`` draws in all: each
    row's key (16 B), H and m_b (8 B) read, every column's int32 written."""
    return OPS_PER_DRAW * draws, rows * (16 + 8) + rows * width * 4


def randint_rows(keys: Tensor, hcap: Tensor, maxval: Tensor, width: int,
                 groups: Optional[Groups] = None) -> Tensor:
    """The draws of (..., n, 2) int64 keys (two uint32 words each): row
    ``(..., l)`` holds ``randint(key, (hcap[l],), 0, maxval[l])`` in its
    first ``hcap[l]`` columns and 0 in the rest, as (..., n, width)
    int32.  ``hcap`` and ``maxval`` are (n,) int32, each H at most
    ``width``.  ``groups`` (``ref.h_groups(hcap, maxval)``) spares the
    plain version its grouping by H on every call; the kernel takes none."""
    if keys.dim() < 2 or keys.shape[-1] != 2:
        raise ValueError(f"keys must be (..., n, 2), got {tuple(keys.shape)}")
    n, dev = keys.shape[-2], keys.device
    _check("keys", keys, torch.int64, dev)
    for name, t in (("hcap", hcap), ("maxval", maxval)):
        _check(name, t, torch.int32, dev)
        if tuple(t.shape) != (n,):
            raise ValueError(f"{name} must have shape ({n},), got "
                             f"{tuple(t.shape)}")
    width = int(width)
    if width < 0:
        raise ValueError(f"width must be >= 0, got {width}")
    if dev.type == "cpu":
        return randint_rows_ref(keys, hcap, maxval, width, groups)
    if dev.type != "cuda":
        raise ValueError(f"threefry_randint runs on cuda (or cpu via its "
                         f"plain version), got {dev}")
    out = torch.empty(tuple(keys.shape[:-1]) + (width,), dtype=torch.int32,
                      device=dev)
    if out.numel() == 0:
        return out
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.threefry_randint_launch(
            keys.data_ptr(), hcap.data_ptr(), maxval.data_ptr(),
            out.data_ptr(), keys.numel() // 2, n, width, stream)
    if err != 0:
        raise RuntimeError(f"threefry_randint launch failed: cudaError {err}")
    global LAUNCHES
    LAUNCHES += 1
    instrument.count("draw.kernel_ticks")
    return out
