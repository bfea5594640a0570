"""Wrapper of the Hopper RG-LRU scan kernel (``csrc/rglru_scan.cu``), the
counterpart of the JAX package's Pallas ``rglru_scan_kernel``.

On CUDA tensors :func:`rglru_scan_kernel` checks what the kernel takes
(float32, contiguous, one device, shapes) and launches it, raising on
anything else -- there is no fallback.  On CPU tensors it runs the plain
version (``ref.rglru_scan_ref``), because only there is no kernel to
launch.  ``LAUNCHES`` counts kernel launches, so a run can show that its
recurrences went through the kernel.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels.rglru.ref import rglru_scan_ref

Tensor = torch.Tensor

LAUNCHES = 0            # kernel launches since the last reset

_lib = None


def _library():
    global _lib
    if _lib is None:
        from repro_torch.kernels import _build
        lib = _build.load("rglru_scan")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rglru_scan_launch.argtypes = [p] * 5 + [i] * 3 + [p]
        lib.rglru_scan_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(name: str, t: Tensor, shape, device):
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be torch.float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def rglru_scan_kernel(a: Tensor, b: Tensor, h0: Tensor
                      ) -> Tuple[Tensor, Tensor]:
    """a, b: (B, S, W) f32; h0: (B, W) f32.  Returns (h (B, S, W),
    h_last (B, W)) with h_t = a_t * h_{t-1} + b_t."""
    if a.device.type == "cpu":
        return rglru_scan_ref(a, b, h0)
    if a.device.type != "cuda":
        raise ValueError(f"rglru_scan runs on cuda (or cpu via its plain "
                         f"version), got {a.device}")
    if a.dim() != 3:
        raise ValueError(f"a must be (B, S, W), got {tuple(a.shape)}")
    B, S, W = a.shape
    dev = a.device
    _check("a", a, (B, S, W), dev)
    _check("b", b, (B, S, W), dev)
    _check("h0", h0, (B, W), dev)
    h = torch.empty_like(a)
    h_last = torch.empty_like(h0)
    if B == 0 or W == 0:
        return h, h_last
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.rglru_scan_launch(a.data_ptr(), b.data_ptr(),
                                    h0.data_ptr(), h.data_ptr(),
                                    h_last.data_ptr(), B, S, W, stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan launch failed: cudaError {err}")
    global LAUNCHES
    LAUNCHES += 1
    return h, h_last
