"""Wrapper of the Hopper blocked-SDCA kernel (``csrc/sdca_block.cu``), the
counterpart of the JAX package's Pallas ``sdca_block_kernel``.

On CUDA tensors :func:`sdca_block_launch` checks what the kernel takes
(float32 / int32, contiguous, one device, shapes, shared memory reckoned
by :func:`smem_bytes` with the row ring of :func:`ring_depth`) and
launches it, raising on anything else -- there is no fallback.  On CPU
tensors it runs the plain version (``ref.sdca_steps_ref``), because only
there is no kernel to launch.  ``LAUNCHES`` counts kernel launches, so a
run can show that its leaf solves went through the kernel.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.core.dual import Loss
from repro_torch.kernels.sdca.ref import sdca_steps_ref

Tensor = torch.Tensor

LAUNCHES = 0            # kernel launches since the last reset

_LOSS_IDS = {"squared": 0, "hinge": 1, "smooth_hinge": 2, "logistic": 3}
RING_FLOATS = 8192      # the row ring's budget (csrc: kRingFloats)
RING_GROUP = 4          # rows per mbarrier of the ring (csrc: kGroup)
_lib = None


def ring_depth(d: int) -> int:
    """Rows the kernel keeps in flight per leaf: 32 KiB of rows in whole
    groups of 4, at least 4 and at most 16 (``ring_depth`` in the source)."""
    return max(4, min(16, RING_FLOATS // d // RING_GROUP * RING_GROUP))


def smem_bytes(m_b: int, d: int) -> int:
    """Dynamic shared memory one block takes for a leaf of ``m_b``
    examples in ``d`` dimensions: the row ring, w, alpha, y and xsq as
    float32 (padded to an even count), then a full and an empty 8-byte
    mbarrier per group of ring rows (``sdca_block_smem_bytes`` in the
    source)."""
    n = (ring_depth(d) + 1) * d + 3 * m_b
    return 4 * (n + n % 2) + 16 * (ring_depth(d) // RING_GROUP)


def check_smem(m_b: int, d: int, limit: int) -> int:
    """:func:`smem_bytes`, or ValueError when it exceeds ``limit``, the
    shared memory a block may use."""
    smem = smem_bytes(m_b, d)
    if smem > limit:
        raise ValueError(
            f"sdca_block keeps a leaf's alpha, y, xsq and w and a ring of "
            f"{ring_depth(d)} rows in shared memory: {smem} B exceeds the "
            f"{limit} B a block may use (d={d}, m_b={m_b})")
    return smem


def _library():
    global _lib
    if _lib is None:
        from repro_torch.kernels import _build
        lib = _build.load("sdca_block")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.sdca_block_launch.argtypes = [p] * 9 + [i] * 5 + [f, i, f, p]
        lib.sdca_block_launch.restype = ctypes.c_int
        lib.sdca_block_smem_limit.argtypes = [i]
        lib.sdca_block_smem_limit.restype = ctypes.c_int
        lib.sdca_block_smem_bytes.argtypes = [i, i]
        lib.sdca_block_smem_bytes.restype = ctypes.c_longlong
        _lib = lib
    return _lib


def loss_id(loss: Loss) -> int:
    """The kernel's code for ``loss``; raises for a loss it has no closed
    form for."""
    if loss.kind not in _LOSS_IDS:
        raise NotImplementedError(
            f"the CUDA sdca_block kernel has no coord_delta for loss "
            f"{loss.name!r} (kernels: {sorted(_LOSS_IDS)})")
    return _LOSS_IDS[loss.kind]


def _check(name: str, t: Tensor, dtype, shape, device):
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def sdca_block_launch(
    X: Tensor,          # (K, m_b, d) f32
    y: Tensor,          # (K, m_b) f32
    alpha: Tensor,      # (K, m_b) f32
    w: Tensor,          # (d,) shared or (K, d) per leaf, f32
    xsq: Tensor,        # (K, m_b) f32: ||x_i||^2 / lm
    idx: Tensor,        # (K, H) int32
    *,
    loss: Loss,
    lm: float,
    step_mask: Optional[Tensor] = None,  # (K, H) f32
) -> Tuple[Tensor, Tensor]:
    """One launch: every leaf's H sequential steps; returns (delta_alpha
    (K, m_b), delta_w (K, d))."""
    if X.device.type == "cpu":
        return sdca_steps_ref(X, y, alpha, w, xsq, idx, loss=loss, lm=lm,
                              step_mask=step_mask)
    if X.device.type != "cuda":
        raise ValueError(f"sdca_block runs on cuda (or cpu via its plain "
                         f"version), got {X.device}")
    if X.dim() != 3 or idx.dim() != 2:
        raise ValueError(f"X must be (K, m_b, d) and idx (K, H), got "
                         f"{tuple(X.shape)} and {tuple(idx.shape)}")
    K, m_b, d = X.shape
    H = idx.shape[1]
    dev, f32 = X.device, torch.float32
    _check("X", X, f32, (K, m_b, d), dev)
    _check("y", y, f32, (K, m_b), dev)
    _check("alpha", alpha, f32, (K, m_b), dev)
    _check("xsq", xsq, f32, (K, m_b), dev)
    _check("idx", idx, torch.int32, (K, H), dev)
    if w.dim() == 1:
        _check("w", w, f32, (d,), dev)
        w_stride = 0
    else:
        _check("w", w, f32, (K, d), dev)
        w_stride = d
    if step_mask is not None:
        _check("step_mask", step_mask, f32, (K, H), dev)
    code = loss_id(loss)
    lib = _library()
    check_smem(m_b, d, lib.sdca_block_smem_limit(dev.index))
    da = torch.empty((K, m_b), dtype=f32, device=dev)
    dw = torch.empty((K, d), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sdca_block_launch(
            X.data_ptr(), y.data_ptr(), alpha.data_ptr(), w.data_ptr(),
            xsq.data_ptr(), idx.data_ptr(),
            None if step_mask is None else step_mask.data_ptr(),
            da.data_ptr(), dw.data_ptr(), K, m_b, d, H, w_stride,
            float(lm), code, float(loss.g), stream)
    if err != 0:
        raise RuntimeError(f"sdca_block launch failed: cudaError {err}")
    global LAUNCHES
    LAUNCHES += 1
    return da, dw


def sdca_block_kernel(
    X: Tensor, y: Tensor, alpha: Tensor, w: Tensor, idx: Tensor, *,
    loss: Loss, lm: float, step_mask: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """The reference kernel's signature: ``xsq = sum(X^2) / lm`` is taken
    here, then one :func:`sdca_block_launch`."""
    xsq = torch.sum(X * X, dim=2) / lm
    return sdca_block_launch(X, y, alpha, w, xsq, idx, loss=loss, lm=lm,
                             step_mask=step_mask)
