"""Wrapper of the Hopper blocked-SDCA kernel (``csrc/sdca_block.cu``), the
counterpart of the JAX package's Pallas ``sdca_block_kernel``.

On CUDA tensors :func:`sdca_block_launch_batched` checks what the kernel
takes (float32 / int32, contiguous, one device, shapes, shared memory
reckoned by :func:`smem_bytes` with the row ring of :func:`ring_depth`)
and launches it once for B configs x K leaves, raising on anything else
-- there is no fallback.  :func:`sdca_block_launch` is its B = 1 case
(one config, ``lm`` a float).  On CPU tensors both run the plain version
(``ref.sdca_steps_ref``, config by config), because only there is no
kernel to launch.  ``LAUNCHES`` counts kernel launches and ``LEAVES``
the (config, leaf) blocks they solved, so a run can show that its leaf
solves -- and a sweep's B configs -- went through one launch a tick.

On ``meta`` tensors (a cost count, ``kernels/counting.py``) a launch is
not made: the open counts get it by (B, K, m_b, d, H) with :func:`cost`
at the most distinct rows the draws could name, and empty meta outputs
are returned.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.core.dual import Loss
from repro_torch.kernels import counting
from repro_torch.kernels.sdca.ref import (sdca_steps_ref,
                                          sdca_steps_ref_batched)

Tensor = torch.Tensor

LAUNCHES = 0            # kernel launches since the last reset
LEAVES = 0              # (config, leaf) blocks those launches solved

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


def cost(rows: int, B: int, K: int, m_b: int, d: int, H: int
         ) -> Tuple[int, int]:
    """(flops, bytes) of the least work of one launch of B configs x K
    leaves x H steps: ``rows`` distinct sampled rows (summed over the
    leaves, each leaf's over all configs) read once, y read once, each
    config's alpha, xsq and delta-alpha and its w and delta-w read or
    written once, the draws and the step mask read once; 4 flops per row
    element per step (the dot product and the update of w)."""
    nbytes = rows * d * 4 + K * m_b * 4 + B * K * (3 * m_b + 2 * d) * 4 \
        + B * K * H * 8
    return 4 * B * K * H * d, nbytes


def _library():
    global _lib
    if _lib is None:
        from repro_torch.kernels import _build
        lib = _build.load("sdca_block")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.sdca_block_launch.argtypes = ([p] * 9 + [i] * 6
                                          + [ctypes.c_longlong, p, i, f, p])
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


def lm_array(lms, device) -> Tensor:
    """The (B,) float32 ``lm`` operand on ``device`` from a float, a
    sequence of floats or a tensor (each value lambda * m, a float32)."""
    if isinstance(lms, Tensor):
        return lms.to(device=device, dtype=torch.float32).reshape(-1)
    if isinstance(lms, (int, float)):
        return torch.full((1,), float(lms), dtype=torch.float32,
                          device=device)
    return torch.tensor([float(v) for v in lms], dtype=torch.float32,
                        device=device)


def batched_layout(X: Tensor, y: Tensor, alpha: Tensor, w: Tensor,
                   xsq: Tensor, idx: Tensor, lm: Tensor,
                   step_mask: Optional[Tensor] = None) -> Tuple[int, ...]:
    """Check a batched launch's operands against each other -- float32 /
    int32, one device, contiguous, X (K, m_b, d) and y (K, m_b) shared,
    alpha and xsq (B, K, m_b), w (B, d) or (B, K, d), idx and step_mask
    (B, K, H), lm (B,), B and K at least 1 -- and return ``(B, K, m_b, d,
    H, w_stride, w_cfg_stride)``; raise on anything else."""
    if X.dim() != 3 or alpha.dim() != 3 or idx.dim() != 3:
        raise ValueError(f"X must be (K, m_b, d), alpha (B, K, m_b) and idx "
                         f"(B, K, H), got {tuple(X.shape)}, "
                         f"{tuple(alpha.shape)} and {tuple(idx.shape)}")
    K, m_b, d = X.shape
    B, H = alpha.shape[0], idx.shape[2]
    dev, f32 = X.device, torch.float32
    _check("X", X, f32, (K, m_b, d), dev)
    _check("y", y, f32, (K, m_b), dev)
    _check("alpha", alpha, f32, (B, K, m_b), dev)
    _check("xsq", xsq, f32, (B, K, m_b), dev)
    _check("idx", idx, torch.int32, (B, K, H), dev)
    _check("lm", lm, f32, (B,), dev)
    if w.dim() == 2:
        _check("w", w, f32, (B, d), dev)
        w_stride, w_cfg_stride = 0, d
    else:
        _check("w", w, f32, (B, K, d), dev)
        w_stride, w_cfg_stride = d, K * d
    if step_mask is not None:
        _check("step_mask", step_mask, f32, (B, K, H), dev)
    if B < 1 or K < 1:
        raise ValueError(f"sdca_block needs B >= 1 configs of K >= 1 "
                         f"leaves, got B={B}, K={K}")
    return B, K, m_b, d, H, w_stride, w_cfg_stride


def sdca_block_launch_batched(
    X: Tensor,          # (K, m_b, d) f32, shared by the configs
    y: Tensor,          # (K, m_b) f32, shared
    alpha: Tensor,      # (B, K, m_b) f32
    w: Tensor,          # (B, d) one per config or (B, K, d) per leaf, f32
    xsq: Tensor,        # (B, K, m_b) f32: ||x_i||^2 / lm[b]
    idx: Tensor,        # (B, K, H) int32
    *,
    loss: Loss,
    lms,                # (B,) lambda * m per config: floats or a tensor
    step_mask: Optional[Tensor] = None,  # (B, K, H) f32
) -> Tuple[Tensor, Tensor]:
    """One launch for B configs x K leaves: every (config, leaf)'s H
    sequential steps; returns (delta_alpha (B, K, m_b), delta_w (B, K,
    d)).  The operands are checked by :func:`batched_layout`; on CPU
    tensors the plain version then runs config by config."""
    if X.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"sdca_block runs on cuda (or cpu via its plain "
                         f"version), got {X.device}")
    lm_dev = lm_array(lms, X.device)
    B, K, m_b, d, H, w_stride, w_cfg_stride = batched_layout(
        X, y, alpha, w, xsq, idx, lm_dev, step_mask)
    if X.device.type == "cpu":
        return sdca_steps_ref_batched(X, y, alpha, w, xsq, idx, loss=loss,
                                      lms=lm_dev, step_mask=step_mask)
    dev, f32 = X.device, torch.float32
    if X.device.type == "meta":
        flops, nbytes = cost(K * min(m_b, B * H), B, K, m_b, d, H)
        counting.record("sdca_block", (B, K, m_b, d, H), flops, nbytes,
                        f32)
        return (torch.empty((B, K, m_b), dtype=f32, device=dev),
                torch.empty((B, K, d), dtype=f32, device=dev))
    code = loss_id(loss)
    lib = _library()
    check_smem(m_b, d, lib.sdca_block_smem_limit(dev.index))
    da = torch.empty((B, K, m_b), dtype=f32, device=dev)
    dw = torch.empty((B, K, d), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sdca_block_launch(
            X.data_ptr(), y.data_ptr(), alpha.data_ptr(), w.data_ptr(),
            xsq.data_ptr(), idx.data_ptr(),
            None if step_mask is None else step_mask.data_ptr(),
            da.data_ptr(), dw.data_ptr(), B, K, m_b, d, H, w_stride,
            w_cfg_stride, lm_dev.data_ptr(), code, float(loss.g), stream)
    if err != 0:
        raise RuntimeError(f"sdca_block launch failed: cudaError {err}")
    global LAUNCHES, LEAVES
    LAUNCHES += 1
    LEAVES += B * K
    return da, dw


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
    (K, m_b), delta_w (K, d)).  The B = 1 case of
    :func:`sdca_block_launch_batched`."""
    if X.device.type == "cpu":
        return sdca_steps_ref(X, y, alpha, w, xsq, idx, loss=loss, lm=lm,
                              step_mask=step_mask)
    if X.dim() != 3 or idx.dim() != 2 or alpha.dim() != 2 or \
            w.dim() not in (1, 2):
        raise ValueError(f"X must be (K, m_b, d), alpha (K, m_b), w (d,) "
                         f"or (K, d) and idx (K, H), got {tuple(X.shape)}, "
                         f"{tuple(alpha.shape)}, {tuple(w.shape)} and "
                         f"{tuple(idx.shape)}")
    da, dw = sdca_block_launch_batched(
        X, y, alpha[None], w[None], xsq[None], idx[None], loss=loss,
        lms=lm, step_mask=None if step_mask is None else step_mask[None])
    return da[0], dw[0]


def sdca_block_kernel(
    X: Tensor, y: Tensor, alpha: Tensor, w: Tensor, idx: Tensor, *,
    loss: Loss, lm: float, step_mask: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """The reference kernel's signature: ``xsq = sum(X^2) / lm`` is taken
    here, then one :func:`sdca_block_launch`."""
    xsq = torch.sum(X * X, dim=2) / lm
    return sdca_block_launch(X, y, alpha, w, xsq, idx, loss=loss, lm=lm,
                             step_mask=step_mask)
