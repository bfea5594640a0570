"""Wrapper of the Hopper flash-attention kernel (``csrc/flash_attention.cu``),
the counterpart of the JAX package's Pallas ``flash_attention_kernel``.

On CUDA tensors :func:`flash_attention_kernel` checks what the kernel
takes (float32 or bfloat16, one dtype, contiguous, one device, shapes, a
compiled head dim, shared memory) and launches it, raising on anything
else -- there is no fallback.  On CPU tensors it runs the plain version
(``ref.attention_ref``), because only there is no kernel to launch.
``LAUNCHES`` counts kernel launches, so a run can show that its attention
went through the kernel.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels.flash_attention.ref import attention_ref

Tensor = torch.Tensor

LAUNCHES = 0            # kernel launches since the last reset

HEAD_DIMS = (16, 64, 80, 128, 256)   # the head dims the source compiles
_DTYPES = (torch.float32, torch.bfloat16)
_lib = None


def _library():
    global _lib
    if _lib is None:
        from repro_torch.kernels import _build
        lib = _build.load("flash_attention")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_attention_launch.argtypes = (
            [p] * 4 + [i] * 7 + [f] + [i] * 3 + [p])
        lib.flash_attention_launch.restype = ctypes.c_int
        lib.flash_attention_smem_bytes.argtypes = [i]
        lib.flash_attention_smem_bytes.restype = ctypes.c_int
        lib.flash_attention_smem_limit.argtypes = [i]
        lib.flash_attention_smem_limit.restype = ctypes.c_int
        _lib = lib
    return _lib


def smem_limit(device: torch.device) -> int:
    """The shared memory a block may opt in to on ``device``."""
    return _library().flash_attention_smem_limit(device.index)


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


def flash_attention_kernel(q: Tensor, k: Tensor, v: Tensor, *,
                           causal: bool = True, window: Optional[int] = None,
                           scale: Optional[float] = None,
                           seq_offset: int = 0) -> Tensor:
    """q: (B, Sq, H, d); k/v: (B, Sk, KV, d), H % KV == 0.  Returns
    (B, Sq, H, d) in q's dtype; query i sits at position i + seq_offset."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q must be (B, Sq, H, d) and k, v (B, Sk, KV, d), "
                         f"got {tuple(q.shape)} and {tuple(k.shape)}")
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if KV < 1 or H % KV:
        raise ValueError(f"query heads {H} not a multiple of kv heads {KV}")
    if seq_offset < 0:
        raise ValueError(f"seq_offset must be >= 0, got {seq_offset}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    s = scale if scale is not None else D ** -0.5
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window, scale=s,
                             seq_offset=seq_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda (or cpu via its "
                         f"plain version), got {q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention takes float32 or bfloat16, got "
                        f"{q.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} is not compiled (HEAD_DIMS = "
                         f"{HEAD_DIMS})")
    dev = q.device
    _check("q", q, q.dtype, (B, Sq, H, D), dev)
    _check("k", k, q.dtype, (B, Sk, KV, D), dev)
    _check("v", v, q.dtype, (B, Sk, KV, D), dev)
    lib = _library()
    smem = lib.flash_attention_smem_bytes(D)
    limit = smem_limit(dev)
    if smem > limit:
        raise ValueError(
            f"flash_attention keeps a {D}-wide q block and K/V tile in "
            f"shared memory: {smem} B exceeds the {limit} B a block may use")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, Sq, Sk, H, KV, D, int(q.dtype == torch.bfloat16), float(s),
            int(causal), 0 if window is None else int(window),
            int(seq_offset), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: cudaError {err}")
    global LAUNCHES
    LAUNCHES += 1
    return out
