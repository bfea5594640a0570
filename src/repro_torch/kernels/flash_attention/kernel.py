"""Wrapper of the Hopper flash-attention kernels, the counterpart of the
JAX package's Pallas ``flash_attention_kernel``.

Two hand-written kernels compute the one function, chosen by ``q.dtype``
alone (:func:`route`): bfloat16 goes to the tensor-core kernel
(``csrc/flash_attention_wgmma.cu``: wgmma products, TMA-fed K/V ring),
float32 to the CUDA-core kernel (``csrc/flash_attention.cu``), which keeps
f32 products because tensor cores cannot hold f32 attention to its 1e-4
tolerance.  A failed launch raises; neither kernel is retried with the
other.

On CUDA tensors :func:`flash_attention_kernel` checks what the kernels
take (float32 or bfloat16, one dtype, contiguous, one device, shapes, a
compiled head dim, shared memory, 16-byte aligned bf16 data) and launches
one, raising on anything else -- there is no fallback.  On CPU tensors it
runs the plain version (``ref.attention_ref``), because only there is no
kernel to launch.  ``LAUNCHES`` counts kernel launches and
``LAUNCHES_BY_ROUTE`` splits them by route, so a run can show that its
attention went through the tensor-core kernel, and ``LAUNCHES_BY_SHAPE``
by (B, Sq, Sk, H, KV, D).

On ``meta`` tensors (a cost count, ``kernels/counting.py``) it launches
nothing and leaves these counters alone: it adds the launch by shape and
:func:`cost` to the open counts and returns an empty meta output.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import counting
from repro_torch.kernels.flash_attention.ref import attention_ref

Tensor = torch.Tensor

LAUNCHES = 0            # kernel launches since the last reset
LAUNCHES_BY_ROUTE = {"wgmma": 0, "f32": 0}
# launches by (B, Sq, Sk, H, KV, D): a tensor-parallel rank's local heads
LAUNCHES_BY_SHAPE: dict = {}

HEAD_DIMS = (16, 64, 80, 128, 256)   # the head dims the sources compile
ROUTES = {torch.bfloat16: "wgmma", torch.float32: "f32"}
_SOURCES = {"wgmma": "flash_attention_wgmma", "f32": "flash_attention"}
_libs = {}


def route(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel that takes inputs of ``dtype`` and ``head_dim``: "wgmma"
    for bfloat16, "f32" for float32; raises for anything else."""
    if dtype not in ROUTES:
        raise TypeError(f"flash_attention takes float32 or bfloat16, got "
                        f"{dtype}")
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"head dim {head_dim} is not compiled (HEAD_DIMS = "
                         f"{HEAD_DIMS})")
    return ROUTES[dtype]


def _library(name: str):
    if name not in _libs:
        from repro_torch.kernels import _build
        lib = _build.load(_SOURCES[name])
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        if name == "wgmma":
            launch, smem = (lib.flash_attention_wgmma_launch,
                            lib.flash_attention_wgmma_smem_bytes)
        else:
            launch, smem = (lib.flash_attention_launch,
                            lib.flash_attention_smem_bytes)
            lib.flash_attention_smem_limit.argtypes = [i]
            lib.flash_attention_smem_limit.restype = ctypes.c_int
        launch.argtypes = [p] * 4 + [i] * 6 + [f] + [i] * 3 + [p]
        launch.restype = ctypes.c_int
        smem.argtypes = [i]
        smem.restype = ctypes.c_int
        _libs[name] = (lib, launch, smem)
    return _libs[name]


def smem_limit(device: torch.device) -> int:
    """The shared memory a block may opt in to on ``device``."""
    lib = _library("f32")[0]
    return lib.flash_attention_smem_limit(device.index)


def visible_pairs(Sq: int, Sk: int, *, causal: bool = True,
                  window: Optional[int] = None, seq_offset: int = 0) -> int:
    """(query, key) pairs the mask lets through: query i at position
    i + seq_offset sees key j when j <= i + seq_offset (causal) and
    i + seq_offset - j < window (if windowed)."""
    n = 0
    for i in range(Sq):
        p = i + seq_offset
        hi = min(p, Sk - 1) if causal else Sk - 1
        lo = max(0, p - window + 1) if window is not None else 0
        n += max(0, hi - lo + 1)
    return n


def cost(B: int, Sq: int, Sk: int, H: int, KV: int, D: int, *,
         causal: bool = True, window: Optional[int] = None,
         seq_offset: int = 0, itemsize: int = 2) -> Tuple[int, int]:
    """(flops, bytes) of the least work of one launch: QK^T and PV take
    2 D flops each per visible pair per head; q, k and v are read once and
    the output written once, ``itemsize`` bytes an element."""
    pairs = visible_pairs(Sq, Sk, causal=causal, window=window,
                          seq_offset=seq_offset)
    flops = 4 * D * pairs * B * H
    nbytes = (2 * B * Sq * H * D + 2 * B * Sk * KV * D) * itemsize
    return flops, nbytes


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
    if q.device.type == "meta":
        route(q.dtype, D)
        flops, nbytes = cost(B, Sq, Sk, H, KV, D, causal=causal,
                             window=window, seq_offset=seq_offset,
                             itemsize=q.element_size())
        counting.record("flash_attention", (B, Sq, Sk, H, KV, D), flops,
                        nbytes, q.dtype)
        return torch.empty_like(q)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda (or cpu via its "
                         f"plain version), got {q.device}")
    name = route(q.dtype, D)
    dev = q.device
    _check("q", q, q.dtype, (B, Sq, H, D), dev)
    _check("k", k, q.dtype, (B, Sk, KV, D), dev)
    _check("v", v, q.dtype, (B, Sk, KV, D), dev)
    if name == "wgmma" and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention's TMA copies need q, k and v "
                         "16-byte aligned")
    _, launch, smem_bytes = _library(name)
    smem = smem_bytes(D)
    limit = smem_limit(dev)
    if smem > limit:
        raise ValueError(
            f"flash_attention keeps a {D}-wide q block and K/V tiles in "
            f"shared memory: {smem} B exceeds the {limit} B a block may use")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), B, Sq, Sk, H, KV, D, float(s),
                     int(causal), 0 if window is None else int(window),
                     int(seq_offset), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention ({name}) launch failed: "
                           f"error {err}")
    global LAUNCHES
    LAUNCHES += 1
    LAUNCHES_BY_ROUTE[name] += 1
    key = (B, Sq, Sk, H, KV, D)
    LAUNCHES_BY_SHAPE[key] = LAUNCHES_BY_SHAPE.get(key, 0) + 1
    return out
