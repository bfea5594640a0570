"""Wrapper of the Hopper RG-LRU scan kernel (``csrc/rglru_scan.cu``), the
counterpart of the JAX package's Pallas ``rglru_scan_kernel``.

The kernel has two routes, chosen before the launch by :func:`route` from
what the copies can take: "tma" (a and b arrive in shared memory by TMA
copies of 3-D tensor maps, which need W % 4 == 0 and 16-byte aligned a and
b) and "cp_async" (4-byte ``cp.async`` copies, for any W and alignment).
A failed launch raises; it is never retried on the other route.

On CUDA tensors :func:`rglru_scan_kernel` checks what the kernel takes
(float32, contiguous, one device, shapes, shared memory reckoned by
:func:`smem_bytes`) and launches it, raising on anything else -- there is
no fallback.  On CPU tensors it runs the plain version
(``ref.rglru_scan_ref``), because only there is no kernel to launch.
``LAUNCHES`` counts kernel launches and ``LAUNCHES_BY_ROUTE`` splits them
by route, so a run can show that its recurrences went through the kernel
and which copies fed it; ``LAUNCHES_BY_SHAPE`` by (B, S, W).

The launch writes into a fresh tensor through ctypes, so its output
carries no autograd graph.  Models call it through ``ops.rglru_scan``,
which routes a call that autograd records through ``ops.RGLRUScan``: its
forward is this launch, its backward this same kernel run on flipped time
(``ops.reverse_scan``: the gradient of a linear recurrence is the
recurrence run backward, with ``a`` shifted one step) followed by two
elementwise products.  A training step therefore launches the kernel
forward, again when remat recomputes the forward, and once in reverse.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels.rglru.ref import rglru_scan_ref

Tensor = torch.Tensor

LAUNCHES = 0            # kernel launches since the last reset
LAUNCHES_BY_ROUTE = {"tma": 0, "cp_async": 0}
# launches by (B, S, W): a tensor-parallel rank's local channels
LAUNCHES_BY_SHAPE: dict = {}

# the block's shape (the source's kConsumers, kRows, kStages)
CONSUMERS = 2           # consumer warps a block, one channel a lane
STAGE_ROWS = 32         # time steps a ring stage holds
RING_STAGES = 2         # stages in a block's ring

_lib = None


def route(a: Tensor, b: Tensor) -> str:
    """The copies that feed the kernel: "tma" when a row of a and b is a
    multiple of 16 bytes (W % 4 == 0) and both start 16-byte aligned,
    else "cp_async"."""
    W = a.shape[-1]
    if W % 4 == 0 and a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0:
        return "tma"
    return "cp_async"


def ring_bytes() -> int:
    """Bytes of a and b one block's ring holds, all of them in flight
    while the consumers wait."""
    return RING_STAGES * 2 * STAGE_ROWS * 32 * CONSUMERS * 4


def smem_bytes() -> int:
    """Dynamic shared memory one block takes: 128 bytes of alignment slack,
    the ring, and a full and an empty 8-byte mbarrier a stage
    (``rglru_scan_smem_bytes`` in the source)."""
    return 128 + ring_bytes() + 16 * RING_STAGES


def check_smem(limit: int) -> int:
    """:func:`smem_bytes`, or ValueError when it exceeds ``limit``, the
    shared memory a block may use."""
    smem = smem_bytes()
    if smem > limit:
        raise ValueError(
            f"rglru_scan keeps a ring of {RING_STAGES} stages of "
            f"{STAGE_ROWS} time steps in shared memory: {smem} B exceeds the "
            f"{limit} B a block may use")
    return smem


def _library():
    global _lib
    if _lib is None:
        from repro_torch.kernels import _build
        lib = _build.load("rglru_scan")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rglru_scan_launch.argtypes = [p] * 5 + [i] * 4 + [p]
        lib.rglru_scan_launch.restype = ctypes.c_int
        lib.rglru_scan_smem_bytes.argtypes = []
        lib.rglru_scan_smem_bytes.restype = ctypes.c_int
        lib.rglru_scan_smem_limit.argtypes = [i]
        lib.rglru_scan_smem_limit.restype = ctypes.c_int
        _lib = lib
    return _lib


def smem_limit(device: torch.device) -> int:
    """The shared memory a block may opt in to on ``device``."""
    return _library().rglru_scan_smem_limit(device.index)


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
    if h.numel() == 0:          # no step to take
        return h, h0.clone()
    name = route(a, b)
    lib = _library()
    check_smem(smem_limit(dev))
    h_last = torch.empty_like(h0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.rglru_scan_launch(a.data_ptr(), b.data_ptr(),
                                    h0.data_ptr(), h.data_ptr(),
                                    h_last.data_ptr(), B, S, W,
                                    int(name == "tma"), stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan ({name}) launch failed: error {err}")
    global LAUNCHES
    LAUNCHES += 1
    LAUNCHES_BY_ROUTE[name] += 1
    LAUNCHES_BY_SHAPE[(B, S, W)] = LAUNCHES_BY_SHAPE.get((B, S, W), 0) + 1
    return h, h_last
