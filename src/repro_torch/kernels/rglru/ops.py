"""The RG-LRU scan as the models call it (the JAX package's
``kernels/rglru/ops.py``): the kernel on the card, its plain version on
the CPU."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.rglru.kernel import rglru_scan_kernel

Tensor = torch.Tensor


def rglru_scan(a: Tensor, b: Tensor, h0: Optional[Tensor] = None
               ) -> Tuple[Tensor, Tensor]:
    """Diagonal linear recurrence h_t = a_t h_{t-1} + b_t over (B, S, W),
    float32; ``h0`` defaults to zeros.  Returns (all states, final
    state)."""
    if h0 is None:
        h0 = torch.zeros((a.shape[0], a.shape[2]), dtype=a.dtype,
                         device=a.device)
    return rglru_scan_kernel(a, b, h0)
