"""Plain-torch version of the RG-LRU diagonal linear recurrence
h_t = a_t * h_{t-1} + b_t (elementwise), h_0 given -- the JAX package's
``kernels/rglru/ref.py``, one time step at a time."""
from __future__ import annotations

from typing import Tuple

import torch

Tensor = torch.Tensor


def rglru_scan_ref(a: Tensor, b: Tensor, h0: Tensor) -> Tuple[Tensor, Tensor]:
    """a, b: (B, S, W); h0: (B, W). Returns (h (B, S, W), h_last (B, W))."""
    h = h0
    hs = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    if not hs:
        return torch.empty_like(a), h0.clone()
    return torch.stack(hs, dim=1), h
