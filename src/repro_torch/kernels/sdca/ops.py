"""One outer CoCoA round through the blocked-SDCA kernel: every worker's
LocalSDCA in a single launch, then the 1/K averaging (the JAX package's
``kernels/sdca/ops.py::sdca_block_solve``).  :func:`cost` is the
kernel's least work (flops, bytes)."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import prng
from repro_torch.core.dual import Loss
from repro_torch.kernels.sdca.kernel import (  # noqa: F401
    cost, sdca_block_kernel)

Tensor = torch.Tensor


def sdca_block_solve(
    X: Tensor,        # (K, m_b, d) worker data blocks
    y: Tensor,        # (K, m_b)
    alpha: Tensor,    # (K, m_b)
    w: Tensor,        # (d,)
    key: Tensor,      # a prng key
    *,
    loss: Loss,
    lam: float,
    m_total: int,
    num_steps: int,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Every worker runs H = num_steps local coordinate steps from the
    shared w; returns (new_alpha (K, m_b), new_w (d,), delta_w per worker
    (K, d)).  The draws are ``randint(key, (K, num_steps), 0, m_b)``, as in
    the reference."""
    K, m_b, _ = X.shape
    lm = float(torch.tensor(lam * m_total, dtype=torch.float32))
    idx = prng.randint(prng.as_key(key).to(X.device), (K, num_steps), 0, m_b)
    da, dw = sdca_block_kernel(X, y, alpha, w, idx, loss=loss, lm=lm)
    new_alpha = alpha + da / K
    new_w = w + torch.sum(dw, dim=0) / K
    return new_alpha, new_w, dw
