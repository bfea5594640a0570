"""Plain-torch version of the blocked SDCA leaf solve: K workers, each
running H sequential closed-form coordinate maximizations over its own
data block (Procedure P / Algorithm 1's inner parallel loop).

The K workers advance together, one coordinate step per Python iteration
(a batch dimension in place of the reference's ``vmap``), so this is the
oracle the CUDA kernel is held against and the path every CPU tensor
takes; it is no yardstick of speed.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.dual import Loss

Tensor = torch.Tensor


def sdca_steps_ref(
    X: Tensor,          # (K, m_b, d)
    y: Tensor,          # (K, m_b)
    alpha: Tensor,      # (K, m_b)
    w: Tensor,          # (d,) shared or (K, d) per worker
    xsq: Tensor,        # (K, m_b): ||x_i||^2 / lm
    idx: Tensor,        # (K, H) int coordinate choices
    *,
    loss: Loss,
    lm: float,
    step_mask: Optional[Tensor] = None,  # (K, H) 0/1 per-step gating
) -> Tuple[Tensor, Tensor]:
    """The H steps from precomputed ``xsq``; returns (delta_alpha (K, m_b),
    delta_w (K, d))."""
    K, _, d = X.shape
    H = idx.shape[1]
    rows = torch.arange(K, device=X.device)
    idx = idx.long()
    a_c = alpha.clone()
    w0 = w.expand(K, d)
    w_c = w0.clone()
    for h in range(H):
        i = idx[:, h]
        x_i = X[rows, i]                                      # (K, d)
        wx = torch.sum(w_c * x_i, dim=1)
        dlt = loss.coord_delta(wx, a_c[rows, i], y[rows, i], xsq[rows, i])
        if step_mask is not None:
            dlt = dlt * step_mask[:, h]
        a_c[rows, i] = a_c[rows, i] + dlt
        w_c = w_c + (dlt / lm)[:, None] * x_i
    return a_c - alpha, w_c - w0


def sdca_block_ref(
    X: Tensor, y: Tensor, alpha: Tensor, w: Tensor, idx: Tensor, *,
    loss: Loss, lm: float, step_mask: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """Returns (delta_alpha (K, m_b), delta_w (K, d)); ``lm`` is
    lambda * m_total."""
    xsq = torch.sum(X * X, dim=2) / lm
    return sdca_steps_ref(X, y, alpha, w, xsq, idx, loss=loss, lm=lm,
                          step_mask=step_mask)
