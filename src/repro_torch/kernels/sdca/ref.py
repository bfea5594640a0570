"""Plain-torch version of the blocked SDCA leaf solve: K workers, each
running H sequential closed-form coordinate maximizations over its own
data block (Procedure P / Algorithm 1's inner parallel loop).

The K workers advance together, one coordinate step per Python iteration
(a batch dimension in place of the reference's ``vmap``), so this is the
oracle the CUDA kernel is held against and the path every CPU tensor
takes; it is no yardstick of speed.  :func:`sdca_steps_ref_batched` is
the same for a leading config axis over shared data (the batched launch's
plain version), one config after another.
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


def sdca_steps_ref_batched(
    X: Tensor,          # (K, m_b, d), shared by the configs
    y: Tensor,          # (K, m_b), shared
    alpha: Tensor,      # (B, K, m_b)
    w: Tensor,          # (B, d) one per config or (B, K, d) per worker
    xsq: Tensor,        # (B, K, m_b): ||x_i||^2 / lms[b]
    idx: Tensor,        # (B, K, H)
    *,
    loss: Loss,
    lms,                # B floats (or a (B,) tensor): lambda * m per config
    step_mask: Optional[Tensor] = None,  # (B, K, H)
) -> Tuple[Tensor, Tensor]:
    """:func:`sdca_steps_ref` for B configs over shared data, config by
    config (the batched kernel's plain version); returns (delta_alpha (B,
    K, m_b), delta_w (B, K, d))."""
    lm_host = [float(v) for v in (lms.tolist() if isinstance(lms, Tensor)
                                  else lms)]
    outs = [sdca_steps_ref(
        X, y, alpha[b], w[b], xsq[b], idx[b], loss=loss, lm=lm_host[b],
        step_mask=None if step_mask is None else step_mask[b])
        for b in range(alpha.shape[0])]
    return (torch.stack([o[0] for o in outs]),
            torch.stack([o[1] for o in outs]))


def sdca_block_ref(
    X: Tensor, y: Tensor, alpha: Tensor, w: Tensor, idx: Tensor, *,
    loss: Loss, lm: float, step_mask: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """Returns (delta_alpha (K, m_b), delta_w (K, d)); ``lm`` is
    lambda * m_total."""
    xsq = torch.sum(X * X, dim=2) / lm
    return sdca_steps_ref(X, y, alpha, w, xsq, idx, loss=loss, lm=lm,
                          step_mask=step_mask)
