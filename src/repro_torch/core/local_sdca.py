"""Procedure P: LocalSDCA at one leaf, the single-worker oracle.

Given the leaf's data block X (m_b x d), labels y, current dual block
``alpha`` and a w consistent with the *global* alpha (w = A alpha), runs H
sequential random-coordinate exact maximizations and returns (delta_alpha,
delta_w).  The global problem size ``m_total`` (not the block size) enters
through A_i = x_i/(lam * m_total).  The coordinates are
``randint(key, (H,), 0, m_b)``, bit-identical to the JAX package's draws.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import prng
from repro_torch.core.dual import Loss

Tensor = torch.Tensor


def local_sdca(
    X: Tensor,
    y: Tensor,
    alpha: Tensor,
    w: Tensor,
    key: Tensor,
    *,
    loss: Loss,
    lam: float,
    m_total: int,
    num_steps: int,
) -> Tuple[Tensor, Tensor]:
    """Run H = num_steps coordinate steps; return (delta_alpha, delta_w)."""
    m_b = X.shape[0]
    lm = float(torch.tensor(lam * m_total, dtype=torch.float32))
    xsq = torch.sum(X * X, dim=1) / lm
    idx = prng.randint(prng.as_key(key), (num_steps,), 0, m_b).tolist()
    a_c, w_c = alpha.clone(), w.clone()
    for i in idx:
        x_i = X[i]
        wx = torch.dot(w_c, x_i)
        d = loss.coord_delta(wx, a_c[i], y[i], xsq[i])
        a_c[i] = a_c[i] + d
        w_c = w_c + (d / lm) * x_i
    return a_c - alpha, w_c - w


def local_sdca_epochs(
    X: Tensor,
    y: Tensor,
    alpha: Tensor,
    w: Tensor,
    key: Tensor,
    *,
    loss: Loss,
    lam: float,
    m_total: int,
    epochs: int,
) -> Tuple[Tensor, Tensor]:
    """Convenience: H = epochs * m_b coordinate steps."""
    return local_sdca(X, y, alpha, w, key, loss=loss, lam=lam,
                      m_total=m_total, num_steps=epochs * X.shape[0])
