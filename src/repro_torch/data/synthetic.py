"""Deterministic synthetic datasets for the DCA experiments (paper SS7).

The same constructions as the JAX package's ``data/synthetic.py`` (planted
Gaussian regression, separable-ish classification, an 11-feature wine-like
regression), drawn here from a seeded ``torch.Generator`` on ``device``.
The numbers therefore differ from the JAX package's for the same seed;
tests that compare the two packages build one numpy array and hand it to
both.  The data are generated on the device in bulk, so a problem of
gigabytes costs no host-to-device copy.
"""
from __future__ import annotations

from typing import Tuple

import torch

Tensor = torch.Tensor


def _gen(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


def gaussian_regression(
    m: int = 600, d: int = 100, *, seed: int = 7, noise: float = 0.1,
    device="cuda",
) -> Tuple[Tensor, Tensor]:
    """Paper SS7: X rows iid N(0,1); y from a planted linear model + noise."""
    g = _gen(seed, device)
    X = torch.randn(m, d, generator=g, device=device)
    w_star = torch.randn(d, generator=g, device=device) / d ** 0.5
    y = X @ w_star + noise * torch.randn(m, generator=g, device=device)
    return X, y


def gaussian_classification(
    m: int = 600, d: int = 100, *, seed: int = 11, margin: float = 0.5,
    device="cuda",
) -> Tuple[Tensor, Tensor]:
    """Linearly separable-ish binary labels in {-1, +1} for SVM tests."""
    g = _gen(seed, device)
    X = torch.randn(m, d, generator=g, device=device)
    w_star = torch.randn(d, generator=g, device=device) / d ** 0.5
    score = X @ w_star + margin * torch.randn(m, generator=g, device=device)
    y = torch.where(score >= 0, 1.0, -1.0)
    return X, y


def wine_like(m: int = 1596, *, seed: int = 17,
              device="cuda") -> Tuple[Tensor, Tensor]:
    """Synthetic stand-in for the wine-quality set: 11 correlated
    standardized features, integer-ish quality target in [3, 8]."""
    g = _gen(seed, device)
    d = 11
    z = torch.randn(m, d, generator=g, device=device)
    mix = torch.randn(d, d, generator=g, device=device) / d ** 0.5
    X = z @ (torch.eye(d, device=device) + 0.5 * mix)
    w_star = torch.randn(d, generator=g, device=device)
    q = 5.5 + 1.2 * torch.tanh(X @ w_star / d ** 0.5)
    y = torch.clamp(
        torch.round(q + 0.3 * torch.randn(m, generator=g, device=device)),
        3.0, 8.0)
    X = (X - X.mean(0)) / (X.std(0, unbiased=False) + 1e-8)
    return X, y
