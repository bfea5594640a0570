"""Deterministic synthetic datasets for the DCA experiments (paper SS7).

The same constructions as the JAX package's ``data/synthetic.py`` (planted
Gaussian regression, separable-ish classification, an 11-feature wine-like
regression), drawn two ways:

  * ``key=`` (the default, with the reference's default keys
    ``PRNGKey(7)``, ``(11)`` and ``(17)``): the reference's own draws,
    replayed by ``core/prng.py`` -- the same key splits in the same order,
    bit-exact uniforms, normals within a few float32 ulp of
    ``jax.random.normal`` (the two erfinv polynomials differ), and the
    float32 arithmetic on them summed in another order.  So the default
    data are the reference's default data to float32 rounding;
  * ``seed=``: bulk data from a seeded ``torch.Generator`` on ``device``,
    for problems of gigabytes that the int64 threefry replay would not
    fit beside; these numbers are not the reference's.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import prng

Tensor = torch.Tensor


def _normals(shapes, key, seed: Optional[int], default: int, device):
    """One standard-normal tensor per shape: the reference's ``kx, kw,
    ... = split(key, len(shapes))`` draws replayed (``key`` defaults to
    ``PRNGKey(default)``), or draws from one seeded ``torch.Generator``
    when ``seed`` is given."""
    if seed is not None:
        if key is not None:
            raise ValueError("pass key= (the reference's draws) or seed= "
                             "(bulk torch.Generator draws), not both")
        g = torch.Generator(device=device)
        g.manual_seed(int(seed))
        return [torch.randn(*s, generator=g, device=device) for s in shapes]
    k = prng.PRNGKey(default) if key is None else prng.as_key(key)
    subs = prng.split(k.to(device), len(shapes))
    return [prng.normal(sub, s) for sub, s in zip(subs, shapes, strict=True)]


def _sqrt32(d: int, device) -> Tensor:
    """``jnp.sqrt(d)``: the float32 square root of an integer."""
    return torch.sqrt(torch.tensor(float(d), dtype=torch.float32,
                                   device=device))


def gaussian_regression(
    m: int = 600, d: int = 100, key=None, noise: float = 0.1, *,
    seed: Optional[int] = None, device="cuda",
) -> Tuple[Tensor, Tensor]:
    """Paper SS7: X rows iid N(0,1); y from a planted linear model + noise."""
    X, w, n = _normals([(m, d), (d,), (m,)], key, seed, 7, device)
    w_star = w / _sqrt32(d, device)
    y = X @ w_star + noise * n
    return X, y


def gaussian_classification(
    m: int = 600, d: int = 100, key=None, margin: float = 0.5, *,
    seed: Optional[int] = None, device="cuda",
) -> Tuple[Tensor, Tensor]:
    """Linearly separable-ish binary labels in {-1, +1} for SVM tests."""
    X, w, n = _normals([(m, d), (d,), (m,)], key, seed, 11, device)
    w_star = w / _sqrt32(d, device)
    score = X @ w_star + margin * n
    y = torch.where(score >= 0, 1.0, -1.0)
    return X, y


def wine_like(m: int = 1596, key=None, *, seed: Optional[int] = None,
              device="cuda") -> Tuple[Tensor, Tensor]:
    """Synthetic stand-in for the wine-quality set: 11 correlated
    standardized features, integer-ish quality target in [3, 8]."""
    d = 11
    z, mix, w_star, n = _normals([(m, d), (d, d), (d,), (m,)], key, seed,
                                 17, device)
    sq = _sqrt32(d, device)
    X = z @ (torch.eye(d, device=device) + 0.5 * (mix / sq))
    q = 5.5 + 1.2 * torch.tanh(X @ w_star / sq)
    y = torch.clamp(torch.round(q + 0.3 * n), 3.0, 8.0)
    X = (X - X.mean(0)) / (X.std(0, unbiased=False) + 1e-8)
    return X, y
