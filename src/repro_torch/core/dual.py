"""Primal/dual objectives for regularized loss minimization (paper eq. (1)-(2)).

Primal:  min_w  P(w) = (lam/2)||w||^2 + (1/m) sum_i l_i(w^T x_i)
Dual:    max_a  D(a) = -(lam/2)||A a||^2 - (1/m) sum_i l*_i(-a_i),
         A_i = x_i / (lam * m),   w(a) = A a.

Each supported loss provides:
  * ``value(a, y)``          -- l_i(a)
  * ``conj_neg(alpha, y)``   -- l*_i(-alpha) (the term appearing in D)
  * ``coord_delta(wx, alpha, y, xsq_over_lm)``
        closed-form (or Newton) maximizer of the Procedure-P scalar subproblem
            max_d  -(lam m / 2)||w + d x_i/(lam m)||^2 - l*(-(alpha + d))
        where ``wx = w . x_i`` and ``xsq_over_lm = ||x_i||^2 / (lam m)``.
  * ``gamma``                -- smoothness: l is (1/gamma)-smooth (0 => non-smooth)
  * ``kind`` / ``g``         -- which closed form the CUDA leaf kernel runs
        (``squared``, ``hinge``, ``smooth_hinge`` with smoothing ``g``,
        ``logistic``; ``""`` for a loss the kernel does not know)
  * ``cuda``                 -- for a ``kind ""`` loss, its ``coord_delta``
        in CUDA C++: the body of a ``__device__`` function of ``float wx,
        a, y, xsq, g`` (``xsq`` the ``xsq_over_lm`` above, ``g`` the
        loss's ``g``) that returns the step; the kernel is built with it
        (``kernels/sdca/kernel.py::prelude``).  Without it such a loss
        runs only where the plain version does (CPU tensors)

The same formulas as the JAX package's ``core/dual.py``, on torch tensors;
the CUDA kernel (``kernels/sdca/csrc/sdca_block.cu``) repeats each
``coord_delta`` in C++.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Loss:
    name: str
    value: Callable[[Tensor, Tensor], Tensor]
    conj_neg: Callable[[Tensor, Tensor], Tensor]
    coord_delta: Callable[[Tensor, Tensor, Tensor, Tensor], Tensor]
    gamma: float
    kind: str = ""
    g: float = 0.0
    cuda: str = ""


# -----------------------------------------------------------------------------
# squared loss (ridge regression):  l(a) = (a - y)^2 / 2
#   l*(-alpha) = alpha^2/2 - alpha y;  d = (y - wx - alpha) / (1 + xsq_over_lm)
# -----------------------------------------------------------------------------
def _sq_value(a, y):
    return 0.5 * (a - y) ** 2


def _sq_conj_neg(alpha, y):
    return 0.5 * alpha**2 - alpha * y


def _sq_coord_delta(wx, alpha, y, xsq_over_lm):
    return (y - wx - alpha) / (1.0 + xsq_over_lm)


squared = Loss("squared", _sq_value, _sq_conj_neg, _sq_coord_delta,
               gamma=1.0, kind="squared")


# -----------------------------------------------------------------------------
# hinge loss (SVM):  l(a) = max(0, 1 - y a),  y in {-1, +1}
#   l*(-alpha) = -alpha y   for alpha y in [0, 1]
#   q = (1 - y wx) / xsq_over_lm + alpha y;  d = y clip(q, 0, 1) - alpha
# -----------------------------------------------------------------------------
def _hinge_value(a, y):
    return torch.clamp(1.0 - y * a, min=0.0)


def _hinge_conj_neg(alpha, y):
    # -alpha*y on the feasible set; feasibility is maintained by the update.
    return -alpha * y


def _hinge_coord_delta(wx, alpha, y, xsq_over_lm):
    q = (1.0 - y * wx) / torch.clamp(xsq_over_lm, min=1e-12) + alpha * y
    return y * torch.clamp(q, 0.0, 1.0) - alpha


hinge = Loss("hinge", _hinge_value, _hinge_conj_neg, _hinge_coord_delta,
             gamma=0.0, kind="hinge")


# -----------------------------------------------------------------------------
# smoothed hinge with smoothing g
#   l(a) = 0 (y a >= 1);  1 - y a - g/2 (y a <= 1 - g);  (1 - y a)^2/(2g) else
#   l*(-alpha) = -alpha y + (g/2)(alpha y)^2   for alpha y in [0, 1]
#   q = (1 - y wx - g alpha y)/(xsq_over_lm + g) + alpha y
# -----------------------------------------------------------------------------
def _make_smooth_hinge(g: float) -> Loss:
    def value(a, y):
        z = 1.0 - y * a
        return torch.where(
            z <= 0.0, torch.zeros_like(z),
            torch.where(z >= g, z - g / 2.0, z**2 / (2.0 * g)))

    def conj_neg(alpha, y):
        ay = alpha * y
        return -ay + (g / 2.0) * ay**2

    def coord_delta(wx, alpha, y, xsq_over_lm):
        q = (1.0 - y * wx - g * alpha * y) / (xsq_over_lm + g) + alpha * y
        return y * torch.clamp(q, 0.0, 1.0) - alpha

    return Loss(f"smooth_hinge_{g:g}", value, conj_neg, coord_delta,
                gamma=g, kind="smooth_hinge", g=g)


smooth_hinge = _make_smooth_hinge(1.0)
make_smooth_hinge = _make_smooth_hinge


# -----------------------------------------------------------------------------
# logistic loss:  l(a) = log(1 + exp(-y a))
#   with u = alpha y in [0, 1]:  l*(-alpha) = u log u + (1-u) log(1-u)
#   no closed form -> damped Newton steps on the scalar dual, each
#   coordinate's ending once a step moves it by at most LOGISTIC_STEP_TOL,
#   at most 16 (about 5 on typical data), where the reference runs 8
#   fixed steps (which stop short of the argmax by up to 5.5e-4 on some
#   draws; from 12 on, none of the property test's 1001 seeds does).  The
#   kernel's coord_delta<kLogistic> runs the same rule.
# -----------------------------------------------------------------------------
LOGISTIC_NEWTON_STEPS = 16
LOGISTIC_STEP_TOL = 1e-6
LOGISTIC_EPS = 1e-6


def _log_value(a, y):
    return torch.logaddexp(torch.zeros_like(a), -y * a)


def _xlogx(u):
    return torch.where(u > 0.0, u * torch.log(torch.clamp(u, min=1e-30)),
                       torch.zeros_like(u))


def _log_conj_neg(alpha, y):
    u = torch.clamp(alpha * y, 0.0, 1.0)
    return _xlogx(u) + _xlogx(1.0 - u)


def _log_coord_delta(wx, alpha, y, xsq_over_lm):
    # maximize f(d) = -(1/2) xsq_over_lm d^2 - wx d - l*(-(alpha+d)) over
    # u = (alpha + d) y in (0, 1), keeping every iterate strictly feasible;
    # a coordinate whose step was small keeps its d (``done``)
    eps = LOGISTIC_EPS
    d = torch.clamp(alpha * y, 0.25, 0.75) * y - alpha
    done = torch.zeros_like(d, dtype=torch.bool)
    for _ in range(LOGISTIC_NEWTON_STEPS):
        u = torch.clamp((alpha + d) * y, eps, 1.0 - eps)
        grad = -xsq_over_lm * d - wx - y * (torch.log(u) - torch.log(1.0 - u))
        hess = -xsq_over_lm - 1.0 / (u * (1.0 - u))
        d_new = d - grad / hess
        u_new = (alpha + d_new) * y
        d_new = torch.where((u_new <= 0.0) | (u_new >= 1.0),
                            torch.clamp(u_new, eps, 1.0 - eps) * y - alpha,
                            d_new)
        small = torch.abs(d_new - d) <= LOGISTIC_STEP_TOL
        d = torch.where(done, d, d_new)
        done = done | small
    return d


logistic = Loss("logistic", _log_value, _log_conj_neg, _log_coord_delta,
                gamma=0.25, kind="logistic")

LOSSES = {l.name: l for l in (squared, hinge, smooth_hinge, logistic)}


def register_loss(loss: Loss) -> Loss:
    """Add ``loss`` to the by-name registry (idempotent for equal names)."""
    LOSSES[loss.name] = loss
    return loss


def get_loss(loss) -> Loss:
    """Resolve a loss from a :class:`Loss` instance or a registry name;
    ``smooth_hinge_<g>`` is constructed (and registered) on demand."""
    if isinstance(loss, Loss):
        return loss
    if not isinstance(loss, str):
        raise TypeError(f"loss must be a Loss or a name, got {type(loss)}")
    if loss in LOSSES:
        return LOSSES[loss]
    if loss.startswith("smooth_hinge_"):
        g = float(loss[len("smooth_hinge_"):])
        if g <= 0:
            raise ValueError(f"smooth_hinge smoothing must be > 0, got {g}")
        return register_loss(_make_smooth_hinge(g))
    raise KeyError(
        f"unknown loss {loss!r}; registered: {sorted(LOSSES)} "
        "(or parametric 'smooth_hinge_<g>')")


# -----------------------------------------------------------------------------
# Objectives
# -----------------------------------------------------------------------------
def data_matrix(X: Tensor, lam: float) -> Tensor:
    """A (d x m) with columns x_i/(lam m) from row-major X (m x d)."""
    return X.T / (lam * X.shape[0])


def primal_value(w: Tensor, X: Tensor, y: Tensor, loss: Loss,
                 lam: float) -> Tensor:
    margins = X @ w
    return 0.5 * lam * torch.dot(w, w) + torch.mean(loss.value(margins, y))


def w_of_alpha(alpha: Tensor, X: Tensor, lam: float) -> Tensor:
    return (X.T @ alpha) / (lam * X.shape[0])


def dual_value(alpha: Tensor, X: Tensor, y: Tensor, loss: Loss,
               lam: float) -> Tensor:
    w = w_of_alpha(alpha, X, lam)
    return -0.5 * lam * torch.dot(w, w) - torch.mean(loss.conj_neg(alpha, y))


def duality_gap(alpha: Tensor, X: Tensor, y: Tensor, loss: Loss,
                lam: float) -> Tensor:
    w = w_of_alpha(alpha, X, lam)
    return primal_value(w, X, y, loss, lam) - dual_value(alpha, X, y, loss, lam)


def ridge_dual_optimum(X: Tensor, y: Tensor, lam: float) -> Tensor:
    """Closed-form dual optimum for the squared loss: (lam m A^T A + I) a = y."""
    m = X.shape[0]
    A = data_matrix(X, lam)
    G = lam * m * (A.T @ A) + torch.eye(m, dtype=X.dtype, device=X.device)
    return torch.linalg.solve(G, y)
