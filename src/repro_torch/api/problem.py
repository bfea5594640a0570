"""The :class:`Problem` object: data + loss + regularization (paper eq. (1)).

A Problem is pure *what*: the (m, d) float32 design matrix, labels, a
loss (by name via the ``core.dual`` registry, or a
:class:`~repro_torch.core.dual.Loss`), and the ridge parameter lambda.
Its tensors stay on the device they were given on (numpy input lands on
the CPU); :meth:`to` moves them, as ``Session.compile(device=)`` does.
"""
from __future__ import annotations

import dataclasses
from typing import Union

import torch

from repro_torch.core.dual import Loss, get_loss


@dataclasses.dataclass(frozen=True)
class Problem:
    """A regularized loss-minimization instance."""
    X: torch.Tensor
    y: torch.Tensor
    loss: Union[Loss, str] = "squared"
    lam: float = 0.1

    def __post_init__(self):
        object.__setattr__(self, "X",
                           torch.as_tensor(self.X, dtype=torch.float32))
        object.__setattr__(self, "y", torch.as_tensor(
            self.y, dtype=torch.float32, device=self.X.device))
        object.__setattr__(self, "loss", get_loss(self.loss))
        if self.X.dim() != 2:
            raise ValueError(f"X must be (m, d), got shape "
                             f"{tuple(self.X.shape)}")
        if tuple(self.y.shape) != (self.X.shape[0],):
            raise ValueError(f"y must be ({self.X.shape[0]},), got "
                             f"{tuple(self.y.shape)}")
        if not self.lam > 0:
            raise ValueError(f"lam must be > 0, got {self.lam}")

    @property
    def m(self) -> int:
        return self.X.shape[0]

    @property
    def d(self) -> int:
        return self.X.shape[1]

    @property
    def device(self) -> torch.device:
        return self.X.device

    def to(self, device) -> "Problem":
        """This problem with its tensors on ``device`` (itself when they
        already are)."""
        device = torch.device(device)
        if self.X.device == device or (
                device.index is None and self.X.device.type == device.type):
            return self
        return dataclasses.replace(self, X=self.X.to(device),
                                   y=self.y.to(device))

    # ---- common instantiations -----------------------------------------
    @classmethod
    def ridge(cls, X, y, *, lam: float = 0.1) -> "Problem":
        return cls(X, y, loss="squared", lam=lam)

    @classmethod
    def svm(cls, X, y, *, lam: float = 0.1, smoothing: float = 1.0
            ) -> "Problem":
        """Smoothed-hinge SVM (``smoothing=0`` selects the non-smooth
        hinge)."""
        name = "hinge" if smoothing == 0 else f"smooth_hinge_{smoothing:g}"
        return cls(X, y, loss=name, lam=lam)

    @classmethod
    def logistic(cls, X, y, *, lam: float = 0.1) -> "Problem":
        return cls(X, y, loss="logistic", lam=lam)
