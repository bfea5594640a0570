"""The :class:`Problem` object: data + loss + regularization (paper eq. (1)).

A Problem is pure *what*: the (m, d) float32 design matrix, labels, a
loss (by name via the ``core.dual`` registry, or a
:class:`~repro_torch.core.dual.Loss`), and the ridge parameter lambda.
Its tensors stay on the device they were given on (numpy input lands on
the CPU); :meth:`to` moves them, as ``Session.compile(device=)`` does.
``Problem.lm`` builds the second workload, an :class:`LMProblem`.
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

    # ---- the second workload -------------------------------------------
    @staticmethod
    def lm(cfg, optimizer, *, batch: int, seq: int, seed: int = 0,
           average_opt_state: bool = True) -> "LMProblem":
        """Data-parallel LM training on the same schedule engine.

        Returns an :class:`LMProblem` that :meth:`Session.compile
        <repro_torch.api.session.Session.compile>` dispatches to the
        ``"lm_treesync"`` method (mesh backend): the local step is one
        ``optimizer`` update on a synthetic-LM batch, the per-level
        combine a parameter/opt-state mean over the level's sync group.
        """
        return LMProblem(cfg=cfg, optimizer=optimizer, batch=batch, seq=seq,
                         seed=seed, average_opt_state=average_opt_state)


@dataclasses.dataclass(frozen=True)
class LMProblem:
    """LM-training *what*: model config + optimizer + deterministic data
    stream (``repro_torch.data.lm.lm_batch`` is a pure function of
    ``(seed, step)``, so resume = restore state + continue the stream).

    Where/how stay :class:`~repro_torch.api.topology.Topology` /
    :class:`~repro_torch.api.schedule.Schedule`, exactly as for SDCA; the
    ``method`` marker routes :meth:`Session.compile
    <repro_torch.api.session.Session.compile>` to
    :class:`repro_torch.api.lm.LMSession`.
    """
    cfg: "object"            # repro_torch.configs.base.ModelConfig
    optimizer: "object"      # repro_torch.optim.Optimizer
    batch: int = 8
    seq: int = 128
    seed: int = 0
    average_opt_state: bool = True
    method: str = dataclasses.field(default="lm_treesync")

    def __post_init__(self):
        if self.batch <= 0 or self.seq <= 0:
            raise ValueError(
                f"batch/seq must be positive, got {self.batch}/{self.seq}")
