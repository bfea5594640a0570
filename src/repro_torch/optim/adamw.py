"""AdamW with decoupled weight decay and linear-warmup/cosine schedules.

Moment states are stored in float32 regardless of parameter dtype
(standard mixed-precision practice); the update is computed in float32 and
cast back.  On shards (``shards=``, one ``models/shardctx.py::LeafShard``
per leaf) the update is elementwise as it is; only the gradient norm's
sums of squares are all-reduced over the axes that split each leaf.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from repro_torch.optim.api import (Optimizer, as_rate, put, tree_leaves,
                                   tree_unflatten, zeros_f32)


def warmup_cosine(lr: float, warmup: int = 100, total: int = 10_000,
                  final_frac: float = 0.1) -> Callable:
    """Standard LM schedule: linear warmup then cosine decay to
    final_frac*lr.  ``sched(step)`` takes the int32 step tensor and
    returns a f32 0-d tensor."""
    def sched(step):
        step = step.float()
        warm = lr * torch.clamp(step / max(warmup, 1), max=1.0)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = final_frac * lr + (1 - final_frac) * lr * 0.5 * (
            1 + torch.cos(math.pi * t))
        return torch.where(step < warmup, warm, cos)
    return sched


def make_adamw(
    lr: float = 3e-4,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    grad_clip: Optional[float] = 1.0,
    schedule: Optional[Callable] = None,
) -> Optimizer:
    sched = schedule if schedule is not None else (lambda step: lr)

    def init(params):
        flat = tree_leaves(params)
        return {
            "step": torch.zeros((), dtype=torch.int32,
                                device=flat[0].device),
            "mu": tree_unflatten(params, [zeros_f32(p) for p in flat]),
            "nu": tree_unflatten(params, [zeros_f32(p) for p in flat]),
        }

    @torch.no_grad()
    def update(params, grads, state, lr=None, inplace=False, shards=None):
        flat_p = tree_leaves(params)
        flat_g = tree_leaves(grads)
        step = state["step"] + 1
        stepf = step.float()
        # lr=None -> the built-in schedule; a float or 0-d tensor overrides
        lr_t = sched(step) if lr is None else as_rate(lr, flat_p[0])

        if grad_clip is not None and shards is not None:
            gsq = sum(sh.sum(torch.sum(torch.square(g.float())))
                      for g, sh in zip(flat_g, shards, strict=True))
        elif grad_clip is not None:
            gsq = sum(torch.sum(torch.square(g.float())) for g in flat_g)
        if grad_clip is not None:
            gnorm = torch.sqrt(gsq + 1e-16)
            scale = torch.clamp(grad_clip / gnorm, max=1.0)
        else:
            scale = 1.0

        bc1 = 1.0 - torch.pow(torch.tensor(b1, device=stepf.device), stepf)
        bc2 = 1.0 - torch.pow(torch.tensor(b2, device=stepf.device), stepf)

        new_p, new_mu, new_nu = [], [], []
        for p, g, mu, nu in zip(flat_p, flat_g, tree_leaves(state["mu"]),
                                tree_leaves(state["nu"]), strict=True):
            g = g.float() * scale
            mu_n = b1 * mu + (1 - b1) * g
            nu_n = b2 * nu + (1 - b2) * g * g
            mhat = mu_n / bc1
            nhat = nu_n / bc2
            pf = p.float()
            # decoupled weight decay: skip 1-D params (norms, biases)
            wd = weight_decay if p.dim() >= 2 else 0.0
            pf = pf - lr_t * (mhat / (torch.sqrt(nhat) + eps) + wd * pf)
            new_p.append(put(p, pf, inplace))
            new_mu.append(put(mu, mu_n, inplace))
            new_nu.append(put(nu, nu_n, inplace))
        return (tree_unflatten(params, new_p),
                {"step": step, "mu": tree_unflatten(params, new_mu),
                 "nu": tree_unflatten(params, new_nu)})

    return Optimizer("adamw", init, update)
