"""The RG-LRU scan as the models call it (the JAX package's
``kernels/rglru/ops.py``): the kernel on the card, its plain version on
the CPU, differentiable through :class:`RGLRUScan`.

The gradient of h_t = a_t h_{t-1} + b_t is itself a linear recurrence,
run backward in time: with g the gradient reaching h,

    g_t = dh_t + a_{t+1} g_{t+1},   da_t = g_t h_{t-1},   db_t = g_t,
    dh0 = a_0 g_0,

so the backward is the same scan on time-flipped inputs (``a`` shifted one
step), followed by two elementwise products -- no second kernel.  The
reference differentiates ``jax.lax.associative_scan`` instead; this is the
gradient it computes.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.rglru.kernel import rglru_scan_kernel

Tensor = torch.Tensor


def reverse_scan(a: Tensor, dh: Tensor) -> Tensor:
    """g_t = dh_t + a_{t+1} g_{t+1} (g_S = 0) over (B, S, W): the forward
    scan on flipped time, one launch of the kernel on the card."""
    a_next = torch.zeros_like(a)
    a_next[:, :-1] = a[:, 1:]
    g0 = torch.zeros((a.shape[0], a.shape[2]), dtype=a.dtype,
                     device=a.device)
    g, _ = rglru_scan_kernel(torch.flip(a_next, (1,)).contiguous(),
                             torch.flip(dh, (1,)).contiguous(), g0)
    return torch.flip(g, (1,))


class RGLRUScan(torch.autograd.Function):
    """(a, b, h0) -> (h, h_last) through the kernel, with the reverse-time
    kernel launch as its backward."""

    @staticmethod
    def forward(ctx, a, b, h0):
        h, h_last = rglru_scan_kernel(a, b, h0)
        ctx.save_for_backward(a, h, h0)
        return h, h_last

    @staticmethod
    def backward(ctx, dh, dh_last):
        a, h, h0 = ctx.saved_tensors
        dh = torch.zeros_like(h) if dh is None else dh.float().clone()
        if dh_last is not None and h.shape[1]:
            dh[:, -1] += dh_last
        if h.shape[1] == 0:
            zero = torch.zeros_like(a)
            return zero, zero.clone(), (dh_last if dh_last is not None
                                        else torch.zeros_like(h0))
        g = reverse_scan(a, dh.contiguous())
        h_prev = torch.cat([h0[:, None], h[:, :-1]], dim=1)
        return g * h_prev, g, a[:, 0] * g[:, 0]


def rglru_scan(a: Tensor, b: Tensor, h0: Optional[Tensor] = None
               ) -> Tuple[Tensor, Tensor]:
    """Diagonal linear recurrence h_t = a_t h_{t-1} + b_t over (B, S, W),
    float32; ``h0`` defaults to zeros.  Returns (all states, final
    state).  When autograd records (an input requires grad), the call goes
    through :class:`RGLRUScan`; otherwise it is the bare kernel call."""
    if h0 is None:
        h0 = torch.zeros((a.shape[0], a.shape[2]), dtype=a.dtype,
                         device=a.device)
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad
                                    or h0.requires_grad):
        return RGLRUScan.apply(a, b, h0)
    return rglru_scan_kernel(a, b, h0)
