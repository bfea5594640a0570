"""Sequence-chunked cross-entropy (the JAX package's ``models/loss.py``):
the (B, S, V) logits tensor is never materialized; logits are computed
and reduced chunk by chunk."""
from __future__ import annotations

from typing import Tuple

import torch
from torch.utils.checkpoint import checkpoint

Tensor = torch.Tensor


def _chunk_loss(hc: Tensor, lc: Tensor, mc: Tensor, unemb: Tensor
                ) -> Tensor:
    logits = hc.float() @ unemb.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, lc.long()[..., None])[..., 0]
    return torch.sum((lse - ll) * mc)


def chunked_xent(
    h: Tensor,           # (B, S, D) final hidden states
    unemb: Tensor,       # (D, V)
    labels: Tensor,      # (B, S) int32
    mask: Tensor,        # (B, S) {0,1}
    chunk: int = 512,
) -> Tuple[Tensor, Tensor]:
    """Returns (sum_loss, sum_mask), both float32 0-d tensors, summed over
    the chunks in order as the reference's scan carries them.

    Under autograd each chunk runs in ``torch.utils.checkpoint`` (the
    reference's ``jax.checkpoint``): the backward recomputes that chunk's
    (B, c, V) logits instead of keeping every chunk's, so only one chunk's
    logits exist at a time."""
    B, S, D = h.shape
    c = min(chunk, S)
    if S % c:
        raise ValueError(f"S={S} not divisible by loss chunk {c}")
    grad = torch.is_grad_enabled() and (h.requires_grad
                                        or unemb.requires_grad)
    loss = torch.zeros((), dtype=torch.float32, device=h.device)
    n = torch.zeros((), dtype=torch.float32, device=h.device)
    for s in range(0, S, c):
        hc, lc, mc = h[:, s:s + c], labels[:, s:s + c], mask[:, s:s + c]
        if grad:
            part = checkpoint(_chunk_loss, hc, lc, mc, unemb,
                              use_reentrant=False)
        else:
            part = _chunk_loss(hc, lc, mc, unemb)
        loss = loss + part
        n = n + torch.sum(mc)
    return loss, n
