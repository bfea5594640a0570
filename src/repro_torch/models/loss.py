"""Sequence-chunked cross-entropy (the JAX package's ``models/loss.py``):
the (B, S, V) logits tensor is never materialized; logits are computed
and reduced chunk by chunk.

Vocab-parallel under tensor parallelism (``models/shardctx.py``): when the
unembedding holds this rank's share of the vocab (``vocab_parallel``, as
its spec says), each chunk's max is
taken over every rank's logits (a gathered maximum, held constant), the
exponential sums and the target logit (from the rank that owns the label)
are summed over ``model``."""
from __future__ import annotations

from typing import Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import shardctx

Tensor = torch.Tensor


def _chunk_loss(hc: Tensor, lc: Tensor, mc: Tensor, unemb: Tensor
                ) -> Tensor:
    logits = hc.float() @ unemb.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, lc.long()[..., None])[..., 0]
    return torch.sum((lse - ll) * mc)


def _chunk_loss_split(hc: Tensor, lc: Tensor, mc: Tensor, unemb: Tensor
                      ) -> Tensor:
    """``_chunk_loss`` on this rank's vocab columns of ``unemb``."""
    logits = hc.float() @ unemb.float()
    n = logits.shape[-1]
    with torch.no_grad():
        m = torch.amax(shardctx.gather_from_model(
            torch.amax(logits, dim=-1)[None], 0), dim=0)
    se = shardctx.reduce_from_model(
        torch.sum(torch.exp(logits - m[..., None]), dim=-1))
    lse = m + torch.log(se)
    local = lc.long() - shardctx.model_rank() * n
    mine = (local >= 0) & (local < n)
    ll = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    ll = shardctx.reduce_from_model(torch.where(mine, ll, 0.0))
    return torch.sum((lse - ll) * mc)


def chunked_xent(
    h: Tensor,           # (B, S, D) final hidden states
    unemb: Tensor,       # (D, V)
    labels: Tensor,      # (B, S) int32
    mask: Tensor,        # (B, S) {0,1}
    chunk: int = 512,
    vocab_parallel: bool = False,
) -> Tuple[Tensor, Tensor]:
    """Returns (sum_loss, sum_mask), both float32 0-d tensors, summed over
    the chunks in order as the reference's scan carries them.

    Under autograd each chunk runs in ``torch.utils.checkpoint`` (the
    reference's ``jax.checkpoint``): the backward recomputes that chunk's
    (B, c, V) logits instead of keeping every chunk's, so only one chunk's
    logits exist at a time.  ``vocab_parallel``: ``unemb`` holds this
    rank's columns of the vocab (the module docstring)."""
    B, S, D = h.shape
    c = min(chunk, S)
    if S % c:
        raise ValueError(f"S={S} not divisible by loss chunk {c}")
    grad = torch.is_grad_enabled() and (h.requires_grad
                                        or unemb.requires_grad)
    fn = _chunk_loss
    if vocab_parallel:
        fn = _chunk_loss_split
        h = shardctx.copy_to_model(h)
    loss = torch.zeros((), dtype=torch.float32, device=h.device)
    n = torch.zeros((), dtype=torch.float32, device=h.device)
    for s in range(0, S, c):
        hc, lc, mc = h[:, s:s + c], labels[:, s:s + c], mask[:, s:s + c]
        if grad:
            part = checkpoint(fn, hc, lc, mc, unemb, use_reentrant=False)
        else:
            part = fn(hc, lc, mc, unemb)
        loss = loss + part
        n = n + torch.sum(mc)
    return loss, n
