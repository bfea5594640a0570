"""Plain-torch version of blocked flash attention: causal / sliding-window
/ GQA with float32 softmax -- the JAX package's
``kernels/flash_attention/ref.py``, with the query offset made an argument
so that it is the kernel's function."""
from __future__ import annotations

from typing import Optional

import torch

Tensor = torch.Tensor
NEG_INF = -2.0 ** 30


def attention_ref(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                  window: Optional[int] = None, scale: Optional[float] = None,
                  seq_offset: Optional[int] = None) -> Tensor:
    """q: (B, Sq, H, d); k/v: (B, Sk, KV, d) with H % KV == 0.  Returns
    (B, Sq, H, d) in q's dtype.  Query i sits at position i + seq_offset
    and attends key j when j <= i + seq_offset (causal) and
    i + seq_offset - j < window (if windowed).  ``seq_offset=None`` is the
    reference's aligned suffix, Sk - Sq; the kernel's default is 0.  Rows
    that see no key come out as zeros."""
    B, Sq, H, D = q.shape
    _, Sk, KV, _ = k.shape
    if H % KV:
        raise ValueError(f"query heads {H} not a multiple of kv heads {KV}")
    rep = H // KV
    k = torch.repeat_interleave(k, rep, dim=2)
    v = torch.repeat_interleave(v, rep, dim=2)
    s = scale if scale is not None else D ** -0.5
    off = Sk - Sq if seq_offset is None else seq_offset

    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * s
    qpos = torch.arange(Sq, device=q.device)[:, None] + off
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= (qpos - kpos) < window
    logits = torch.where(mask[None, None], logits, NEG_INF)
    m = torch.amax(logits, dim=-1, keepdim=True)
    e = torch.exp(logits - m)
    e = torch.where(mask[None, None], e, 0.0)
    p = e / (torch.sum(e, dim=-1, keepdim=True) + 1e-30)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)
