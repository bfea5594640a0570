"""Flash attention as the models call it (the JAX package's
``kernels/flash_attention/ops.py``): the kernel on the card, its plain
version on the CPU."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention_kernel

Tensor = torch.Tensor


def flash_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                    window: Optional[int] = None,
                    scale: Optional[float] = None,
                    seq_offset: int = 0) -> Tensor:
    """Blocked online-softmax attention; see ``kernel.py`` for the two
    kernels (``csrc/flash_attention_wgmma.cu`` for bf16,
    ``csrc/flash_attention.cu`` for f32).

    q: (B, Sq, H, d); k/v: (B, Sk, KV, d) with H % KV == 0.
    """
    return flash_attention_kernel(q, k, v, causal=causal, window=window,
                                  scale=scale, seq_offset=seq_offset)
