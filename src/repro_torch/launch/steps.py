"""Step functions for serving (the prefill and serve steps of the JAX
package's ``launch/steps.py``; its training step and per-cell sharded
programs are not ported)."""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer


def make_prefill_step(cfg: ModelConfig, max_len: Optional[int] = None
                      ) -> Callable:
    def prefill_step(params, batch):
        return transformer.prefill(cfg, params, batch, max_len=max_len)

    return prefill_step


def make_serve_step(cfg: ModelConfig) -> Callable:
    """One decode step: greedy next token + updated cache."""

    def serve_step(params, cache, tokens):
        logits, cache = transformer.decode_step(cfg, params, cache, tokens)
        next_tokens = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        return next_tokens, cache

    return serve_step
