"""Step functions (the JAX package's ``launch/steps.py``): the train step
with gradient accumulation, and the prefill and serve steps.  Its per-cell
sharded programs wait for ``launch/sharding.py`` (ROADMAP)."""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer
from repro_torch.optim import Optimizer, get_optimizer
from repro_torch.optim.api import tree_leaves, tree_unflatten


def grads_of(cfg: ModelConfig, params, batch, plain_recurrence: bool = False):
    """(grads shaped like ``params``, metrics) of ``forward_train``'s total
    loss; the parameters are used through aliases that require grad, so
    the caller's tensors are left as they are.  A parameter the loss does
    not reach (the token embedding of a model fed embeddings) gets a zero
    gradient, as under ``jax.grad``."""
    flat = tree_leaves(params)
    live = [p.detach().requires_grad_(True) for p in flat]
    with torch.enable_grad():
        total, metrics = transformer.forward_train(
            cfg, tree_unflatten(params, live), batch, plain_recurrence)
        grads = torch.autograd.grad(total, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(live, grads, strict=True)]
    return (tree_unflatten(params, grads),
            {k: v.detach() for k, v in metrics.items()})


def make_train_step(cfg: ModelConfig, optimizer: Optional[Optimizer] = None,
                    microbatches: int = 1) -> Callable:
    """``train_step(params, opt_state, batch, lr=None) -> (params,
    opt_state, metrics)``.  microbatches > 1 = gradient accumulation: the
    global batch is split along dim 0 and grads are averaged across
    sequential microbatch passes (activation memory shrinks by the
    factor; FLOPs are unchanged)."""
    optimizer = optimizer or get_optimizer(cfg)

    def train_step(params, opt_state, batch, lr=None):
        if microbatches == 1:
            grads, metrics = grads_of(cfg, params, batch)
        else:
            mbs = {k: v.reshape((microbatches, v.shape[0] // microbatches)
                                + tuple(v.shape[1:]))
                   for k, v in batch.items()}
            acc, metrics = grads_of(cfg, params,
                                    {k: v[0] for k, v in mbs.items()})
            flat = tree_leaves(acc)
            for i in range(1, microbatches):
                g_i, m_i = grads_of(cfg, params,
                                    {k: v[i] for k, v in mbs.items()})
                for a, g in zip(flat, tree_leaves(g_i), strict=True):
                    a.add_(g)
                metrics = {k: metrics[k] + m_i[k] for k in metrics}
            grads = tree_unflatten(acc, [g / microbatches for g in flat])
            metrics = {k: v / microbatches for k, v in metrics.items()}
        params, opt_state = optimizer.update(params, grads, opt_state,
                                             lr=lr)
        return params, opt_state, metrics

    return train_step


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
