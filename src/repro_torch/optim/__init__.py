"""Optimizers over dicts of tensors (the JAX package's ``optim``): AdamW,
Adafactor, SGD.

API (pure ``init`` / ``update`` functions, not ``torch.optim``, so a state
matches the reference's entry for entry)::

    opt = get_optimizer(cfg)            # from a ModelConfig, or make_adamw(...)
    state = opt.init(params)
    params, state = opt.update(params, grads, state)
"""
from repro_torch.optim.adafactor import make_adafactor
from repro_torch.optim.adamw import make_adamw, warmup_cosine
from repro_torch.optim.api import Optimizer, get_optimizer
from repro_torch.optim.sgd import make_sgd

__all__ = [
    "Optimizer",
    "get_optimizer",
    "make_adamw",
    "make_adafactor",
    "make_sgd",
    "warmup_cosine",
]
