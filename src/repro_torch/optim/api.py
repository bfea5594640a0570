"""Optimizer container, config-driven selection, and the tree helpers the
optimizers share.

A parameter tree is nested dicts and lists of tensors; its leaves are
visited in the order ``jax.tree.leaves`` visits the reference's (dict keys
sorted, list items in order), so a sum over leaves (AdamW's gradient norm)
adds in the reference's order.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Tuple

import torch

PyTree = Any


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """A pair of pure functions over parameter trees.

    ``init(params) -> state`` and ``update(params, grads, state, lr=None,
    inplace=False) -> (new_params, new_state)``.  ``state`` always carries
    a scalar int32 ``step`` as its first entry so checkpointing can report
    progress uniformly.  ``lr`` (a float or a 0-d tensor) overrides the
    built-in rate or schedule.  ``inplace=True`` writes the results into
    the tensors of ``params`` and ``state`` and returns them (the
    counterpart of the reference executor donating its state): a step then
    holds one copy of the parameters, not two."""
    name: str
    init: Callable[[PyTree], PyTree]
    update: Callable[..., Tuple[PyTree, PyTree]]


def get_optimizer(cfg, lr: float = 3e-4, weight_decay: float = 0.1
                  ) -> Optimizer:
    """Pick the optimizer named by a ModelConfig (adamw | adafactor | sgd)."""
    from repro_torch.optim.adafactor import make_adafactor
    from repro_torch.optim.adamw import make_adamw
    from repro_torch.optim.sgd import make_sgd

    kind = getattr(cfg, "optimizer", "adamw")
    if kind == "adamw":
        return make_adamw(lr=lr, weight_decay=weight_decay)
    if kind == "adafactor":
        return make_adafactor(lr=lr)
    if kind == "sgd":
        return make_sgd(lr=lr)
    raise ValueError(f"unknown optimizer {kind!r}")


def tree_leaves(tree: PyTree, is_leaf: Callable = lambda t: False
                ) -> List[Any]:
    """The leaves of ``tree`` in ``jax.tree.leaves`` order (``None`` is an
    empty subtree)."""
    if tree is None:
        return []
    if is_leaf(tree) or not isinstance(tree, (dict, list, tuple)):
        return [tree]
    items = ([tree[k] for k in sorted(tree)] if isinstance(tree, dict)
             else list(tree))
    return [x for t in items for x in tree_leaves(t, is_leaf)]


def tree_unflatten(tree: PyTree, leaves: List[Any],
                   is_leaf: Callable = lambda t: False) -> PyTree:
    """A tree shaped like ``tree`` whose leaves are ``leaves`` (in
    :func:`tree_leaves` order)."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if is_leaf(t) or not isinstance(t, (dict, list, tuple)):
            return next(it)
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        return type(t)(build(x) for x in t)

    out = build(tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def zeros_f32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def as_rate(lr, like: torch.Tensor):
    """A learning rate for the f32 update: a Python float as it is, a
    tensor as a f32 0-d tensor on ``like``'s device."""
    if isinstance(lr, torch.Tensor):
        return lr.to(device=like.device, dtype=torch.float32)
    return lr


def put(dst: torch.Tensor, value: torch.Tensor, inplace: bool
        ) -> torch.Tensor:
    """``value`` cast to ``dst``'s dtype; written into ``dst`` when
    ``inplace``."""
    if inplace:
        with torch.no_grad():
            dst.copy_(value)
        return dst
    return value.to(dst.dtype)
