"""SGD with (Nesterov) momentum -- used for TreeSync local steps."""
from __future__ import annotations

import torch

from repro_torch.optim.api import (Optimizer, as_rate, put, tree_leaves,
                                   tree_unflatten, zeros_f32)


def make_sgd(lr: float = 0.1, momentum: float = 0.9,
             nesterov: bool = False) -> Optimizer:
    base_lr = lr

    def init(params):
        first = tree_leaves(params)[0]
        step = torch.zeros((), dtype=torch.int32, device=first.device)
        if momentum == 0.0:
            return {"step": step, "mom": None}
        return {"step": step,
                "mom": tree_unflatten(params, [zeros_f32(p) for p in
                                               tree_leaves(params)])}

    @torch.no_grad()
    def update(params, grads, state, lr=None, inplace=False, shards=None):
        # elementwise: shards (a sharded step's LeafShards) change nothing
        # lr=None -> the constructor rate; a float or 0-d tensor overrides
        flat_p = tree_leaves(params)
        flat_g = tree_leaves(grads)
        lr_t = base_lr if lr is None else as_rate(lr, flat_p[0])
        step = state["step"] + 1
        if momentum == 0.0:
            new_p = [put(p, p.float() - lr_t * g.float(), inplace)
                     for p, g in zip(flat_p, flat_g, strict=True)]
            return tree_unflatten(params, new_p), {"step": step, "mom": None}

        new_p, new_m = [], []
        for p, g, m in zip(flat_p, flat_g, tree_leaves(state["mom"]),
                           strict=True):
            g = g.float()
            m_new = momentum * m + g
            d = g + momentum * m_new if nesterov else m_new
            new_p.append(put(p, p.float() - lr_t * d, inplace))
            new_m.append(put(m, m_new, inplace))
        return (tree_unflatten(params, new_p),
                {"step": step, "mom": tree_unflatten(params, new_m)})

    return Optimizer("sgd", init, update)
