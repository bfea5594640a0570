"""Adafactor (Shazeer & Stern 2018): factored second moments.

Parameters with >= 2 dims (and both trailing dims >= min_dim_size_to_factor)
store only row/col mean accumulators -- O(n+m) instead of O(nm).
Implements the standard pieces: pow decay, RMS update clipping, relative
step-size scaling.  The RMS clip and the relative step are taken over a
whole leaf, so a stacked leaf (the reference's ``blocks``, one leading
entry per block) is scaled as one tensor, as there.

A leaf is updated in row blocks of about ``ROW_BLOCK`` elements: the
second moments in one pass, the update's RMS and the parameter's RMS in
a second, the step in a third (the update recomputed, never stored), so
no temporary of a leaf's size exists -- a 2.4 GiB embedding's update
takes a few hundred MiB.  The whole-leaf sums add the blocks' partial
sums in order, where the reference reduces each leaf at once: the same
numbers to float32 rounding.

On shards (``shards=``, one ``models/shardctx.py::LeafShard`` per leaf,
cut by ``opt_state_specs``) every mean and sum that runs over a dim some
mesh axis splits is completed over those axes: the row means of ``vr``
(over the columns), the column means of ``vc`` (over the rows), ``vr``'s
own mean, and the update's and the parameter's RMS (over the whole leaf);
whether a leaf is factored and every count are taken on its global shape.
Unsharded, each reduces as it did.
"""
from __future__ import annotations

import torch

from repro_torch.optim.api import (Optimizer, as_rate, tree_leaves,
                                   tree_unflatten)

ROW_BLOCK = 1 << 24       # elements of one row block


def _factored(shape, min_size: int) -> bool:
    return len(shape) >= 2 and shape[-1] >= min_size and shape[-2] >= min_size


def _is_state(x) -> bool:
    return isinstance(x, dict) and ("v" in x or "vr" in x)


def _blocks(p: torch.Tensor):
    """``p`` viewed as L matrices (R, C) (the trailing two dims; a 1-D
    leaf is one (n, 1) matrix) and the row blocks of each."""
    C = p.shape[-1] if p.dim() >= 2 else 1
    R = p.shape[-2] if p.dim() >= 2 else p.numel()
    L = max(p.numel() // max(R * C, 1), 1)
    rb = max(1, ROW_BLOCK // max(C, 1))
    return (L, R, C), [(l, slice(s, min(R, s + rb)))
                       for l in range(L) for s in range(0, R, rb)]


def make_adafactor(
    lr: float = 1e-3,
    decay_pow: float = 0.8,
    clip_threshold: float = 1.0,
    eps1: float = 1e-30,
    eps2: float = 1e-3,
    min_dim_size_to_factor: int = 128,
    weight_decay: float = 0.0,
) -> Optimizer:
    base_lr = lr

    def init(params):
        def leaf_state(p):
            kw = dict(dtype=torch.float32, device=p.device)
            if _factored(p.shape, min_dim_size_to_factor):
                return {"vr": torch.zeros(p.shape[:-1], **kw),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **kw)}
            return {"v": torch.zeros(p.shape, **kw)}

        flat = tree_leaves(params)
        return {
            "step": torch.zeros((), dtype=torch.int32, device=flat[0].device),
            "v": tree_unflatten(params, [leaf_state(p) for p in flat]),
        }

    def upd(p, g, s, beta2, lr_t, inplace, sh=None):
        shape, blocks = _blocks(p)
        p3 = p.reshape(shape)
        g3 = g.reshape(shape)
        gshape = p.shape if sh is None else sh.shape
        factored = _factored(gshape, min_dim_size_to_factor)

        def done(x, dims, local, total):
            """A mean over this rank's ``local`` of ``total`` entries of
            the leaf's ``dims``, completed over the axes splitting them."""
            if sh is None or local == total:
                return x
            return sh.sum(x * (local / total), dims)

        # pass 1: the second moments
        if factored:
            rmean = torch.empty(shape[:2], dtype=torch.float32,
                                device=p.device)
            col = torch.zeros((shape[0], shape[2]), dtype=torch.float32,
                              device=p.device)
            for l, rows in blocks:
                g2 = torch.square(g3[l, rows].float()) + eps1
                rmean[l, rows] = torch.mean(g2, dim=-1)
                col[l] += torch.sum(g2, dim=0)
            rmean = done(rmean, (-1,), shape[2], gshape[-1])
            if sh is not None:
                col = sh.sum(col, (-2,))
            vr = beta2 * s["vr"].reshape(shape[:2]) + (1 - beta2) * rmean
            vc = (beta2 * s["vc"].reshape(shape[0], shape[2])
                  + (1 - beta2) * (col / gshape[-2]))
            # rank-1 reconstruction of the second moment
            denom = done(torch.mean(vr, dim=-1, keepdim=True), (-2,),
                         shape[1], gshape[-2])
            ra = torch.rsqrt(vr / torch.clamp(denom, min=eps1))
            rb = torch.rsqrt(vc)
            new_s = {"vr": vr.reshape(s["vr"].shape),
                     "vc": vc.reshape(s["vc"].shape)}

            def u_of(l, rows):
                return (g3[l, rows].float() * ra[l, rows, None]
                        * rb[l, None, :])
        else:
            v = torch.empty(shape, dtype=torch.float32, device=p.device)
            v_old = s["v"].reshape(shape)
            for l, rows in blocks:
                g2 = torch.square(g3[l, rows].float()) + eps1
                v[l, rows] = beta2 * v_old[l, rows] + (1 - beta2) * g2
            new_s = {"v": v.reshape(s["v"].shape)}

            def u_of(l, rows):
                return g3[l, rows].float() * torch.rsqrt(v[l, rows])
        # pass 2: the update's RMS (for the clip) and the parameter's
        u_sq = torch.zeros((), dtype=torch.float32, device=p.device)
        p_sq = torch.zeros((), dtype=torch.float32, device=p.device)
        for l, rows in blocks:
            u = u_of(l, rows)
            u_sq = u_sq + torch.sum(u * u)
            pf = p3[l, rows].float()
            p_sq = p_sq + torch.sum(pf * pf)
        n = p.numel()
        if sh is not None:
            n = 1
            for d in gshape:
                n *= d
            u_sq, p_sq = sh.sum(u_sq), sh.sum(p_sq)
        rms = torch.sqrt(u_sq / n + eps1)
        clip = torch.clamp(rms / clip_threshold, min=1.0)
        # relative step size (scaled by param RMS, floored at eps2)
        step_size = lr_t * torch.clamp(torch.sqrt(p_sq / n), min=eps2)
        # pass 3: the step
        out = p if inplace else torch.empty_like(p)
        out3 = out.reshape(shape)
        for l, rows in blocks:
            pf = p3[l, rows].float() - step_size * (u_of(l, rows) / clip)
            if weight_decay and p.dim() >= 2:
                pf = pf - lr_t * weight_decay * pf
            out3[l, rows] = pf.to(p.dtype)
        if inplace:
            for k in new_s:
                s[k].copy_(new_s[k])
            new_s = s
        return out, new_s

    @torch.no_grad()
    def update(params, grads, state, lr=None, inplace=False, shards=None):
        flat_p = tree_leaves(params)
        flat_g = tree_leaves(grads)
        flat_s = tree_leaves(state["v"], is_leaf=_is_state)
        step = state["step"] + 1
        stepf = step.float()
        beta2 = 1.0 - stepf ** (-decay_pow)
        # lr=None -> the constructor rate; a float or 0-d tensor overrides
        lr_t = base_lr if lr is None else as_rate(lr, flat_p[0])

        out = [upd(p, g, s, beta2, lr_t, inplace,
                   None if shards is None else shards[i])
               for i, (p, g, s) in enumerate(zip(flat_p, flat_g, flat_s,
                                                 strict=True))]
        return (tree_unflatten(params, [o[0] for o in out]),
                {"step": step,
                 "v": tree_unflatten(state["v"], [o[1] for o in out],
                                     is_leaf=_is_state)})

    return Optimizer("adafactor", init, update)
