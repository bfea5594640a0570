"""Feed-forward layers: SwiGLU / GELU MLPs and capacity-based top-k MoE
(the JAX package's ``models/mlp.py``).

The MoE dispatches tokens by scatter (GShard-style, static capacity):
each kept (token, expert) assignment is written into an (E, C, D) buffer,
the experts run as three batched products, and the results are gathered
back with the combine weights.  Routing follows the reference exactly:
the router in float32, top-k with ties to the lower expert index, the
position inside an expert a cumulative sum over the flattened (token, k)
order, assignments past the capacity dropped.

With the batch rows split over a shard context's batch axes (FSDP, ``model``
= 1), the routing is the whole batch's, as in the reference's global
program: the capacity counts every rank's tokens, an assignment's slot
counts the assignments of the ranks holding earlier rows (the gathered
per-expert counts), and the load-balance loss's fractions and mean
probabilities are sums over the batch axes.  Each rank dispatches its own
tokens into the global slots.

Expert parallel (the specs split the expert dim over ``model``): the
activations are whole on every rank of ``model``, and so is the routing --
every rank computes the same probabilities, capacity, slots and
load-balance loss (the loss is whole on each rank: it is not summed over
``model``).  Each rank then dispatches into, runs and combines only its
own E/m experts' assignments, and the partial outputs are summed over
``model``.  The token rows and the normalized gate weights enter that
share of the work through ``copy_to_model``, so their gradients -- and
through them the router's and the input's -- are the sums of every
rank's share.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import shardctx
from repro_torch.models.common import dense_init, split_keys

Tensor = torch.Tensor


def gelu(x: Tensor) -> Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


# ---------------------------------------------------------------------------
# dense MLPs
# ---------------------------------------------------------------------------
def init_mlp_params(key, cfg: ModelConfig, dtype,
                    d_ff: Optional[int] = None, device=None):
    """Three keys from ``key``, used in the reference's order, on
    ``device`` (the key's by default)."""
    d, f = cfg.d_model, d_ff or cfg.d_ff
    ks = split_keys(key, 3)
    if cfg.mlp_type == "swiglu":
        return {
            "w_gate": dense_init(ks[0], (d, f), dtype, device=device),
            "w_up": dense_init(ks[1], (d, f), dtype, device=device),
            "w_down": dense_init(ks[2], (f, d), dtype, device=device),
        }
    return {
        "w_up": dense_init(ks[0], (d, f), dtype, device=device),
        "w_down": dense_init(ks[1], (f, d), dtype, device=device),
    }


def mlp(p, cfg: ModelConfig, x: Tensor, leaf: Tuple[str, ...] = ("ffn",)
        ) -> Tensor:
    """The dense MLP (``leaf``: its parameters' path, ``("ffn", "dense")``
    inside an MoE layer).  Under tensor parallelism
    (``models/shardctx.py``) ``w_gate``/``w_up`` are column-parallel and
    ``w_down`` row-parallel over the hidden dim when the specs split
    ``w_up``'s; the partial sums are reduced over ``model``."""
    tp = shardctx.split_over_model(cfg, leaf + ("w_up",), -1)
    if tp:
        x = shardctx.copy_to_model(x)
        p = {n: shardctx.model_share(cfg, leaf + (n,), t,
                                     0 if n == "w_down" else -1)
             for n, t in p.items()}
    if cfg.mlp_type == "swiglu":
        out = (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
    else:
        out = gelu(x @ p["w_up"]) @ p["w_down"]
    return shardctx.reduce_from_model(out) if tp else out


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------
def init_moe_params(key, cfg: ModelConfig, dtype, device=None):
    """Five keys from ``key`` in the reference's order: router (float32),
    the three expert weights (E, d, f) / (E, f, d), and the dense residual
    MLP when ``cfg.moe_dense_ff`` (arctic)."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    ks = split_keys(key, 5)
    p = {
        "router": dense_init(ks[0], (d, e), torch.float32, device=device),
        "w_gate": dense_init(ks[1], (e, d, f), dtype, device=device),
        "w_up": dense_init(ks[2], (e, d, f), dtype, device=device),
        "w_down": dense_init(ks[3], (e, f, d), dtype, device=device),
    }
    if cfg.moe_dense_ff:
        p["dense"] = init_mlp_params(ks[4], cfg, dtype,
                                     d_ff=cfg.moe_dense_ff, device=device)
    return p


def capacity(cfg: ModelConfig, tokens: int) -> int:
    """Slots per expert for ``tokens`` tokens: the reference's
    ``max(int(capacity_factor * T * K / E), 1)`` in Python float
    arithmetic.  A decode step has T = batch, so C is small there and the
    reference drops most assignments; so does the port."""
    return max(int(cfg.capacity_factor * tokens * cfg.experts_per_token
                   / cfg.num_experts), 1)


def route(p, cfg: ModelConfig, xf: Tensor
          ) -> Tuple[Tensor, Tensor, Tensor]:
    """xf: (T, D) -> (probs (T, E), gate_w (T, K), gate_idx (T, K)).

    The router runs in float32 (the reference promotes the activation-
    dtype router weight to float32 there).  ``jax.lax.top_k`` takes the K
    largest with ties to the lower index; a stable descending sort does
    the same, where ``torch.topk`` promises no order for ties."""
    logits = xf.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    order = torch.sort(probs, dim=-1, descending=True, stable=True).indices
    gate_idx = order[:, : cfg.experts_per_token]
    return probs, torch.gather(probs, -1, gate_idx), gate_idx


def slots(gate_idx: Tensor, num_experts: int, cap: int,
          before: Optional[Tensor] = None) -> Tuple[Tensor, Tensor, Tensor]:
    """The flattened (token, k) assignments -> (expert ids, slot in the
    expert clipped to [0, cap), keep mask): an assignment's position is
    the count of earlier assignments to its expert in (token, k) order
    (plus ``before[e]``, the assignments to expert e in earlier rows held
    elsewhere), and those at or past ``cap`` are dropped."""
    eids = gate_idx.reshape(-1)
    onehot = F.one_hot(eids, num_experts)
    pos = (torch.cumsum(onehot, dim=0) * onehot).sum(-1) - 1
    if before is not None:
        pos = pos + before[eids]
    keep = (pos < cap) & (pos >= 0)
    return eids, torch.clamp(pos, 0, cap - 1), keep


def moe(p, cfg: ModelConfig, x: Tensor) -> Tuple[Tensor, Tensor]:
    """x: (B, S, D) -> ((B, S, D), aux_loss).  Top-k routing, static
    capacity, scatter dispatch; optional parallel dense residual branch
    (arctic).  The Switch-style load-balance loss shares the routing
    decision."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    T = B * S
    xf = x.reshape(T, D)

    probs, gate_w, gate_idx = route(p, cfg, xf)
    onehot = F.one_hot(gate_idx, E)
    chunk, chunks = shardctx.batch_rows()
    before = None
    if chunks == 1:
        frac = torch.mean(onehot.float(), dim=(0, 1))
        aux = E * torch.sum(frac * torch.mean(probs, dim=0))
        C = capacity(cfg, T)
    else:   # the whole batch's routing (see the module docstring)
        counts = onehot.sum(dim=(0, 1))
        every = shardctx.gather_from_batch(counts[None], 0)   # (chunks, E)
        before = every[:chunk].sum(0)
        T_all = T * chunks
        frac = every.sum(0).float() / (T_all * K)
        aux = E * torch.sum(
            frac * shardctx.reduce_from_batch(probs.sum(0)) / T_all)
        C = capacity(cfg, T_all)
    gate_w = gate_w / (torch.sum(gate_w, dim=-1, keepdim=True) + 1e-9)

    eids, slot, keep = slots(gate_idx, E, C, before)
    e0, n_exp = shardctx.expert_range(cfg)
    ep = n_exp != E
    w = {n: p[n] for n in ("w_gate", "w_up", "w_down")}
    xd = xf
    if ep:   # this rank's experts only (see the module docstring)
        xd = shardctx.copy_to_model(xf)
        gate_w = shardctx.copy_to_model(gate_w)
        keep = keep & (eids >= e0) & (eids < e0 + n_exp)
        w = {n: shardctx.model_share(cfg, ("ffn", n), t, 0)
             for n, t in w.items()}
    # kept (expert, slot) pairs are unique, so writing the kept rows is the
    # reference's scatter-add into zeros; dropped rows (and other ranks'
    # experts') go to a spare row past the buffer, which is cut off
    row = (eids - e0) * C + slot
    flat = torch.where(keep, row, n_exp * C)
    tok_rep = torch.repeat_interleave(xd, K, dim=0)
    buf = x.new_zeros((n_exp * C + 1, D)).index_copy(0, flat, tok_rep)
    buf = buf[: n_exp * C].view(n_exp, C, D)

    # batched expert FFN: (E, C, D) x (E, D, F)
    h = F.silu(torch.bmm(buf, w["w_gate"])) * torch.bmm(buf, w["w_up"])
    out_buf = torch.bmm(h, w["w_down"]).reshape(n_exp * C, D)

    # gather back and combine
    out_tok = out_buf[torch.where(keep, row, 0)] * keep[:, None].to(x.dtype)
    out = (out_tok.reshape(T, K, D) * gate_w[..., None].to(x.dtype)).sum(1)
    if ep:
        out = shardctx.reduce_from_model(out)
    if cfg.moe_dense_ff:
        out = out + mlp(p["dense"], cfg, xf, leaf=("ffn", "dense"))
    return out.reshape(B, S, D), aux


def ffn(p, cfg: ModelConfig, x: Tensor) -> Tuple[Tensor, Tensor]:
    """Returns (out, moe_aux_loss); aux is 0 for dense FFNs."""
    if cfg.is_moe:
        return moe(p, cfg, x)
    return mlp(p, cfg, x), torch.zeros((), dtype=torch.float32,
                                       device=x.device)


def init_ffn_params(key, cfg: ModelConfig, dtype, device=None):
    if cfg.is_moe:
        return init_moe_params(key, cfg, dtype, device=device)
    return init_mlp_params(key, cfg, dtype, device=device)
