"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427), the
JAX package's ``models/rglru.py``.

Block:  x -> [in-proj -> causal conv1d(w=4) -> RG-LRU] * gelu(gate-proj)
          -> out-proj

RG-LRU:  r_t = sigmoid(x_t W_a);  i_t = sigmoid(x_t W_x)
         a_t = exp(-c * softplus(Lambda) * r_t)          (c = 8)
         h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Over a sequence the recurrence h_t = a_t h_{t-1} + b_t (h_0 = 0) runs in
``kernels.rglru.ops.rglru_scan`` -- the hand-written kernel on the card --
where the reference uses ``jax.lax.associative_scan``; its backward is
the same kernel run in reverse time.  Decode carries
(h, conv tail) state, O(1) per token.

Under tensor parallelism (``models/shardctx.py``) the channels W are split
over ``model`` where the specs split them: ``w_in``, ``w_gate`` and
``conv`` are column-parallel, the conv output is gathered over ``model``
before the dense (W, W) gate GEMMs ``w_a``/``w_x`` (whose outputs are
column-split), the recurrence runs on the local (B, S, W/tp) channels
(the kernel, and in training ``RGLRUScan``), and ``w_out`` is
row-parallel with its partial sums reduced over ``model``.  A leaf that
fell back to replicated is cut to the local channels at use.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rglru.ops import rglru_scan
from repro_torch.kernels.rglru.ref import rglru_scan_ref
from repro_torch.models import shardctx
from repro_torch.models.common import dense_init, split_keys
from repro_torch.models.mlp import gelu

Tensor = torch.Tensor
_C = 8.0


def init_rglru_params(key, cfg: ModelConfig, dtype, device=None):
    """Six keys from ``key``, used in the reference's order, on ``device``
    (the key's by default)."""
    d, w = cfg.d_model, cfg.lru_width
    ks = split_keys(key, 6)
    dev = key.device if device is None else torch.device(device)
    return {
        "w_in": dense_init(ks[0], (d, w), dtype, device=dev),
        "w_gate": dense_init(ks[1], (d, w), dtype, device=dev),
        "conv": dense_init(ks[2], (cfg.conv_width, w), dtype, scale=0.1,
                           device=dev),
        "w_a": dense_init(ks[3], (w, w), dtype, device=dev),
        "w_x": dense_init(ks[4], (w, w), dtype, device=dev),
        # Lambda parametrized so softplus(lam) spreads decays in (0.9, 0.999)
        "lam": linspace(-2.0, 2.0, w, dev),
        "w_out": dense_init(ks[5], (w, d), dtype, device=dev),
    }


def linspace(start: float, stop: float, num: int, device) -> Tensor:
    """``jnp.linspace(start, stop, num)`` in float32 as XLA compiles it:
    ``start * (1 - s) + stop * s`` with ``s = i * float32(1 / (num -
    1))`` (the division becomes a product by the reciprocal), the last
    point ``stop`` itself.  XLA also fuses some of these products into
    multiply-adds, differently with the vector width, so points near 0
    agree to an ulp of the endpoints, not of the point."""
    if num < 2:
        return torch.full((num,), start, dtype=torch.float32, device=device)
    div = num - 1
    s = torch.arange(div, dtype=torch.float32, device=device) * float(
        np.float32(1.0 / div))
    out = start * (1.0 - s) + stop * s
    return torch.cat([out, torch.full((1,), stop, dtype=torch.float32,
                                      device=device)])


# the leaves with a channel dim, and which dim it is
_CHANNEL_DIMS = {"w_in": -1, "w_gate": -1, "conv": -1, "w_a": -1, "w_x": -1,
                 "lam": -1, "w_out": 0}


def local_channels(p, cfg: ModelConfig):
    """(``p`` over this rank's channels, whether they are split): split
    when the specs split ``w_in``'s channels over ``model``; the leaves
    as their specs cut them, a replicated one cut at use."""
    if not shardctx.split_over_model(cfg, ("mix", "w_in"), -1):
        return p, False
    return {n: (shardctx.model_share(cfg, ("mix", n), t, _CHANNEL_DIMS[n])
                if n in _CHANNEL_DIMS else t) for n, t in p.items()}, True


def _gates(p, u: Tensor, u_all: Tensor = None) -> Tuple[Tensor, Tensor]:
    """u: (..., W) conv output -> (a_t, b_t) of the recurrence, float32.
    Under tensor parallelism u is this rank's channels and ``u_all`` every
    channel (the gate GEMMs' input).

    ``p["lam"]`` arrives in the activation dtype (``cast_floats`` rounds it
    as the reference does), so softplus runs in that dtype.  ``F.softplus``
    returns x above its threshold of 20 where ``jax.nn.softplus`` computes
    logaddexp(x, 0); the two differ by under 1e-8 there, and lam lies in
    [-2, 2] anyway."""
    uf = u.float()
    gf = uf if u_all is None else u_all.float()
    r = torch.sigmoid(gf @ p["w_a"].float())
    i = torch.sigmoid(gf @ p["w_x"].float())
    log_a = -_C * F.softplus(p["lam"]) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) * (
        i * uf)
    return a, b


def linear_recurrence(a: Tensor, b: Tensor, plain: bool = False) -> Tensor:
    """h_t = a_t h_{t-1} + b_t along dim 1 (time), h_0 = 0: the kernel op,
    or with ``plain=True`` its plain version on any device."""
    h0 = torch.zeros((a.shape[0], a.shape[2]), dtype=a.dtype, device=a.device)
    if plain:
        return rglru_scan_ref(a, b, h0)[0]
    return rglru_scan(a, b, h0)[0]


def causal_conv(u: Tensor, conv: Tensor) -> Tuple[Tensor, Tensor]:
    """Causal conv1d of width cw over time: returns (conv output, the
    left-padded input).  A Python sum in u's dtype, term i = 0..cw-1 in
    order, as the reference's prefill writes it."""
    cw, S = conv.shape[0], u.shape[1]
    padded = F.pad(u, (0, 0, cw - 1, 0))
    out = sum(padded[:, i: i + S] * conv[i] for i in range(cw))
    return out, padded


def rglru_block(p, cfg: ModelConfig, x: Tensor, plain: bool = False
                ) -> Tensor:
    """x: (B, S, D) -> (B, S, D), parallel over channels; differentiable
    through the kernel (``kernels.rglru.ops.RGLRUScan``), or with
    ``plain=True`` through the plain recurrence."""
    p, tp = local_channels(p, cfg)
    if tp:
        x = shardctx.copy_to_model(x)
    u = x @ p["w_in"]  # (B, S, W)
    gate = gelu(x @ p["w_gate"])
    conv, _ = causal_conv(u, p["conv"])
    a, b = _gates(p, conv, shardctx.gather_from_model(conv, -1)
                  if tp else None)
    h = linear_recurrence(a, b, plain).to(x.dtype)
    out = (h * gate) @ p["w_out"]
    return shardctx.reduce_from_model(out) if tp else out


def init_rglru_cache(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device="cuda"):
    return {
        "h": torch.zeros((batch, cfg.lru_width), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, cfg.lru_width),
                            dtype=dtype, device=device),
    }


def rglru_decode(p, cfg: ModelConfig, x: Tensor, cache: dict
                 ) -> Tuple[Tensor, dict]:
    """x: (B, 1, D) -> (B, 1, D); O(1) state update.  The conv is the
    reference's einsum over the cw taps: summed in float32, rounded once
    to x's dtype.  The cache holds this rank's channels."""
    p, tp = local_channels(p, cfg)
    u = (x @ p["w_in"])[:, 0]  # (B, W)
    gate = gelu(x @ p["w_gate"])[:, 0]
    hist = torch.cat([cache["conv"], u[:, None]], dim=1)  # (B, cw, W)
    conv = torch.einsum("bcw,cw->bw", hist.float(),
                        p["conv"].float()).to(hist.dtype)
    a, b = _gates(p, conv, shardctx.gather_from_model(conv, -1)
                  if tp else None)
    h = a * cache["h"] + b
    out = ((h.to(x.dtype) * gate) @ p["w_out"])[:, None]
    if tp:
        out = shardctx.reduce_from_model(out)
    return out, {"h": h, "conv": hist[:, 1:]}
