"""Feed-forward layers: the dense SwiGLU / GELU MLPs of the JAX package's
``models/mlp.py``.  Its capacity-based top-k MoE is not ported yet."""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import dense_init, split_keys

Tensor = torch.Tensor

_MOE = ("mixture-of-experts FFNs are not ported yet (ROADMAP A9: dbrx-132b "
        "and arctic-480b come after the dense architectures)")


def gelu(x: Tensor) -> Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


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


def mlp(p, cfg: ModelConfig, x: Tensor) -> Tensor:
    if cfg.mlp_type == "swiglu":
        return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
    return gelu(x @ p["w_up"]) @ p["w_down"]


def ffn(p, cfg: ModelConfig, x: Tensor) -> Tuple[Tensor, Tensor]:
    """Returns (out, moe_aux_loss); aux is 0 for dense FFNs."""
    if cfg.is_moe:
        raise NotImplementedError(_MOE)
    return mlp(p, cfg, x), torch.zeros((), dtype=torch.float32,
                                       device=x.device)


def init_ffn_params(key, cfg: ModelConfig, dtype, device=None):
    if cfg.is_moe:
        raise NotImplementedError(_MOE)
    return init_mlp_params(key, cfg, dtype, device=device)
