"""Feed-forward layers: the dense SwiGLU / GELU MLPs of the JAX package's
``models/mlp.py``.  Its capacity-based top-k MoE is not ported yet."""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import dense_init

Tensor = torch.Tensor

_MOE = ("mixture-of-experts FFNs are not ported yet (ROADMAP A9: dbrx-132b "
        "and arctic-480b come after the dense architectures)")


def gelu(x: Tensor) -> Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def init_mlp_params(gen: torch.Generator, cfg: ModelConfig, dtype,
                    d_ff: Optional[int] = None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    if cfg.mlp_type == "swiglu":
        return {
            "w_gate": dense_init(gen, (d, f), dtype),
            "w_up": dense_init(gen, (d, f), dtype),
            "w_down": dense_init(gen, (f, d), dtype),
        }
    return {
        "w_up": dense_init(gen, (d, f), dtype),
        "w_down": dense_init(gen, (f, d), dtype),
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


def init_ffn_params(gen: torch.Generator, cfg: ModelConfig, dtype):
    if cfg.is_moe:
        raise NotImplementedError(_MOE)
    return init_mlp_params(gen, cfg, dtype)
