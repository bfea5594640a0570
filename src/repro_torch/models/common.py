"""Shared model primitives: norms, rotary embeddings, init helpers (the JAX
package's ``models/common.py``)."""
from __future__ import annotations

from typing import List, Optional

import torch

from repro_torch.core import prng

Tensor = torch.Tensor


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


def rms_norm(x: Tensor, scale: Tensor, eps: float = 1e-6) -> Tensor:
    """RMS norm with a ``(1 + scale)`` gain, in float32 inside."""
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(dt)


def rope(x: Tensor, positions: Tensor, theta: float = 10_000.0) -> Tensor:
    """Rotary embedding, half-split rotation with float32 angles.
    x: (..., S, H, hd); positions: (..., S) int."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., None].float() * freq        # (..., S, half)
    ang = ang[..., None, :]                          # (..., S, 1, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    xr1 = x1 * cos - x2 * sin
    xr2 = x2 * cos + x1 * sin
    return torch.cat([xr1, xr2], dim=-1).to(x.dtype)


def dense_init(key: Tensor, shape, dtype, scale: Optional[float] = None,
               device=None) -> Tensor:
    """``(jax.random.normal(key, shape) * scale).astype(dtype)``, scale
    defaulting to fan_in^-1/2, on ``device`` (the key's by default): the
    reference's draw from the same threefry key, within a few float32 ulp
    (``core/prng.py::normal``), drawn in row blocks."""
    fan_in = shape[0] if len(shape) >= 2 else shape[-1]
    s = scale if scale is not None else fan_in ** -0.5
    return prng.normal_blocked(key, shape, device=device, dtype=dtype,
                               scale=s)


def split_keys(key: Tensor, n: int) -> List[Tensor]:
    """``list(jax.random.split(key, n))``."""
    return list(prng.split(key, n))


def cast_floats(tree, dtype):
    """Cast float leaves to ``dtype`` (mixed precision: f32 master weights
    are cast to the activation dtype at use; sensitive paths re-cast to f32
    internally)."""
    if isinstance(tree, dict):
        return {k: cast_floats(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_floats(v, dtype) for v in tree)
    if isinstance(tree, Tensor) and tree.is_floating_point():
        return tree.to(dtype)
    return tree

