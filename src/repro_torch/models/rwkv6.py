"""RWKV-6 "Finch" (arXiv:2404.05892): attention-free token / channel mixing
with data-dependent decay (the JAX package's ``models/rwkv6.py``).

Time mixing (per head, head_dim = N):
    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
with w_t = exp(-exp(w0 + lora_w(x~_t))) (data-dependent decay), and
data-dependent token-shift interpolation (ddlerp) on the r/k/v/w/g inputs.

Training and prefill run the *chunked* parallel form: within a chunk of
CHUNK steps the products are dense, and a Python loop carries the (N, N)
state from chunk to chunk (the reference's ``lax.scan``).  Decode carries
(state, shift) -- O(1) per token.

Numerics: the per-step log-decay is clamped to [-4, -1e-4] and chunks are
16 long, so every ``exp`` stays inside the float32 range (``exp(-lw) <=
e^64``).  Sub-layer weights arrive in the activation dtype
(``transformer.cast_floats``); where the reference then multiplies a
float32 tensor by a bfloat16 weight, jnp promotes the weight to float32,
and the port upcasts it at the same places (``torch.matmul`` refuses
mixed dtypes).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import dense_init, rms_norm, split_keys
from repro_torch.models.rglru import linspace

Tensor = torch.Tensor

CHUNK = 16
LORA_RANK = 64
MIX_LORA_RANK = 32
LOG_W_MIN, LOG_W_MAX = -4.0, -1e-4


def init_rwkv_params(key, cfg: ModelConfig, dtype, device=None):
    """Twelve keys from ``key``, used in the reference's order, on
    ``device`` (the key's by default).  ``w0`` is the reference's
    ``jnp.linspace(-1.5, 1.5, d)`` as XLA compiles it
    (``rglru.linspace``): equal to an ulp of its endpoints."""
    d = cfg.d_model
    n_heads = d // cfg.rwkv_head_dim
    ks = split_keys(key, 12)
    dev = key.device if device is None else torch.device(device)
    f32 = torch.float32

    def full(shape, value):
        return torch.full(shape, value, dtype=f32, device=dev)

    return {
        # time mix
        "mu": full((5, d), 0.5),
        "mix_lora_a": dense_init(ks[0], (d, 5 * MIX_LORA_RANK), f32,
                                 device=dev),
        "mix_lora_b": dense_init(ks[1], (5, MIX_LORA_RANK, d), f32,
                                 scale=0.01, device=dev),
        "wr": dense_init(ks[2], (d, d), dtype, device=dev),
        "wk": dense_init(ks[3], (d, d), dtype, device=dev),
        "wv": dense_init(ks[4], (d, d), dtype, device=dev),
        "wg": dense_init(ks[5], (d, d), dtype, device=dev),
        "wo": dense_init(ks[6], (d, d), dtype, device=dev),
        "w0": linspace(-1.5, 1.5, d, dev),
        "w_lora_a": dense_init(ks[7], (d, LORA_RANK), f32, device=dev),
        "w_lora_b": dense_init(ks[8], (LORA_RANK, d), f32, scale=0.01,
                               device=dev),
        "u": full((n_heads, cfg.rwkv_head_dim), 0.1),
        "ln_x": torch.zeros((d,), dtype=f32, device=dev),
        # channel mix
        "cm_mu_k": full((d,), 0.5),
        "cm_mu_r": full((d,), 0.5),
        "cm_wk": dense_init(ks[9], (d, cfg.d_ff), dtype, device=dev),
        "cm_wv": dense_init(ks[10], (cfg.d_ff, d), dtype, device=dev),
        "cm_wr": dense_init(ks[11], (d, d), dtype, device=dev),
    }


def _shift(x: Tensor) -> Tensor:
    """x_{t-1} along dim 1, zero at t = 0."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def _ddlerp(p, x: Tensor, x_prev: Tensor) -> Tensor:
    """Data-dependent token-shift: one mixed input per r/k/v/w/g stream,
    stacked as (5, B, S, D)."""
    dx = x_prev - x
    base = x + dx * p["mu"][:, None, None, :]
    lora = torch.tanh((x + dx * 0.5) @ p["mix_lora_a"])   # (B, S, 5 R)
    B, S, _ = x.shape
    lora = lora.reshape(B, S, 5, MIX_LORA_RANK).permute(2, 0, 1, 3)
    adj = torch.einsum("nbsr,nrd->nbsd", lora, p["mix_lora_b"])
    return base + adj * dx


def _log_decay(p, xw: Tensor) -> Tensor:
    """log w_t in [LOG_W_MIN, LOG_W_MAX], float32; xw: (B, S, D)."""
    lora = (torch.tanh(xw.float() @ p["w_lora_a"].float())
            @ p["w_lora_b"].float())
    return torch.clamp(-torch.exp(p["w0"].float() + lora), LOG_W_MIN,
                       LOG_W_MAX)


def _wkv_chunk(state: Tensor, rr: Tensor, kk: Tensor, vv: Tensor,
               lwst: Tensor, u: Tensor, below: Tensor
               ) -> Tuple[Tensor, Tensor]:
    """One chunk of the WKV recurrence: (B, H, n, N) inputs and the
    carried (B, H, N, N) state -> (new state, y (B, H, n, N))."""
    lw = torch.cumsum(lwst, dim=2)          # within-chunk cumulative decay
    lw_prev = lw - lwst                     # lw_{t-1} (zero at t = 0)
    q_t = rr * torch.exp(lw_prev)
    k_t = kk * torch.exp(-lw)
    inter = q_t @ state                                 # bhin,bhnm->bhim
    scores = torch.where(below, q_t @ k_t.transpose(-1, -2), 0.0)
    diag = torch.sum(rr * (u[None, :, None, :] * kk), dim=-1)
    y = scores @ vv + diag[..., None] * vv + inter
    lw_n = lw[:, :, -1:, :]                 # (B, H, 1, N)
    k_rem = kk * torch.exp(lw_n - lw)
    new_state = (torch.exp(lw_n[:, :, 0, :, None]) * state
                 + k_rem.transpose(-1, -2) @ vv)        # bhjn,bhjm->bhnm
    return new_state, y


def wkv_chunked_with_state(r: Tensor, k: Tensor, v: Tensor, log_w: Tensor,
                           u: Tensor) -> Tuple[Tensor, Tensor]:
    """r/k/v/log_w: (B, H, S, N) float32; u: (H, N).  Returns (y (B, H,
    S, N), the terminal (B, H, N, N) state).  S must be a multiple of
    CHUNK (or shorter than one chunk): the reference's ``_wkv_chunked``
    asserts it, and its prefill's copy fails in a reshape."""
    B, H, S, N = r.shape
    n = min(CHUNK, S)
    if S % n:
        raise ValueError(f"the chunked WKV needs S a multiple of {CHUNK} "
                         f"(or S < {CHUNK}), got S = {S}")
    nc = S // n
    rc, kc, vc, wc = (t.reshape(B, H, nc, n, N) for t in (r, k, v, log_w))
    below = torch.tril(torch.ones((n, n), dtype=torch.bool, device=r.device),
                       diagonal=-1)
    state = torch.zeros((B, H, N, N), dtype=torch.float32, device=r.device)
    ys = []
    for c in range(nc):
        state, y = _wkv_chunk(state, rc[:, :, c], kc[:, :, c], vc[:, :, c],
                              wc[:, :, c], u, below)
        ys.append(y)
    return torch.stack(ys, dim=2).reshape(B, H, S, N), state


def _wkv_chunked(r, k, v, log_w, u) -> Tensor:
    """r/k/v/log_w: (B, H, S, N); u: (H, N).  Returns (B, H, S, N)."""
    return wkv_chunked_with_state(r, k, v, log_w, u)[0]


def _heads(x: Tensor, H: int, N: int) -> Tensor:
    B, S, _ = x.shape
    return x.reshape(B, S, H, N).transpose(1, 2)


def _time_mix_inputs(p, cfg: ModelConfig, x: Tensor, x_prev: Tensor):
    """(r, k, v, log_w) as float32 heads (B, H, S, N) and the gate g."""
    H = x.shape[-1] // cfg.rwkv_head_dim
    N = cfg.rwkv_head_dim
    xr, xk, xv, xw, xg = _ddlerp(p, x, x_prev)
    r = _heads((xr @ p["wr"]).float(), H, N)
    k = _heads((xk @ p["wk"]).float(), H, N)
    v = _heads((xv @ p["wv"]).float(), H, N)
    g = F.silu(xg @ p["wg"])
    log_w = _heads(_log_decay(p, xw), H, N)
    return r, k, v, log_w, g


def _time_mix_out(p, x: Tensor, y: Tensor, g: Tensor) -> Tensor:
    """y: (B, H, S, N) float32 -> the sub-layer's (B, S, D) output."""
    B, S, D = x.shape
    y = y.transpose(1, 2).reshape(B, S, D)
    y = rms_norm(y.to(x.dtype), p["ln_x"])
    return (y * g) @ p["wo"]


def time_mix_with_state(p, cfg: ModelConfig, x: Tensor
                        ) -> Tuple[Tensor, Tensor]:
    """x: (B, S, D) -> ((B, S, D), the terminal WKV state), parallel
    (chunked) over time."""
    r, k, v, log_w, g = _time_mix_inputs(p, cfg, x, _shift(x))
    y, state = wkv_chunked_with_state(r, k, v, log_w, p["u"])
    return _time_mix_out(p, x, y, g), state


def time_mix(p, cfg: ModelConfig, x: Tensor) -> Tensor:
    """x: (B, S, D) -> (B, S, D), parallel (chunked) over time."""
    return time_mix_with_state(p, cfg, x)[0]


def _channel(p, x: Tensor, x_prev: Tensor) -> Tensor:
    xk = x + (x_prev - x) * p["cm_mu_k"]
    xr = x + (x_prev - x) * p["cm_mu_r"]
    kk = torch.square(F.relu(xk @ p["cm_wk"]))
    return torch.sigmoid(xr @ p["cm_wr"]) * (kk @ p["cm_wv"])


def channel_mix(p, cfg: ModelConfig, x: Tensor) -> Tensor:
    return _channel(p, x, _shift(x))


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------
def init_rwkv_cache(cfg: ModelConfig, batch: int, dtype=torch.float32,
                    device="cuda"):
    """The WKV state in float32, the two token shifts in ``dtype``."""
    d = cfg.d_model
    N = cfg.rwkv_head_dim
    H = d // N
    return {
        "wkv": torch.zeros((batch, H, N, N), dtype=torch.float32,
                           device=device),
        "tm_prev": torch.zeros((batch, d), dtype=dtype, device=device),
        "cm_prev": torch.zeros((batch, d), dtype=dtype, device=device),
    }


def time_mix_decode(p, cfg: ModelConfig, x: Tensor, cache: dict
                    ) -> Tuple[Tensor, dict]:
    """x: (B, 1, D); O(1) state update."""
    x_prev = cache["tm_prev"][:, None].to(x.dtype)
    r, k, v, log_w, g = _time_mix_inputs(p, cfg, x, x_prev)
    r, k, v = r[:, :, 0], k[:, :, 0], v[:, :, 0]          # (B, H, N)
    w = torch.exp(log_w[:, :, 0])
    S = cache["wkv"]                                      # (B, H, N, N)
    kv = k[..., :, None] * v[..., None, :]                # bhn,bhm->bhnm
    y = torch.einsum("bhn,bhnm->bhm", r, S + p["u"][None, :, :, None] * kv)
    S_new = w[..., None] * S + kv
    out = _time_mix_out(p, x, y[:, :, None], g)
    return out, {**cache, "wkv": S_new, "tm_prev": x[:, 0]}


def channel_mix_decode(p, cfg: ModelConfig, x: Tensor, cache: dict
                       ) -> Tuple[Tensor, dict]:
    x_prev = cache["cm_prev"][:, None].to(x.dtype)
    return _channel(p, x, x_prev), {**cache, "cm_prev": x[:, 0]}
