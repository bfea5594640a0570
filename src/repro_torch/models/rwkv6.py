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

Head parallel (``models/shardctx.py``; the specs split ``wr``'s output
channels over ``model``): ``wr``/``wk``/``wv``/``wg`` and ``cm_wk``/``cm_wr``
are column-parallel, ``wo`` and ``cm_wv`` row-parallel, and the replicated
leaves used on a rank's heads or channels (``u``, ``w0``, ``w_lora_b``'s
output columns, ``ln_x``) are cut to them.  The token shift and ddlerp run
whole on every rank; the WKV runs on the local heads; ``ln_x``'s norm
takes its sum of squares over the whole width (all-reduced); ``wo``'s
partial sums are reduced over ``model``.  The channel mix reduce-scatters
``kk @ cm_wv``'s partial sums onto the local channels, gates them by
``sigmoid(xr @ cm_wr)`` and gathers the channels whole.  The decode cache
holds the local heads' WKV state and the local channels of the two token
shifts, which decode gathers whole.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import shardctx
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


# the leaves used on a rank's heads or channels, and the dim that is theirs
_LOCAL_DIMS = {"wr": -1, "wk": -1, "wv": -1, "wg": -1, "wo": 0, "u": 0,
               "w0": -1, "w_lora_b": -1, "ln_x": -1, "cm_wk": -1, "cm_wv": 0,
               "cm_wr": -1}


def head_parallel(cfg: ModelConfig) -> bool:
    """Whether the sub-layer runs split over ``model``: the specs split
    ``wr``'s output channels, which must then hold whole heads."""
    if not shardctx.split_over_model(cfg, ("mix", "wr"), -1):
        return False
    heads, m = cfg.d_model // cfg.rwkv_head_dim, shardctx.model_size()
    if heads % m:
        raise ValueError(f"{cfg.name}: {heads} heads do not split over a "
                         f"'model' axis of {m}")
    return True


def local_heads(p, cfg: ModelConfig):
    """(``p`` over this rank's heads and channels, whether they are
    split): a leaf as its spec cut it, a replicated one cut at use."""
    if not head_parallel(cfg):
        return p, False
    return {n: (shardctx.model_share(cfg, ("mix", n), t, _LOCAL_DIMS[n])
                if n in _LOCAL_DIMS else t) for n, t in p.items()}, True


def own_channels(cfg: ModelConfig, t: Tensor) -> Tensor:
    """This rank's channels of a (B, D) token shift (the cache's layout);
    ``t`` itself outside head parallelism."""
    return shardctx.own_chunk(t, -1) if head_parallel(cfg) else t


def _whole_shift(cfg: ModelConfig, t: Tensor) -> Tensor:
    """A cached (B, D) token shift whole: gathered when it holds this
    rank's channels only."""
    if t.shape[-1] == cfg.d_model:
        return t
    return shardctx.gather_whole_over_model(t, -1)


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


def _decay_lora_in(p, xw: Tensor) -> Tensor:
    """The decay LoRA's hidden layer, float32; xw: (B, S, D)."""
    return torch.tanh(xw.float() @ p["w_lora_a"].float())


def _log_decay(p, hidden: Tensor) -> Tensor:
    """log w_t in [LOG_W_MIN, LOG_W_MAX], float32, from the LoRA's hidden
    layer (over ``w0``'s channels)."""
    lora = hidden @ p["w_lora_b"].float()
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


def _time_mix_inputs(p, cfg: ModelConfig, x: Tensor, x_prev: Tensor,
                     tp: bool = False):
    """(r, k, v, log_w) as float32 heads (B, H, S, N) and the gate g, over
    ``p``'s heads (this rank's under ``tp``: the ddlerp and the decay
    LoRA's hidden layer whole, then copied onto the local heads)."""
    N = cfg.rwkv_head_dim
    H = p["wr"].shape[-1] // N
    mixed = _ddlerp(p, x, x_prev)
    hidden = _decay_lora_in(p, mixed[3])
    if tp:
        mixed = shardctx.copy_to_model(mixed)
        hidden = shardctx.copy_to_model(hidden)
    xr, xk, xv, _, xg = mixed
    r = _heads((xr @ p["wr"]).float(), H, N)
    k = _heads((xk @ p["wk"]).float(), H, N)
    v = _heads((xv @ p["wv"]).float(), H, N)
    g = F.silu(xg @ p["wg"])
    log_w = _heads(_log_decay(p, hidden), H, N)
    return r, k, v, log_w, g


def _time_mix_out(p, x: Tensor, y: Tensor, g: Tensor, tp: bool = False
                  ) -> Tensor:
    """y: (B, H, S, N) float32 -> the sub-layer's (B, S, D) output (under
    ``tp`` the norm over the whole width and ``wo``'s partial sums
    reduced)."""
    B, S, _ = x.shape
    y = y.transpose(1, 2).reshape(B, S, -1).to(x.dtype)
    if not tp:
        return (rms_norm(y, p["ln_x"]) * g) @ p["wo"]
    y = shardctx.rms_norm_over_model(y, p["ln_x"])
    return shardctx.reduce_from_model((y * g) @ p["wo"])


def time_mix_with_state(p, cfg: ModelConfig, x: Tensor
                        ) -> Tuple[Tensor, Tensor]:
    """x: (B, S, D) -> ((B, S, D), the terminal WKV state of ``p``'s heads
    -- this rank's under head parallelism), parallel (chunked) over
    time."""
    p, tp = local_heads(p, cfg)
    r, k, v, log_w, g = _time_mix_inputs(p, cfg, x, _shift(x), tp)
    y, state = wkv_chunked_with_state(r, k, v, log_w, p["u"])
    return _time_mix_out(p, x, y, g, tp), state


def time_mix(p, cfg: ModelConfig, x: Tensor) -> Tensor:
    """x: (B, S, D) -> (B, S, D), parallel (chunked) over time."""
    return time_mix_with_state(p, cfg, x)[0]


def _channel(p, x: Tensor, x_prev: Tensor, tp: bool = False) -> Tensor:
    xk = x + (x_prev - x) * p["cm_mu_k"]
    xr = x + (x_prev - x) * p["cm_mu_r"]
    if not tp:
        kk = torch.square(F.relu(xk @ p["cm_wk"]))
        return torch.sigmoid(xr @ p["cm_wr"]) * (kk @ p["cm_wv"])
    # this rank's ffn share and channels (see the module docstring)
    xk, xr = shardctx.copy_to_model(torch.stack([xk, xr]))
    kk = torch.square(F.relu(xk @ p["cm_wk"]))
    kv = shardctx.reduce_scatter_over_model(kk @ p["cm_wv"], -1)
    return shardctx.gather_whole_over_model(
        torch.sigmoid(xr @ p["cm_wr"]) * kv, -1)


def channel_mix(p, cfg: ModelConfig, x: Tensor) -> Tensor:
    p, tp = local_heads(p, cfg)
    return _channel(p, x, _shift(x), tp)


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


def _shift_out(cached: Tensor, x: Tensor) -> Tensor:
    """The new token shift in the cached one's layout (this rank's
    channels when it held them)."""
    new = x[:, 0]
    return new if cached.shape[-1] == new.shape[-1] else \
        shardctx.own_chunk(new, -1)


def time_mix_decode(p, cfg: ModelConfig, x: Tensor, cache: dict
                    ) -> Tuple[Tensor, dict]:
    """x: (B, 1, D); O(1) state update (under head parallelism the state
    of this rank's heads)."""
    p, tp = local_heads(p, cfg)
    x_prev = _whole_shift(cfg, cache["tm_prev"])[:, None].to(x.dtype)
    r, k, v, log_w, g = _time_mix_inputs(p, cfg, x, x_prev, tp)
    r, k, v = r[:, :, 0], k[:, :, 0], v[:, :, 0]          # (B, H, N)
    w = torch.exp(log_w[:, :, 0])
    S = cache["wkv"]                                      # (B, H, N, N)
    kv = k[..., :, None] * v[..., None, :]                # bhn,bhm->bhnm
    y = torch.einsum("bhn,bhnm->bhm", r, S + p["u"][None, :, :, None] * kv)
    S_new = w[..., None] * S + kv
    out = _time_mix_out(p, x, y[:, :, None], g, tp)
    return out, {**cache, "wkv": S_new,
                 "tm_prev": _shift_out(cache["tm_prev"], x)}


def channel_mix_decode(p, cfg: ModelConfig, x: Tensor, cache: dict
                       ) -> Tuple[Tensor, dict]:
    p, tp = local_heads(p, cfg)
    x_prev = _whole_shift(cfg, cache["cm_prev"])[:, None].to(x.dtype)
    return _channel(p, x, x_prev, tp), {
        **cache, "cm_prev": _shift_out(cache["cm_prev"], x)}
