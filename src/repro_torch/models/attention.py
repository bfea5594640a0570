"""Multi-head attention: GQA, qk-norm, QKV bias, sliding window, RoPE (the
JAX package's ``models/attention.py``).

Training/prefill uses a *query-chunked* plain path (a loop over query
blocks) so the (S x S) score matrix is never materialized;
``attention_impl="flash"`` routes to the hand-written CUDA kernel
(``repro_torch.kernels.flash_attention``).  Decode attends a (possibly
ring-buffered) KV cache.

Products whose reference takes bf16 inputs with float32 accumulation are
taken here on float32 copies of the inputs (a bf16 x bf16 product is exact
in float32), rounded back where the reference's result is bf16; only the
order of summation differs.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.common import dense_init, rms_norm, rope, split_keys

Tensor = torch.Tensor
NEG_INF = -2.0 ** 30


def init_attn_params(key, cfg: ModelConfig, dtype, device=None):
    """Six keys from ``key``, used in the reference's order, on ``device``
    (the key's by default)."""
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    ks = split_keys(key, 6)
    dev = key.device if device is None else torch.device(device)
    p = {
        "wq": dense_init(ks[0], (d, h * hd), dtype, device=dev),
        "wk": dense_init(ks[1], (d, kv * hd), dtype, device=dev),
        "wv": dense_init(ks[2], (d, kv * hd), dtype, device=dev),
        "wo": dense_init(ks[3], (h * hd, d), dtype, device=dev),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h * hd,), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((kv * hd,), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((kv * hd,), dtype=dtype, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((hd,), dtype=dtype, device=dev)
        p["k_norm"] = torch.zeros((hd,), dtype=dtype, device=dev)
    return p


def _project_qkv(p, cfg: ModelConfig, x: Tensor, positions: Tensor):
    """x: (B, S, D) -> q (B,S,H,hd), k/v (B,S,KV,hd) with rope + qk-norm."""
    B, S, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, h, hd)
    k = k.reshape(B, S, kv, hd)
    v = v.reshape(B, S, kv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _masked_softmax(scores: Tensor, mask: Tensor) -> Tensor:
    scores = torch.where(mask, scores.float(), NEG_INF)
    # guard fully-masked rows (outside window) against NaN
    m = torch.amax(scores, dim=-1, keepdim=True)
    e = torch.exp(scores - m)
    e = torch.where(mask, e, 0.0)
    return e / (torch.sum(e, dim=-1, keepdim=True) + 1e-30)


def _grouped_attend(probs: Tensor, v: Tensor) -> Tensor:
    """einsum("bgrqk,bkgd->bqgrd") of probabilities rounded to v's dtype,
    summed in float32, result in v's dtype."""
    return torch.einsum("bgrqk,bkgd->bqgrd", probs.to(v.dtype).float(),
                        v.float()).to(v.dtype)


def attention_train(p, cfg: ModelConfig, x: Tensor, positions: Tensor,
                    window: Optional[int] = None) -> Tensor:
    """Causal (optionally windowed) self-attention over full sequences,
    chunked over queries. x: (B, S, D) -> (B, S, D).  GQA runs as grouped
    einsums (query heads reshaped to (kv_heads, group)): K/V are never
    materialized at q-head width."""
    B, S, D = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    rep = h // kv
    win = window if window is not None else cfg.window
    q, k, v = _project_qkv(p, cfg, x, positions)
    scale = hd ** -0.5
    qc = min(cfg.q_chunk_size, S)
    if S % qc:
        raise ValueError(f"seq {S} must divide q_chunk {qc}")
    kf = k.float()
    kpos = positions  # (B, S)
    outs = []
    for c0 in range(0, S, qc):
        qg = q[:, c0: c0 + qc].reshape(B, qc, kv, rep, hd)
        qpos = positions[:, c0: c0 + qc]
        # scores: (B, KV, rep, qc, S)
        s = torch.einsum("bqgrd,bkgd->bgrqk", qg.float(), kf) * scale
        mask = qpos[:, None, None, :, None] >= kpos[:, None, None, None, :]
        if win is not None:
            mask &= (qpos[:, None, None, :, None]
                     - kpos[:, None, None, None, :]) < win
        probs = _masked_softmax(s, mask)
        outs.append(_grouped_attend(probs, v).reshape(B, qc, h, hd))
    out = torch.cat(outs, dim=1).reshape(B, S, h * hd)
    return out @ p["wo"]


def attention_flash(p, cfg: ModelConfig, x: Tensor, positions: Tensor,
                    window: Optional[int] = None) -> Tensor:
    """The flash-attention path: the CUDA kernel on the card, its plain
    version on the CPU.  Forward only, as the reference's kernel: under
    autograd it raises rather than return an output that carries no
    gradient to the projections (train with ``attention_impl=
    "xla_chunked"``, as the reference does)."""
    if torch.is_grad_enabled() and (
            x.requires_grad or any(t.requires_grad for t in p.values())):
        raise RuntimeError(
            "attention_impl='flash' has no backward (the reference's flash "
            "kernel is forward only): its output would carry no gradient. "
            "Train with attention_impl='xla_chunked', or run this forward "
            "under torch.no_grad()")
    B, S, D = x.shape
    h, hd = cfg.num_heads, cfg.head_dim
    q, k, v = _project_qkv(p, cfg, x, positions)
    win = window if window is not None else cfg.window
    out = flash_attention(q, k, v, causal=True, window=win)
    return out.reshape(B, S, h * hd) @ p["wo"]


def attend(p, cfg: ModelConfig, x: Tensor, positions: Tensor,
           window: Optional[int] = None) -> Tensor:
    if cfg.attention_impl == "flash":
        return attention_flash(p, cfg, x, positions, window)
    return attention_train(p, cfg, x, positions, window)


# ---------------------------------------------------------------------------
# decode: one new token against a KV cache
# ---------------------------------------------------------------------------
def init_layer_cache(cfg: ModelConfig, batch: int, max_len: int,
                     window: Optional[int] = None, dtype=torch.bfloat16,
                     device="cuda"):
    """KV cache for ONE attention layer. Windowed layers use a ring buffer
    of size ``window``; ``slot_pos`` holds the absolute position of each
    slot (-1 = empty)."""
    win = window if window is not None else cfg.window
    n = min(max_len, win) if win is not None else max_len
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros((batch, n, kv, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, n, kv, hd), dtype=dtype, device=device),
        "slot_pos": torch.full((n,), -1, dtype=torch.int32, device=device),
    }


def decode_attention(p, cfg: ModelConfig, x: Tensor, pos: int, cache: dict,
                     window: Optional[int] = None) -> Tuple[Tensor, dict]:
    """x: (B, 1, D); pos: int (the same position for the whole batch).
    Returns (out (B, 1, D), cache).  The new key and value are written
    into the cache's ring slot in place (the reference returns a new
    cache); the returned dict holds the same tensors."""
    B = x.shape[0]
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(p, cfg, x, positions)

    k, v, slot_pos = cache["k"], cache["v"], cache["slot_pos"]
    slot = pos % k.shape[1]  # ring for windowed layers; identity while pos < n
    k[:, slot] = k_new[:, 0].to(k.dtype)
    v[:, slot] = v_new[:, 0].to(v.dtype)
    slot_pos[slot] = pos

    # grouped-GQA scores: K/V streamed at kv-head width (never repeated)
    qg = q.reshape(B, 1, kv, h // kv, hd)
    s = torch.einsum("bqgrd,bkgd->bgrqk", qg.float(), k.float()) * hd ** -0.5
    win = window if window is not None else cfg.window
    valid = (slot_pos >= 0) & (slot_pos <= pos)
    if win is not None:
        valid &= (pos - slot_pos) < win
    probs = _masked_softmax(s, valid[None, None, None, None, :])
    o = _grouped_attend(probs, v)
    # a bf16 cache under f32 activations: o is promoted, as in jnp's matmul
    o = o.to(torch.promote_types(o.dtype, p["wo"].dtype))
    out = o.reshape(B, 1, h * hd) @ p["wo"]
    return out, {"k": k, "v": v, "slot_pos": slot_pos}
