"""Multi-head attention: GQA, qk-norm, QKV bias, sliding window, RoPE (the
JAX package's ``models/attention.py``).

Training/prefill uses a *query-chunked* plain path (a loop over query
blocks) so the (S x S) score matrix is never materialized;
``attention_impl="flash"`` routes to the hand-written CUDA kernel
(``repro_torch.kernels.flash_attention``).  Decode attends a (possibly
ring-buffered) KV cache.

Under tensor parallelism (``models/shardctx.py``) each rank holds the
column-parallel ``wq``/``wk``/``wv`` and the row-parallel ``wo`` that
``launch/sharding.py`` cut for it, and the layout follows from their
specs (``shardctx.split_over_model``): q over this rank's heads, k/v over
its kv heads, or, when the kv heads fell back to replicated (kv = 1 at
``model`` = 2), all of them projected and cut to the groups of the local
q heads.  Attention
(the chunked path or the flash kernel) runs on the local heads; ``wo``'s
partial sums are reduced over ``model``.  A layer whose q heads fell back
to replicated runs whole on every rank.  The decode cache splits its
context slots over ``model`` (``cache_seq``): each rank scores every head
against its own slots, the per-shard softmax maxima and sums are gathered,
and each rank's probabilities are renormalized by the global ones before
the partial outputs are summed -- the single-rank softmax, summed in
another order.

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
from repro_torch.models import shardctx
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


def _kv_groups(cfg: ModelConfig, hq: int):
    """The kv heads the local q heads read, when every kv head is here:
    a slice of whole groups (aligned), or one kv head per q head."""
    h, kv = cfg.num_heads, cfg.num_kv_heads
    rep = h // kv
    q0 = shardctx.model_rank() * hq
    idx = [(q0 + j) // rep for j in range(hq)]
    uniq = sorted(set(idx))
    if hq % len(uniq) == 0 and idx == [g for g in uniq
                                       for _ in range(hq // len(uniq))]:
        return uniq
    return idx


def _heads_split(cfg: ModelConfig) -> Tuple[bool, bool]:
    """Whether the specs split the q heads and the kv heads over
    ``model``."""
    return (shardctx.split_over_model(cfg, ("mix", "wq"), -1),
            shardctx.split_over_model(cfg, ("mix", "wk"), -1))


def _project_qkv(p, cfg: ModelConfig, x: Tensor, positions: Tensor,
                 full_kv: bool = False):
    """x: (B, S, D) -> q (B,S,Hq,hd), k/v (B,S,KV,hd) with rope + qk-norm,
    over this rank's heads (see the module docstring); with ``full_kv``
    also k/v over every kv head (for the decode cache)."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    tp, kv_split = _heads_split(cfg)
    if kv_split and not tp:
        raise NotImplementedError("kv heads split over 'model' with the q "
                                  "heads replicated")
    # under TP, replicated leaves used on this rank's heads only get
    # partial gradients, summed over model (Megatron's f)
    rep = shardctx.copy_to_model if tp else (lambda t: t)
    kv_of = (lambda t: t) if kv_split else rep
    x = rep(x)
    q = x @ p["wq"]
    k = x @ kv_of(p["wk"])
    v = x @ kv_of(p["wv"])
    if cfg.qkv_bias:
        q = q + (shardctx.model_share(cfg, ("mix", "bq"), p["bq"], -1)
                 if tp else p["bq"])
        k, v = k + kv_of(p["bk"]), v + kv_of(p["bv"])
    q = q.reshape(B, S, -1, hd)
    k = k.reshape(B, S, -1, hd)
    v = v.reshape(B, S, -1, hd)
    if cfg.qk_norm:
        q = rms_norm(q, rep(p["q_norm"]))
        k = rms_norm(k, rep(p["k_norm"]))
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    if not full_kv:
        if tp and not kv_split:
            g = _kv_groups(cfg, q.shape[2])
            k, v = k[:, :, g], v[:, :, g]
        return q, k, v
    if kv_split:
        k, v = (shardctx.gather_from_model(t, 2) for t in (k, v))
    return q, k, v


def _out_proj(p, cfg: ModelConfig, o: Tensor) -> Tensor:
    """(..., Hq*hd) -> (..., D): the row-parallel ``wo``, its partial sums
    reduced over ``model`` when the heads are split."""
    if not _heads_split(cfg)[0]:
        return o @ p["wo"]
    wo = shardctx.model_share(cfg, ("mix", "wo"), p["wo"], 0)
    return shardctx.reduce_from_model(o @ wo)


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
    hd = cfg.head_dim
    win = window if window is not None else cfg.window
    q, k, v = _project_qkv(p, cfg, x, positions)
    h, kv = q.shape[2], k.shape[2]
    rep = h // kv
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
    return _out_proj(p, cfg, out)


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
    q, k, v = _project_qkv(p, cfg, x, positions)
    win = window if window is not None else cfg.window
    out = flash_attention(q, k, v, causal=True, window=win)
    return _out_proj(p, cfg, out.reshape(B, S, -1))


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


def cache_slots(cfg: ModelConfig, max_len: int,
                window: Optional[int] = None) -> Tuple[int, int, int]:
    """(slots n, this rank's first slot, its slot count) of one layer's
    cache: a ring of ``window`` slots for windowed layers, the context
    slots split over ``cache_seq`` under a shard context."""
    win = window if window is not None else cfg.window
    n = min(max_len, win) if win is not None else max_len
    s0, n_here = shardctx.local_range(n, "cache_seq")
    return n, s0, n_here


def decode_attention(p, cfg: ModelConfig, x: Tensor, pos: int, cache: dict,
                     window: Optional[int] = None,
                     max_len: Optional[int] = None) -> Tuple[Tensor, dict]:
    """x: (B, 1, D); pos: int (the same position for the whole batch).
    Returns (out (B, 1, D), cache).  The new key and value are written
    into the cache's ring slot in place (the reference returns a new
    cache); the returned dict holds the same tensors.  ``max_len`` (the
    cache's context length) is needed only when the slots are split over
    ``model``."""
    B = x.shape[0]
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(p, cfg, x, positions, full_kv=True)
    hq = q.shape[2]
    tp = _heads_split(cfg)[0]

    k_all, v_all, slot_pos = cache["k"], cache["v"], cache["slot_pos"]
    if max_len is None:
        if shardctx.model_size() > 1:
            raise ValueError("decode under a 'model' axis needs max_len, "
                             "the cache's context length")
        n, s0, n_here = k_all.shape[1], 0, k_all.shape[1]
    else:
        n, s0, n_here = cache_slots(cfg, max_len, window)
    if n_here != k_all.shape[1]:
        raise ValueError(f"a cache of {k_all.shape[1]} slots here, the "
                         f"layer has {n_here} of {n}")
    slot = pos % n  # ring for windowed layers; identity while pos < n
    if s0 <= slot < s0 + n_here:
        # every row of the cache (gathered where it holds more rows than
        # this rank decodes); attention reads this rank's rows
        k_all[:, slot - s0] = shardctx.rows_to_cache(
            k_new[:, 0].to(k_all.dtype))
        v_all[:, slot - s0] = shardctx.rows_to_cache(
            v_new[:, 0].to(v_all.dtype))
        slot_pos[slot - s0] = pos
    k, v = shardctx.own_rows(k_all), shardctx.own_rows(v_all)
    win = window if window is not None else cfg.window
    valid = (slot_pos >= 0) & (slot_pos <= pos)
    if win is not None:
        valid &= (pos - slot_pos) < win
    mask = valid[None, None, None, None, :]

    if n_here == n:
        # every slot here: the local q heads against their kv groups
        if tp:
            g = _kv_groups(cfg, hq)
            kg, vg = k[:, :, g], v[:, :, g]
        else:
            kg, vg = k, v
        # grouped-GQA scores: K/V streamed at kv-head width (never repeated)
        qg = q.reshape(B, 1, kg.shape[2], hq // kg.shape[2], hd)
        s = torch.einsum("bqgrd,bkgd->bgrqk", qg.float(),
                         kg.float()) * hd ** -0.5
        o = _grouped_attend(_masked_softmax(s, mask), vg)
    else:
        # slots split over model: every head against this rank's slots,
        # renormalized by the gathered per-shard maxima and sums
        q_all = shardctx.gather_from_model(q, 2) if tp else q
        qg = q_all.reshape(B, 1, kv, h // kv, hd)
        s = torch.einsum("bqgrd,bkgd->bgrqk", qg.float(),
                         k.float()) * hd ** -0.5
        s = torch.where(mask, s, NEG_INF)
        m = torch.amax(s, dim=-1, keepdim=True)
        e = torch.where(mask, torch.exp(s - m), 0.0)
        ml = torch.stack([m, torch.sum(e, dim=-1, keepdim=True)])
        ml = shardctx.gather_from_model(ml[None], 0)   # (tp, 2, ...)
        m_all = torch.amax(ml[:, 0], dim=0)
        l_all = torch.sum(ml[:, 1] * torch.exp(ml[:, 0] - m_all), dim=0)
        probs = e * (torch.exp(m - m_all) / (l_all + 1e-30))
        part = torch.einsum("bgrqk,bkgd->bqgrd", probs.to(v.dtype).float(),
                            v.float())
        o = shardctx.reduce_from_model(part).to(v.dtype)
        if tp:
            o = o.reshape(B, 1, h, hd)
            o = o[:, :, shardctx.model_rank() * hq:][:, :, :hq]
    # a bf16 cache under f32 activations: o is promoted, as in jnp's matmul
    o = o.to(torch.promote_types(o.dtype, p["wo"].dtype))
    out = _out_proj(p, cfg, o.reshape(B, 1, hq * hd))
    return out, {"k": k_all, "v": v_all, "slot_pos": slot_pos}
