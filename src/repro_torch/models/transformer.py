"""The decoder-only model of the JAX package's ``models/transformer.py``,
for every sub-layer kind: dense GQA attention (qk-norm / QKV-bias /
sliding-window variants) with a dense or MoE FFN, RG-LRU hybrids such as
recurrentgemma-2b, and RWKV-6.

Layers are grouped into repeating *pattern blocks* (``cfg.block_pattern``)
plus a tail.  Parameters are a dict laid out as the reference's, except
that ``blocks`` is a list with one dict per block where the reference
stacks them on a leading axis; the blocks run as a Python loop.  Two
modes: prefill (a full-sequence forward that builds the decode cache) and
decode (one token against the cache; O(1) state for the recurrent
layers).

Inside ``models/shardctx.py::activation_sharding`` every function here
runs on this rank's shards (``launch/steps.py::build_cell``): the batch
rows are the rank's, each sub-layer is tensor-parallel as its leaves'
specs split it, the embedding and unembedding are vocab-parallel (the
lookup masked to the local vocab range and summed over ``model``; the
logits gathered for the argmax; the cross entropy's max, logsumexp and
target logit reduced over ``model``), and the loss is summed over the
batch axes.  ``shardctx.constrain`` marks the reference's six block
boundaries.

Training (``forward_hidden`` / ``forward_train``, the reference's train
mode) also takes the reference's own layout: ``blocks`` a dict of
tensors stacked on a leading block axis (:func:`stack_blocks`), which is
what a training state holds, so its optimizer state and checkpoints match
the reference's entry for entry.  ``cfg.remat`` recomputes each block in
the backward (``torch.utils.checkpoint``, the reference's
``jax.checkpoint`` with nothing saveable).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import prng
from repro_torch.models import attention as attn_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import rwkv6 as rwkv_mod
from repro_torch.models import shardctx
from repro_torch.models.common import (cast_floats, dense_init, dtype_of,
                                      rms_norm, split_keys)
from repro_torch.models.loss import chunked_xent

Tensor = torch.Tensor
PyTree = Any

KINDS = ("attn", "rec", "rwkv")


def _unknown(kind: str) -> ValueError:
    return ValueError(f"unknown sub-layer kind {kind!r}; the kinds are "
                      f"{KINDS}")


def _pattern(cfg: ModelConfig) -> Tuple[str, ...]:
    if cfg.is_rwkv:
        return ("rwkv",)
    return cfg.block_pattern or ("attn",)


def block_layout(cfg: ModelConfig
                 ) -> Tuple[Tuple[str, ...], int, Tuple[str, ...]]:
    """(pattern, n_full_blocks, tail_kinds)."""
    p = _pattern(cfg)
    n_full = cfg.num_layers // len(p)
    tail = tuple(p[: cfg.num_layers % len(p)])
    return p, n_full, tail


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def _init_sublayer(key, cfg: ModelConfig, kind: str, dtype, device
                   ) -> Dict:
    """``k1, k2 = split(key)``: the mixer from k1, the FFN from k2 (an
    ``rwkv`` sub-layer has its channel mix inside ``mix`` and no FFN)."""
    k1, k2 = split_keys(key, 2)
    p: Dict[str, Any] = {"ln1": torch.zeros((cfg.d_model,), dtype=dtype,
                                            device=device)}
    if kind == "attn":
        p["mix"] = attn_mod.init_attn_params(k1, cfg, dtype, device)
    elif kind == "rec":
        p["mix"] = rglru_mod.init_rglru_params(k1, cfg, dtype, device)
    elif kind == "rwkv":
        p["mix"] = rwkv_mod.init_rwkv_params(k1, cfg, dtype, device)
    else:
        raise _unknown(kind)
    p["ln2"] = torch.zeros((cfg.d_model,), dtype=dtype, device=device)
    if kind != "rwkv":
        p["ffn"] = mlp_mod.init_ffn_params(k2, cfg, dtype, device=device)
    return p


def init_params(cfg: ModelConfig, key, device="cuda") -> PyTree:
    """Random weights at the config's shapes on ``device``, drawn as the
    reference's ``init_params(cfg, key)`` draws them: ``k_emb, k_blocks,
    k_tail, k_un = split(key, 4)``, block b from ``split(k_blocks,
    n_full)[b]`` (the reference vmaps over those keys), the tail from
    ``split_keys(k_tail, len(tail))`` -- within a few float32 ulp of the
    reference's weights (``core/prng.py::normal``).  ``key`` is a port
    key (``core/prng.py::PRNGKey``), a jax key's two words or an int
    seed."""
    dtype = dtype_of(cfg.param_dtype)
    dev = torch.device(device)
    pattern, n_full, tail = block_layout(cfg)
    k_emb, k_blocks, k_tail, k_un = split_keys(prng.as_key(key), 4)
    params: Dict[str, Any] = {
        "embed": dense_init(k_emb, (cfg.vocab_size, cfg.d_model), dtype,
                            scale=0.02, device=dev),
        "final_ln": torch.zeros((cfg.d_model,), dtype=dtype, device=dev),
    }
    if n_full:
        blocks = []
        for bk in split_keys(k_blocks, n_full):
            ks = split_keys(bk, len(pattern))
            blocks.append({f"sub{i}": _init_sublayer(ks[i], cfg, kind, dtype,
                                                     dev)
                           for i, kind in enumerate(pattern)})
        params["blocks"] = blocks
    if tail:
        ks = split_keys(k_tail, len(tail))
        params["tail"] = [_init_sublayer(ks[i], cfg, kind, dtype, dev)
                          for i, kind in enumerate(tail)]
    if not cfg.tie_embeddings:
        params["unembed"] = dense_init(k_un, (cfg.d_model, cfg.vocab_size),
                                       dtype, device=dev)
    return params


def _unembed(cfg: ModelConfig, params) -> Tensor:
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["unembed"]


def _vocab_split(cfg: ModelConfig) -> bool:
    """Whether the unembedding's vocab dim is split over ``model``."""
    if cfg.tie_embeddings:
        return shardctx.split_over_model(cfg, ("embed",), 0)
    return shardctx.split_over_model(cfg, ("unembed",), -1)


def _embed_inputs(cfg: ModelConfig, params, batch) -> Tensor:
    dtype = dtype_of(cfg.activation_dtype)
    if cfg.input_mode == "embeddings" and "embeds" in batch:
        return batch["embeds"].to(dtype)
    emb, tok = params["embed"], batch["tokens"].long()
    if shardctx.split_over_model(cfg, ("embed",), 0):
        # vocab-parallel: one rank owns each token's row, the others add 0
        n = emb.shape[0]
        local = tok - shardctx.model_rank() * n
        mine = (local >= 0) & (local < n)
        x = torch.where(mine[..., None], emb[local.clamp(0, n - 1)], 0.0)
        x = shardctx.reduce_from_model(x).to(dtype)
    else:
        x = emb[tok].to(dtype)
    if cfg.tie_embeddings:   # sqrt(d_model) taken in f32, rounded to dtype
        x = x * torch.sqrt(torch.tensor(float(cfg.d_model),
                                        device=x.device)).to(dtype)
    return x


def stack_blocks(params) -> PyTree:
    """``params`` with ``blocks`` (a list of per-block dicts) stacked into
    one dict of tensors with a leading block axis -- the reference's
    layout; other entries are kept as they are."""
    if not isinstance(params.get("blocks"), list):
        return params
    out = dict(params)
    out["blocks"] = _stack([b for b in params["blocks"]])
    return out


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def block_params(params, i: int):
    """Block ``i``'s parameters under either layout (views into a stacked
    ``blocks``)."""
    blocks = params["blocks"]
    return blocks[i] if isinstance(blocks, list) else _index(blocks, i)


def _logits(cfg: ModelConfig, params, h: Tensor) -> Tensor:
    """(B, D) final hidden states -> (B, V) float32 logits against the
    float32 master embedding (gathered over ``model`` when the vocab is
    split)."""
    logits = h.float() @ _unembed(cfg, params).float()
    if _vocab_split(cfg):
        logits = shardctx.gather_from_model(logits, -1)
    return logits


# ---------------------------------------------------------------------------
# sub-layer application (train mode)
# ---------------------------------------------------------------------------
def _sublayer_train(p, cfg: ModelConfig, kind: str, x: Tensor,
                    positions: Tensor, plain_recurrence: bool = False
                    ) -> Tuple[Tensor, Tensor]:
    """Returns (x, moe_aux_loss)."""
    p = cast_floats(p, x.dtype)
    h = rms_norm(x, p["ln1"])
    if kind == "attn":
        x = x + attn_mod.attend(p["mix"], cfg, h, positions)
    elif kind == "rec":
        x = x + rglru_mod.rglru_block(p["mix"], cfg, h, plain_recurrence)
    elif kind == "rwkv":
        x = x + rwkv_mod.time_mix(p["mix"], cfg, h)
        h2 = rms_norm(x, p["ln2"])
        x = x + rwkv_mod.channel_mix(p["mix"], cfg, h2)
        return x, torch.zeros((), dtype=torch.float32, device=x.device)
    else:
        raise _unknown(kind)
    h2 = rms_norm(x, p["ln2"])
    out, aux = mlp_mod.ffn(p["ffn"], cfg, h2)
    return x + out, aux


def _block_train(blk, cfg: ModelConfig, pattern, x: Tensor,
                 positions: Tensor, plain_recurrence: bool = False
                 ) -> Tuple[Tensor, Tensor]:
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, kind in enumerate(pattern):
        x, a = _sublayer_train(blk[f"sub{i}"], cfg, kind, x, positions,
                               plain_recurrence)
        aux = aux + a
    return x, aux


def forward_hidden(cfg: ModelConfig, params, batch: Dict[str, Tensor],
                   plain_recurrence: bool = False) -> Tuple[Tensor, Tensor]:
    """Full-sequence forward to final hidden states. Returns (h, moe_aux).

    The blocks run in order as a Python loop, under ``cfg.remat`` each in
    ``torch.utils.checkpoint`` (recomputed in the backward).  The
    reference's ``cfg.scan_layers`` picks a ``lax.scan`` or an unrolled
    loop, one program either way; eager torch has only the loop, so both
    settings run it.  ``plain_recurrence=True`` runs the RG-LRU recurrence
    through its plain version (autograd through the loop) instead of the
    kernel: the reference route for checking the kernel's gradients."""
    pattern, n_full, tail = block_layout(cfg)
    x = _embed_inputs(cfg, params, batch)
    x = shardctx.constrain(x, "act_batch", "act_seq", "act_embed")
    B, S, _ = x.shape
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device).expand(B, S)

    def inner(blk, x):
        x, a = _block_train(blk, cfg, pattern, x, positions,
                            plain_recurrence)
        return shardctx.constrain(x, "act_batch", "act_seq", "act_embed"), a

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(n_full):
        blk = block_params(params, i)
        if remat:
            x, a = checkpoint(inner, blk, x, use_reentrant=False)
        else:
            x, a = inner(blk, x)
        aux = aux + a
    for i, kind in enumerate(tail):
        x, a = _sublayer_train(params["tail"][i], cfg, kind, x, positions,
                               plain_recurrence)
        aux = aux + a
        x = shardctx.constrain(x, "act_batch", "act_seq", "act_embed")
    return rms_norm(x, params["final_ln"]), aux


def forward_train(cfg: ModelConfig, params, batch: Dict[str, Tensor],
                  plain_recurrence: bool = False
                  ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Causal-LM loss. batch: tokens/embeds, labels, optional mask.
    Returns (total, {"loss", "moe_aux", "tokens"}).  Under a shard context
    the sums run over every rank's rows (``shardctx.reduce_from_batch``)."""
    h, aux = forward_hidden(cfg, params, batch, plain_recurrence)
    labels = batch["labels"]
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=labels.device)
    loss_sum, n = chunked_xent(h, _unembed(cfg, params), labels, mask,
                               cfg.logits_chunk,
                               vocab_parallel=_vocab_split(cfg))
    loss_sum = shardctx.reduce_from_batch(loss_sum)
    n = shardctx.reduce_from_batch(n)
    loss = loss_sum / torch.clamp(n, min=1.0)
    total = loss + 0.01 * aux
    return total, {"loss": loss, "moe_aux": aux, "tokens": n}


# ---------------------------------------------------------------------------
# cache init
# ---------------------------------------------------------------------------
def _init_sublayer_cache(cfg: ModelConfig, kind: str, batch: int,
                         max_len: int, dtype, device):
    if kind == "attn":
        return attn_mod.init_layer_cache(cfg, batch, max_len, dtype=dtype,
                                         device=device)
    if kind == "rec":
        return rglru_mod.init_rglru_cache(cfg, batch, dtype=dtype,
                                          device=device)
    if kind == "rwkv":
        return rwkv_mod.init_rwkv_cache(cfg, batch, dtype=dtype,
                                        device=device)
    raise _unknown(kind)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> PyTree:
    pattern, n_full, tail = block_layout(cfg)
    cache: Dict[str, Any] = {"pos": 0}
    if n_full:
        cache["blocks"] = [
            {f"sub{i}": _init_sublayer_cache(cfg, kind, batch, max_len,
                                             dtype, device)
             for i, kind in enumerate(pattern)}
            for _ in range(n_full)]
    if tail:
        cache["tail"] = [_init_sublayer_cache(cfg, kind, batch, max_len,
                                              dtype, device)
                         for kind in tail]
    return cache


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------
def _own_rows(cache: dict) -> dict:
    """A recurrent cache's states (every leaf batched) on this rank's
    rows (``shardctx.own_rows``)."""
    return {k: shardctx.own_rows(t) for k, t in cache.items()}


def _rows_to_cache(cache: dict) -> dict:
    """A recurrent cache's new states on the cache's rows
    (``shardctx.rows_to_cache``)."""
    return {k: shardctx.rows_to_cache(t) for k, t in cache.items()}


def _sublayer_decode(p, cfg: ModelConfig, kind: str, x: Tensor, pos: int,
                     cache, max_len: Optional[int] = None
                     ) -> Tuple[Tensor, PyTree]:
    p = cast_floats(p, x.dtype)
    h = rms_norm(x, p["ln1"])
    if kind == "attn":
        o, cache = attn_mod.decode_attention(p["mix"], cfg, h, pos, cache,
                                             max_len=max_len)
    elif kind == "rec":
        o, cache = rglru_mod.rglru_decode(p["mix"], cfg, h, _own_rows(cache))
        cache = _rows_to_cache(cache)
    elif kind == "rwkv":
        cache = _own_rows(cache)
        o, cache = rwkv_mod.time_mix_decode(p["mix"], cfg, h, cache)
        x = x + o
        h2 = rms_norm(x, p["ln2"])
        o, cache = rwkv_mod.channel_mix_decode(p["mix"], cfg, h2, cache)
        return x + o, _rows_to_cache(cache)
    else:
        raise _unknown(kind)
    x = x + o
    h2 = rms_norm(x, p["ln2"])
    x = x + mlp_mod.ffn(p["ffn"], cfg, h2)[0]
    return x, cache


def decode_step(cfg: ModelConfig, params, cache: PyTree, tokens: Tensor,
                max_len: Optional[int] = None) -> Tuple[Tensor, PyTree]:
    """One token per sequence. tokens: (B, 1) -> logits (B, V) float32 and
    the cache one position on (attention caches are updated in place).
    ``max_len`` (the cache's context length) is needed only under a shard
    context whose ``model`` axis splits the cache's slots."""
    pattern, n_full, tail = block_layout(cfg)
    pos = cache["pos"]
    x = _embed_inputs(cfg, params, {"tokens": tokens})
    x = shardctx.constrain(x, "act_batch", None, "act_embed")
    new_cache: Dict[str, Any] = {"pos": pos + 1}
    if n_full:
        new_cache["blocks"] = []
        for blk, blk_cache in zip(params["blocks"], cache["blocks"],
                                  strict=True):
            ncache = {}
            for i, kind in enumerate(pattern):
                x, ncache[f"sub{i}"] = _sublayer_decode(
                    blk[f"sub{i}"], cfg, kind, x, pos, blk_cache[f"sub{i}"],
                    max_len)
            new_cache["blocks"].append(ncache)
    if tail:
        new_cache["tail"] = []
        for i, kind in enumerate(tail):
            x, c = _sublayer_decode(params["tail"][i], cfg, kind, x, pos,
                                    cache["tail"][i], max_len)
            new_cache["tail"].append(c)
    h = rms_norm(x, params["final_ln"])
    return _logits(cfg, params, h[:, 0]), new_cache


# ---------------------------------------------------------------------------
# prefill: full-sequence forward that also builds the decode cache
# ---------------------------------------------------------------------------
def _attn_prefill_cache(p, cfg: ModelConfig, h: Tensor, positions: Tensor,
                        max_len: int, dtype) -> PyTree:
    """Recompute k/v for the whole prompt and lay them out
    ring-consistently: every kv head, this rank's share of the slots."""
    B, S, _ = h.shape
    _, k, v = attn_mod._project_qkv(p["mix"], cfg, h, positions,
                                    full_kv=True)
    n, s0, n_here = attn_mod.cache_slots(cfg, max_len)
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    cache = {
        "k": torch.zeros((B, n_here, kv, hd), dtype=dtype, device=h.device),
        "v": torch.zeros((B, n_here, kv, hd), dtype=dtype, device=h.device),
        "slot_pos": torch.full((n_here,), -1, dtype=torch.int32,
                               device=h.device),
    }
    take = min(n, S)
    src = torch.arange(S - take, S, device=h.device)  # last `take`
    pos_tail = positions[0, src]
    slots = (pos_tail % n).long()
    if n_here < n and h.device.type == "meta":
        # a cost count's shape-only path (``launch/lowered.py``): the kept
        # slots' number for positions 0..S-1, as prefill numbers them
        keep = sum(s0 <= q % n < s0 + n_here for q in range(S - take, S))
        src, pos_tail, slots = src[:keep], pos_tail[:keep], slots[:keep]
    elif n_here < n:
        mine = (slots >= s0) & (slots < s0 + n_here)
        src, pos_tail, slots = src[mine], pos_tail[mine], slots[mine] - s0
    cache["k"][:, slots] = k[:, src].to(dtype)
    cache["v"][:, slots] = v[:, src].to(dtype)
    cache["slot_pos"][slots] = pos_tail.to(torch.int32)
    return cache


def _sublayer_prefill(p, cfg: ModelConfig, kind: str, x: Tensor,
                      positions: Tensor, max_len: int, dtype,
                      plain_recurrence: bool = False
                      ) -> Tuple[Tensor, PyTree]:
    p = cast_floats(p, x.dtype)
    h = rms_norm(x, p["ln1"])
    if kind == "attn":
        cache = _attn_prefill_cache(p, cfg, h, positions, max_len, dtype)
        x = x + attn_mod.attend(p["mix"], cfg, h, positions)
    elif kind == "rec":
        pm, tp = rglru_mod.local_channels(p["mix"], cfg)
        u = h @ pm["w_in"]
        gate = mlp_mod.gelu(h @ pm["w_gate"])
        cw = cfg.conv_width
        conv, padded = rglru_mod.causal_conv(u, pm["conv"])
        a, b = rglru_mod._gates(pm, conv, shardctx.gather_from_model(
            conv, -1) if tp else None)
        hseq = rglru_mod.linear_recurrence(a, b, plain_recurrence)
        # clones, so the cache does not hold the whole sequence alive
        cache = {"h": hseq[:, -1].clone(),
                 "conv": padded[:, padded.shape[1] - (cw - 1):].clone()}
        out = (hseq.to(x.dtype) * gate) @ pm["w_out"]
        x = x + (shardctx.reduce_from_model(out) if tp else out)
    elif kind == "rwkv":
        return _rwkv_prefill(p, cfg, x)
    else:
        raise _unknown(kind)
    h2 = rms_norm(x, p["ln2"])
    x = x + mlp_mod.ffn(p["ffn"], cfg, h2)[0]
    return x, cache


def _rwkv_prefill(p, cfg: ModelConfig, x: Tensor) -> Tuple[Tensor, PyTree]:
    """Run the rwkv sub-layer over the prompt, returning the terminal
    state: the WKV state (float32) and the last position's two token-shift
    inputs, in the activation dtype as the reference keeps them."""
    h = rms_norm(x, p["ln1"])
    pm = p["mix"]
    # the reference's _wkv_chunked_with_state, which raises here (a
    # ValueError) unless the prompt is a multiple of rwkv6.CHUNK long
    o, state = rwkv_mod.time_mix_with_state(pm, cfg, h)
    x = x + o
    h2 = rms_norm(x, p["ln2"])
    x = x + rwkv_mod.channel_mix(pm, cfg, h2)
    # clones, so the cache does not hold the whole sequence alive; this
    # rank's channels of the shifts under head parallelism
    return x, {"wkv": state,
               "tm_prev": rwkv_mod.own_channels(cfg, h[:, -1]).clone(),
               "cm_prev": rwkv_mod.own_channels(cfg, h2[:, -1]).clone()}


def prefill(cfg: ModelConfig, params, batch: Dict[str, Tensor],
            max_len: Optional[int] = None, cache_dtype=torch.bfloat16,
            plain_recurrence: bool = False) -> Tuple[Tensor, PyTree]:
    """Process a prompt; return (last-position logits (B, V) float32,
    decode cache).  ``plain_recurrence=True`` runs the RG-LRU recurrence
    through its plain version instead of the kernel (a reference route
    for checking the kernel path on the card)."""
    pattern, n_full, tail = block_layout(cfg)
    x = _embed_inputs(cfg, params, batch)
    x = shardctx.constrain(x, "act_batch", "act_seq", "act_embed")
    B, S, _ = x.shape
    max_len = max_len or S
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device).expand(B, S)

    def run(p, kind, x):
        return _sublayer_prefill(p, cfg, kind, x, positions, max_len,
                                 cache_dtype, plain_recurrence)

    cache: Dict[str, Any] = {"pos": S}
    if n_full:
        cache["blocks"] = []
        for blk in params["blocks"]:
            ncache = {}
            for i, kind in enumerate(pattern):
                x, ncache[f"sub{i}"] = run(blk[f"sub{i}"], kind, x)
            x = shardctx.constrain(x, "act_batch", "act_seq", "act_embed")
            cache["blocks"].append(ncache)
    if tail:
        cache["tail"] = []
        for i, kind in enumerate(tail):
            x, c = run(params["tail"][i], kind, x)
            cache["tail"].append(c)
    h = rms_norm(x, params["final_ln"])
    return _logits(cfg, params, h[:, -1]), cache
