"""recurrentgemma-2b [hybrid]: RG-LRU + local attention, 1 attn : 2 recurrent
(arXiv:2402.19427). 26L d_model=2560 10H (GQA kv=1, head_dim 256) d_ff=7680
vocab=256000, local-attention window 2048, tied embeddings (Gemma-style)."""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256_000,
    window=2048,
    block_pattern=("rec", "rec", "attn"),
    lru_width=2560,
    tie_embeddings=True,
    mlp_type="swiglu",
    param_dtype="float32",
)

SMOKE = ModelConfig(
    name="recurrentgemma-smoke",
    family="hybrid",
    num_layers=4,          # one full (rec, rec, attn) block + 1 tail rec
    d_model=64,
    num_heads=4,
    num_kv_heads=1,
    head_dim=16,
    d_ff=128,
    vocab_size=128,
    window=16,
    block_pattern=("rec", "rec", "attn"),
    lru_width=64,
    tie_embeddings=True,
    q_chunk_size=32,
    logits_chunk=32,
)
