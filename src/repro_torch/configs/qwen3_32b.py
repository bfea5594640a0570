"""qwen3-32b [dense]: qk_norm + GQA (hf:Qwen/Qwen3 family).
64L d_model=5120 64H (GQA kv=8, head_dim 128) d_ff=25600 vocab=151936."""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="qwen3-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=25_600,
    vocab_size=151_936,
    qk_norm=True,
    param_dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="qwen3-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=128,
    qk_norm=True,
    q_chunk_size=32,
    logits_chunk=32,
)
