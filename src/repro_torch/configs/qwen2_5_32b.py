"""qwen2.5-32b [dense]: GQA + QKV bias (hf:Qwen/Qwen2.5 family).
64L d_model=5120 40H (GQA kv=8, head_dim 128) d_ff=27648 vocab=152064."""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="qwen2.5-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=27_648,
    vocab_size=152_064,
    qkv_bias=True,
    param_dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="qwen2.5-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=128,
    qkv_bias=True,
    q_chunk_size=32,
    logits_chunk=32,
)
