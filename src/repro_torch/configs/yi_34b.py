"""yi-34b [dense]: llama-arch GQA (arXiv:2403.04652).
60L d_model=7168 56H (GQA kv=8, head_dim 128) d_ff=20480 vocab=64000."""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="yi-34b",
    family="dense",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=20_480,
    vocab_size=64_000,
    param_dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="yi-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=128,
    q_chunk_size=32,
    logits_chunk=32,
)
