"""rwkv6-1.6b "Finch" [ssm]: attention-free, data-dependent decay
(arXiv:2404.05892). 24L d_model=2048 d_ff=7168 vocab=65536."""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    num_layers=24,
    d_model=2048,
    num_heads=0,
    num_kv_heads=0,
    d_ff=7168,
    vocab_size=65_536,
    is_rwkv=True,
    rwkv_head_dim=64,
    param_dtype="float32",
)

SMOKE = ModelConfig(
    name="rwkv6-smoke",
    family="ssm",
    num_layers=2,
    d_model=64,
    num_heads=0,
    num_kv_heads=0,
    d_ff=128,
    vocab_size=128,
    is_rwkv=True,
    rwkv_head_dim=16,
    logits_chunk=32,
)
