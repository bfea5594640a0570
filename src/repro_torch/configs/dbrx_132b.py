"""dbrx-132b [moe]: 16 experts top-4, fine-grained (hf:databricks/dbrx-base).
40L d_model=6144 48H (GQA kv=8, head_dim 128) d_ff=10752 vocab=100352."""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="dbrx-132b",
    family="moe",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=10_752,
    vocab_size=100_352,
    num_experts=16,
    experts_per_token=4,
    param_dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="dbrx-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=128,
    num_experts=4,
    experts_per_token=2,
    q_chunk_size=32,
    logits_chunk=32,
)
