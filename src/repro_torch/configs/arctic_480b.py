"""arctic-480b [moe]: 128 experts top-2 + dense residual MLP
(hf:Snowflake/snowflake-arctic-base). 35L d_model=7168 56H (GQA kv=8)
d_ff=4864 vocab=32000. Adafactor + bf16 params (param+opt state would
exceed HBM with AdamW f32 -- see DESIGN.md SS5)."""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=4864,
    vocab_size=32_000,
    num_experts=128,
    experts_per_token=2,
    moe_dense_ff=4864,
    optimizer="adafactor",
    param_dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="arctic-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=96,
    vocab_size=128,
    num_experts=8,
    experts_per_token=2,
    moe_dense_ff=96,
    optimizer="adafactor",
    q_chunk_size=32,
    logits_chunk=32,
)
