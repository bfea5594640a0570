"""h2o-danube-1.8b [dense]: llama+mistral mix with sliding-window attention
(arXiv:2401.16818). 24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000,
window 4096."""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    num_layers=24,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    d_ff=6912,
    vocab_size=32_000,
    window=4096,
    param_dtype="float32",
)

SMOKE = ModelConfig(
    name="h2o-danube-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=128,
    window=16,
    q_chunk_size=32,
    logits_chunk=32,
)
