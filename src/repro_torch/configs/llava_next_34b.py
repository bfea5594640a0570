"""llava-next-34b [vlm]: yi-34b text backbone; anyres vision tiling is a
stub -- input_specs() provides precomputed patch embeddings
(hf:llava-hf/llava-v1.6). 60L d_model=7168 56H (GQA kv=8) d_ff=20480
vocab=64000."""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=20_480,
    vocab_size=64_000,
    input_mode="embeddings",
    param_dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="llava-smoke",
    family="vlm",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=128,
    input_mode="embeddings",
    q_chunk_size=32,
    logits_chunk=32,
)
