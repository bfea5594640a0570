"""musicgen-large [audio]: decoder-only over EnCodec tokens
(arXiv:2306.05284). 48L d_model=2048 32H (MHA kv=32) d_ff=8192 vocab=2048.
The EnCodec frontend is a stub: input_specs() provides precomputed frame
embeddings; the backbone + 2048-way codebook head are modeled."""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    mlp_type="gelu",
    input_mode="embeddings",
    param_dtype="float32",
)

SMOKE = ModelConfig(
    name="musicgen-smoke",
    family="audio",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=128,
    mlp_type="gelu",
    input_mode="embeddings",
    q_chunk_size=32,
    logits_chunk=32,
)
