"""--arch registry: maps architecture ids to (full, smoke) configs, the
JAX package's ten in its order."""
from repro_torch.configs import (
    arctic_480b,
    dbrx_132b,
    h2o_danube_1_8b,
    llava_next_34b,
    musicgen_large,
    qwen2_5_32b,
    qwen3_32b,
    recurrentgemma_2b,
    rwkv6_1_6b,
    yi_34b,
)

ARCHS = {
    "recurrentgemma-2b": recurrentgemma_2b,
    "musicgen-large": musicgen_large,
    "qwen3-32b": qwen3_32b,
    "qwen2.5-32b": qwen2_5_32b,
    "h2o-danube-1.8b": h2o_danube_1_8b,
    "yi-34b": yi_34b,
    "rwkv6-1.6b": rwkv6_1_6b,
    "llava-next-34b": llava_next_34b,
    "dbrx-132b": dbrx_132b,
    "arctic-480b": arctic_480b,
}


def get_config(arch: str):
    return ARCHS[arch].FULL


def get_smoke_config(arch: str):
    return ARCHS[arch].SMOKE
