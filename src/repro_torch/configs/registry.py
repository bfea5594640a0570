"""--arch registry: the architectures the port can serve, each mapped to
its (full, smoke) configs.  The JAX package's registry lists ten; the rest
wait on the modules ROADMAP A9 names."""
from repro_torch.configs import recurrentgemma_2b

ARCHS = {
    "recurrentgemma-2b": recurrentgemma_2b,
}


def get_config(arch: str):
    return ARCHS[arch].FULL


def get_smoke_config(arch: str):
    return ARCHS[arch].SMOKE
