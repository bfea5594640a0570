"""Model configurations of every architecture the port serves
(framework-free copies of the JAX package's ``repro.configs``)."""
from repro_torch.configs.base import ModelConfig  # noqa: F401
from repro_torch.configs.registry import (ARCHS, get_config,  # noqa: F401
                                          get_smoke_config)
