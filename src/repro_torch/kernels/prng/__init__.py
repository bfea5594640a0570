"""A solve tick's coordinate draws: the hand-written Hopper kernel
(``csrc/threefry_randint.cu``, wrapped by ``kernel.py``) and its plain
version (``ref.py``, over ``core/prng.py::randint``)."""
from repro_torch.kernels.prng.kernel import randint_rows

__all__ = ["randint_rows"]
