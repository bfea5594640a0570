"""Blocked LocalSDCA: the hand-written Hopper kernel (``csrc/sdca_block.cu``,
wrapped by ``kernel.py``), its plain-torch version (``ref.py``) and one
CoCoA round built on it (``ops.py``)."""
from repro_torch.kernels.sdca.ops import sdca_block_solve

__all__ = ["sdca_block_solve"]
