"""Blocked online-softmax attention: the hand-written Hopper kernel
(``csrc/flash_attention.cu``, wrapped by ``kernel.py``), its plain-torch
version (``ref.py``) and the public op (``ops.py``)."""
from repro_torch.kernels.flash_attention.ops import flash_attention

__all__ = ["flash_attention"]
