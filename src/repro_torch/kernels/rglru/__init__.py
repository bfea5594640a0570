"""The RG-LRU linear recurrence: the hand-written Hopper kernel
(``csrc/rglru_scan.cu``, wrapped by ``kernel.py``), its plain-torch version
(``ref.py``) and the public op (``ops.py``)."""
from repro_torch.kernels.rglru.ops import rglru_scan

__all__ = ["rglru_scan"]
