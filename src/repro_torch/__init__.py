"""PyTorch/CUDA port of the tree-network distributed SDCA solver.

Laid out like the JAX package ``repro`` (each module has a counterpart of
the same name) and checked against it; it imports neither JAX nor
``repro``.  The user surface is ``repro_torch.api``: ``Problem``,
``Topology``, ``Schedule`` and ``Session``, running on ``device="cuda"``
unless the caller asks for the CPU.
"""
