"""The plain reference of the benchmark's correctness check: the paper's
tree-network SDCA (Algorithms 1-3) in plain PyTorch, with a frozen copy of
the threefry key replay.  Imports nothing of the port (``repro_torch``),
of the JAX package (``repro``) or of JAX."""
