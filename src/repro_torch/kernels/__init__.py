"""Hand-written CUDA kernels for Hopper (sm_90a), one package per kernel,
each with its wrapper (``kernel.py``), its plain-torch version (``ref.py``)
and its CUDA source under ``csrc/``; ``_build.py`` compiles the sources
at first use.

  sdca  -- Procedure P (LocalSDCA) for every leaf of a tick in one launch:
           the counterpart of the JAX package's Pallas ``sdca_block_kernel``.

The JAX package's ``flash_attention`` and ``rglru`` kernels serve only the
LM workload and are not ported yet.
"""
