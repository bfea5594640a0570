"""Hand-written CUDA kernels for Hopper (sm_90a), one package per kernel,
each with its wrapper (``kernel.py``), its plain-torch version (``ref.py``)
and its CUDA source under ``csrc/``; ``_build.py`` compiles the sources
at first use.

  sdca             -- Procedure P (LocalSDCA) for every leaf of a tick in
                      one launch: the counterpart of the JAX package's
                      Pallas ``sdca_block_kernel``.
  flash_attention  -- forward blocked online-softmax attention (causal /
                      window, GQA, query offset): the counterpart of
                      ``flash_attention_kernel``; the LM prefill's attention.
                      Two sources, chosen by dtype: a wgmma + TMA kernel
                      for bf16, a CUDA-core kernel for f32.
  rglru            -- the RG-LRU linear recurrence h_t = a_t h_{t-1} + b_t:
                      the counterpart of ``rglru_scan_kernel``; the LM
                      prefill's recurrent layers.
  prng             -- a solve tick's coordinate draws, jax's threefry
                      ``randint`` for every (config, leaf) row in one
                      launch; no TPU counterpart (the reference's draws
                      are ``jax.random``, fused by XLA).
"""
