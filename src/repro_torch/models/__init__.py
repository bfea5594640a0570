"""The decoder-only LM stack of the JAX package's ``repro.models``, for the
kinds the port serves so far (``attn`` and ``rec``, as ``recurrentgemma-2b``
uses them).  Parameters and caches are nested dicts of tensors laid out as
the reference's, with the stacked ``blocks`` as a list of per-block dicts."""
