"""Published peaks of one NVIDIA H100 SXM (the data sheet's dense rates, no
sparsity), at its full 700 W power limit.  A card set below that limit runs
slower under load; the harness reports the limit beside every result.

A frozen copy: the port's ``launch/hw.py`` holds the same numbers, and a
later change to it moves no share this benchmark reports.
"""

PEAK_FLOPS_F32 = 67e12        # flop/s, float32 outside the tensor cores
PEAK_FLOPS_BF16 = 989e12      # flop/s, dense bf16 tensor cores
HBM_BW = 3.35e12              # bytes/s, HBM3
HBM_BYTES = 80e9              # the data sheet's 80 GB


def least_seconds(flops: float, nbytes: float,
                  peak_flops: float = PEAK_FLOPS_F32) -> float:
    """The least time a launch of ``flops`` operations (at ``peak_flops``)
    moving ``nbytes`` bytes can take: the larger of its two bounds."""
    return max(flops / peak_flops, nbytes / HBM_BW)
