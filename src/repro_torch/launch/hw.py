"""NVIDIA H100 SXM constants used by the roofline analysis (the JAX
package's ``launch/hw.py`` holds its target's; these are the port's).

Rates are the NVIDIA H100 SXM5 data sheet's dense (no sparsity) peaks;
none is measured here.  ``chip_smoke.py`` takes its kernels' bounds from
``HBM_BW``, ``PEAK_FLOPS_F32`` and ``PEAK_FLOPS_BF16``.
"""

PEAK_FLOPS_BF16 = 989e12      # per GPU, dense bf16 tensor cores
PEAK_FLOPS_TF32 = 494.7e12    # per GPU, dense TF32 tensor cores
PEAK_FLOPS_F32 = 67e12        # per GPU, float32 outside the tensor cores
HBM_BW = 3.35e12              # bytes/s per GPU, HBM3
NVLINK_BW = 450e9             # bytes/s per GPU per direction, NVLink 4
# a link that leaves the node: one 400 Gb/s NDR InfiniBand port per GPU
NETWORK_BW = 50e9             # bytes/s per GPU per direction
NVLINK_LATENCY = 2e-6         # s per collective step inside a node
NETWORK_LATENCY = 5e-6        # s per collective step across nodes
GPUS_PER_NODE = 8             # an HGX H100 board
SMS = 132                     # streaming multiprocessors
SMEM_PER_SM = 228 * 2**10     # shared memory per SM, bytes
HBM_PER_CHIP = 80 * 2**30     # the data sheet's 80 GB of HBM3, as 80 GiB
