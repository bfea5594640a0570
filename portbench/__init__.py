"""The benchmark of the PyTorch/CUDA port (``src/repro_torch``): tree-network
SDCA solves and grids driven as data.  ``python3 portbench/run.py --workload
<cell> --seed <n> --seconds <s> --trace <0|1>`` runs one cell once; see
``run.py``."""
