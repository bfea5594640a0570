"""The PRNG keys of a run's jobs: two uint32 words from the run's seed,
the job's index and a slot within the job (a grid's seed axis).  The
warm-up job has an index no window job reaches."""
from __future__ import annotations

import torch

WARMUP = 8191
M32 = 0xFFFFFFFF


def job_key(seed: int, index: int, slot: int = 0) -> torch.Tensor:
    """The (2,) int64 key of slot ``slot`` (< 8) of job ``index``."""
    lo = int(seed) & M32
    hi = ((int(seed) >> 32) & 0xFFFF) << 16 | ((index * 8 + slot) & 0xFFFF)
    return torch.tensor([hi, lo], dtype=torch.int64)
