"""Start, join and connect the ranks of a mesh run on one host.

:func:`spawn` runs ``fn(index, *args)`` in ``nprocs`` processes of the
``spawn`` start method (the one CUDA allows), waits at most ``timeout``
seconds for all of them, and raises if one fails (the others are then
terminated) or if the deadline passes (every process still running is
killed).  :func:`init` joins a process group with a bounded collective
timeout, so a rank that dies cannot leave the others waiting on it for
gloo's default of 30 minutes::

    def rank_main(rank, world, path):
        ranks.init(rank, world, f"file://{path}")
        sess = Session.compile(problem, topo, backend="mesh", device="cpu")
        ...

    ranks.spawn(rank_main, 4, args=(4, "/tmp/pg"), timeout=300)

A CUDA program builds its kernels in the parent before it spawns; each
child then loads the built library.
"""
from __future__ import annotations

import time
from datetime import timedelta
from typing import Callable, Sequence

import torch.distributed as dist
import torch.multiprocessing as mp

# the collective timeout of the groups :func:`init` joins
DEFAULT_TIMEOUT = timedelta(seconds=60)


def init(rank: int, world: int, init_method: str, *,
         backend: str = "gloo", timeout: timedelta = DEFAULT_TIMEOUT) -> None:
    """Join the default process group (``init_method`` a ``file://`` path
    or ``tcp://host:port``)."""
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world, timeout=timeout)


def spawn(fn: Callable, nprocs: int, *, args: Sequence = (),
          timeout: float = 600.0) -> None:
    """Run ``fn(index, *args)`` in ``nprocs`` spawned processes and join
    them within ``timeout`` seconds; raises ``TimeoutError`` after killing
    the stragglers, or the failure of a rank that raised or died."""
    ctx = mp.start_processes(fn, args=tuple(args), nprocs=nprocs,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(0.0, min(5.0, deadline -
                                            time.monotonic()))):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            for p in ctx.processes:
                p.join(10)
            raise TimeoutError(
                f"{nprocs} ranks did not finish within {timeout} s; killed")
