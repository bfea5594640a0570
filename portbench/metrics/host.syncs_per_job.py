"""``host.syncs_per_job``: the blocking reads of the device a job makes --
each history materialized while values are pending (``api/session.py``),
a grid group's histories (``api/sweep.py``), a tensor ``lm`` read by a
batched step -- from the port's ``host_syncs`` counter
(``repro_torch.core.instrument.snapshot()``), over the window's jobs.  A
port without the program's counters reads nothing."""


def read(ctx):
    try:
        from repro_torch.core.instrument import snapshot
    except ImportError:
        return None
    n = snapshot()["counts"].get("host_syncs")
    jobs = len(ctx["job_seconds"])
    return n / jobs if n is not None and jobs else None
