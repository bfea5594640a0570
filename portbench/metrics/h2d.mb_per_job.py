"""``h2d.mb_per_job``: megabytes (1e6 bytes) of the host-built operands a
job hands to the device -- key plans, step masks, participation masks and
warm starts, from the port's ``h2d_bytes`` counter
(``repro_torch.core.instrument.snapshot()``) -- over the window's jobs.
A port without the program's counters reads nothing."""


def read(ctx):
    try:
        from repro_torch.core.instrument import snapshot
    except ImportError:
        return None
    n = snapshot()["counts"].get("h2d_bytes")
    jobs = len(ctx["job_seconds"])
    return n / 1e6 / jobs if n is not None and jobs else None
