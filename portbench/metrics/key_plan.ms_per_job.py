"""``key_plan.ms_per_job``: host milliseconds in the port's ``key_plan``
spans over the window's jobs -- each run's (or each grid group's) threefry
key plan from ``core/engine/plan.py::chunked_key_plan`` on the host and its
copy to the device (``api/session.py``, ``api/sweep.py``), read from
``repro_torch.core.instrument.snapshot()``.  A port without the program's
spans reads nothing."""


def read(ctx):
    try:
        from repro_torch.core.instrument import snapshot
    except ImportError:
        return None
    span = snapshot()["spans"].get("key_plan")
    jobs = len(ctx["job_seconds"])
    return span["seconds"] * 1e3 / jobs if span and jobs else None
