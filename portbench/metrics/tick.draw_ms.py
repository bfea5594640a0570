"""``tick.draw_ms``: milliseconds of the device stream between the CUDA
events that bracket the port's ``tick.draw`` span (the threefry draws of a
solve tick, ``core/engine/host.py::HostExecutor.draw_idx``) over their
number, from ``repro_torch.core.instrument.snapshot()``.  Only the ticks
whose draws open on a busy stream are timed, so the draws queue behind the
earlier work while the host issues them; a tick that opens on an idle
stream (a job's first, a round's first after its history is read) is left
out.  Nothing on a CPU, or in a port without the program's spans."""


def read(ctx):
    try:
        from repro_torch.core.instrument import snapshot
    except ImportError:
        return None
    dev = snapshot()["device_ms"].get("tick.draw")
    return dev["ms"] / dev["count"] if dev and dev["count"] else None
