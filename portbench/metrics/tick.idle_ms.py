"""``tick.idle_ms``: the device's idle time in the traced window per solve
tick of a solve, a tick counted by its ``sdca_block`` launch: the host
side of a tick in ``api/session.py``'s run loop and ``core/engine/host.py``'s
tick loop (the key plan, draws, syncs, records) that the device waits
for."""
from portbench.harness.trace import idle_ms_per_launch


def read(ctx):
    tr = ctx["trace"]
    return None if tr is None else idle_ms_per_launch(tr)
