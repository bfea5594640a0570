"""``sweep.idle_ms``: the device's idle time in the traced window per solve
tick of a grid, a tick counted by its one ``sdca_block`` launch for all
members: the host side of ``api/sweep.py``'s batched executor (each
member's key plan, the step masks built on the host and copied over, the
syncs and records config by config) that the device waits for."""
from portbench.harness.trace import idle_ms_per_launch


def read(ctx):
    tr = ctx["trace"]
    return None if tr is None else idle_ms_per_launch(tr)
