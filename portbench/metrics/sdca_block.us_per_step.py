"""``sdca_block.us_per_step``: the ``sdca_block`` kernel's device time
per launch in the traced window over the launch's steps (its H
capacity), in microseconds: one dependent coordinate step of a leaf."""
from portbench.harness.trace import kernel_time


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    n, sec = kernel_time(tr, "sdca_block_kernel")
    return sec / n / ctx["launch_shape"]["H"] * 1e6 if n else None
