"""``sdca_block_roofline``: the least time of the traced window's
``sdca_block`` launches (``portbench/costs/sdca_block.py`` at the H100
peaks of ``portbench/costs/h100.py``: bytes or flops, whichever bounds)
over their device time from the profiler, in percent."""
from portbench.costs import sdca_block
from portbench.harness.trace import kernel_time


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    n, sec = kernel_time(tr, "sdca_block_kernel")
    if not n or sec <= 0:
        return None
    return 100.0 * n * sdca_block.least_seconds(ctx["launch_shape"]) / sec
