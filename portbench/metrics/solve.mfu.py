"""``solve.mfu``: the whole job's share of the card's peak -- the least
time of the traced window's ``sdca_block`` launches (``portbench/costs``,
bytes or flops at the H100 peaks, whichever bounds) over the window's wall
time, in percent.  It bounds any kernel's share from above, and keeps
bounding a gain after a later change takes a kernel off the path."""
from portbench.costs import sdca_block
from portbench.harness.trace import kernel_time


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr["window_s"] <= 0:
        return None
    n, _ = kernel_time(tr, "sdca_block_kernel")
    if not n:
        return None
    return 100.0 * n * sdca_block.least_seconds(ctx["launch_shape"]) \
        / tr["window_s"]
