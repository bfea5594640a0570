"""``sweep.leaves_per_launch``: the (config, leaf) blocks the window's
``sdca_block`` launches solved over their number, from the port's own
counters (``kernels/sdca/kernel.py``: ``LEAVES`` / ``LAUNCHES``): how much
of a grid the batched executor (``api/sweep.py``) puts in one launch."""


def read(ctx):
    return ctx["leaves"] / ctx["launches"] if ctx["launches"] else None
