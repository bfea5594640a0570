"""``sdca_block.reg_w_frac``: the share of the traced window's
``sdca_block`` launches whose stepping warp kept w in registers, told
apart in the profiler's trace by the device name: the second template
argument of ``sdca_block_kernel<loss, NC>`` (and of
``sdca_block_kernel_gmem_leaf<loss, NC>``) is the number of float4 chunks
of w a lane holds, 0 where w lives in shared memory.  Nothing on a CPU or
in a window without a launch."""
import re

from portbench.harness.trace import kernel_time

DEVICE_NAME = re.compile(r"sdca_block_kernel(?:_gmem_leaf)?<[^,<>]+,\s*(\d+)>")


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    n, _ = kernel_time(tr, "sdca_block_kernel")
    if not n:
        return None
    reg = 0
    for name, (count, _) in tr["kernels"].items():
        m = DEVICE_NAME.search(name)
        if m is not None and int(m.group(1)) > 0:
            reg += count
    return reg / n
