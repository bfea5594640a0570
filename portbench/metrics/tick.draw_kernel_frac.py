"""``tick.draw_kernel_frac``: the share of the window's solve ticks whose
coordinate draws were one launch of the port's ``threefry_randint`` kernel:
the port's ``draw.kernel_ticks`` counter (counted at each launch) over the
number of its ``tick.draw`` spans, from
``repro_torch.core.instrument.snapshot()``.  Nothing on a port without the
draw kernel's package (one that draws with int64 PyTorch ops) or in a
window without a solve tick; 0 where every tick's draws skipped the kernel,
as on a CPU."""


def read(ctx):
    try:
        import repro_torch.kernels.prng  # noqa: F401  the draw kernel
        from repro_torch.core.instrument import snapshot
    except ImportError:
        return None
    snap = snapshot()
    draws = snap["spans"].get("tick.draw")
    if not draws or not draws["count"]:
        return None
    return snap["counts"].get("draw.kernel_ticks", 0) / draws["count"]
