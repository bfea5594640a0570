"""``device.idle_frac``: the share of the traced window in which no
operation ran on the device, 1 - busy / wall."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr["window_s"] <= 0:
        return None
    return 1.0 - tr["busy_s"] / tr["window_s"]
