"""The device's idle share of the profiled sub-window: 100 minus the union
of its kernel, copy and memset intervals over the window's wall time."""


def read(ctx):
    t = ctx.trace
    if t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
