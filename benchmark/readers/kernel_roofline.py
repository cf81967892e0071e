"""A hand kernel's share of its roofline over the profiled sub-window: the
least time of its launches (``counts.kernels`` at the cell's launch shape,
times the launches the trace holds) over their summed device time, in %.
None when the trace holds no launch of it."""


def read(ctx, kernel: str):
    seconds, launches = ctx.trace.kernel(kernel)
    if not launches or seconds <= 0:
        return None
    return 100.0 * ctx.kernel_bound_s(kernel) * launches / seconds
