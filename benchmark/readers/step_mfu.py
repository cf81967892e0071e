"""The whole step's share of the cell's chips' dense bf16 peak: the model
FLOPs of a pair or a (global) step (``counts.flops``, on the reference
system) times the pairs or steps finished in the traced run's window, over
the window's seconds and the peak of the cell's chips, in %."""
from ..counts import peaks


def read(ctx):
    if ctx.window_s <= 0 or not ctx.items:
        return None
    rate = ctx.flops_per_item * ctx.items / ctx.window_s
    return 100.0 * rate / (peaks.BF16_DENSE_FLOPS * ctx.cell.chips)
