"""mfu: the model operations of the units the traced window completed
(matrix products and attention, counted from the inputs' shapes) over the
window's seconds and the H100's bf16 peak, in %."""

from h100bench.peaks import PEAK_OPS_S


def read(ctx):
    if not ctx.window_s:
        return None
    ops = sum(o for _, o, _ in ctx.work)
    return 100.0 * ops / (ctx.window_s * PEAK_OPS_S["bf16"])
