"""glue_ms_per_pair: device time of the kernels outside the named families
(elementwise, gathers, routing and dispatch, the resize, reductions,
copies), in ms a pair of the traced window."""


def read(ctx):
    if ctx.window_s is None or not ctx.pairs:
        return None
    return ctx.family_s.get("other", 0.0) * 1e3 / ctx.pairs
