"""device_idle: one minus the union of the device's operation intervals
over the profiled window (torch.profiler), in %."""


def read(ctx):
    if not ctx.window_s:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
