"""adapter_host_ms_per_pair: the seconds of the benchmark's host span around
the adapter's host-only stage (``prepare_pairs`` of the staged pipeline),
summed over the traced window, in ms a pair. A family with no host-only
call opens no such span, and the metric is left out."""


def read(ctx):
    prep = ctx.spans_s.get("prep")
    if prep is None or not ctx.pairs:
        return None
    return prep * 1e3 / ctx.pairs
