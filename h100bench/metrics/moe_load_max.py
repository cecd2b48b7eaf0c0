"""moe_load_max: the routing skew over the traced window, the sum of each
MoE dispatch's largest expert group (``moe_max_rows``) over the sum of its
mean group, T x k / E (``moe_mean_rows``, counted in hundredths): how many
times the mean rows the grouped GEMM's slowest group holds. 1 is a perfectly
even routing. A program without these counters reports nothing."""

from h100bench.program_trace import session


def read(ctx):
    got = session()
    counts = got[2] if got is not None else {}
    largest, mean = counts.get("moe_max_rows"), counts.get("moe_mean_rows")
    if not largest or not mean:
        return None
    return 100.0 * largest / mean
