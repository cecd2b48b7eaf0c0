"""syncs_per_pair: the program's ``host_syncs`` counter over the traced
window, a pair: the blocking copies between host and device, either way. A
program without its own tracing reports nothing."""

from h100bench.program_trace import count_per_pair


def read(ctx):
    return count_per_pair(ctx, "host_syncs")
