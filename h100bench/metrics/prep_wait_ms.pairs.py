"""prep_wait_ms: the program's ``facade.prep_wait`` spans over the traced
window, in ms a pair: the main thread of the staged pipeline waiting for the
host stage before it can dispatch a chunk. A program without its own tracing
reports nothing."""

from h100bench.program_trace import span_ms_per_pair


def read(ctx):
    return span_ms_per_pair(ctx, ("facade.prep_wait",))
