"""h2d_ms: the program's ``engine.h2d`` spans over the traced window, in ms a
pair: each host-to-device copy of the scoring path with its wait for the
work queued before it (the copies are pageable and blocking). A program
without its own tracing reports nothing."""

from h100bench.program_trace import span_ms_per_pair


def read(ctx):
    return span_ms_per_pair(ctx, ("engine.h2d",))
