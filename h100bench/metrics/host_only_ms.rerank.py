"""host_only_ms: the self time of the program's ``engine.decode`` and
``engine.tokenize`` spans over the traced window, in ms a pair: decoding,
stacking and tokenizing on the host, with no copy and no wait on the card.
A program without its own tracing reports nothing."""

from h100bench.program_trace import span_ms_per_pair


def read(ctx):
    return span_ms_per_pair(ctx, ("engine.decode", "engine.tokenize"), self_time=True)
