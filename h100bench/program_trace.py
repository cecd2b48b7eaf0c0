"""What the per-layer readers take from the program's own tracing
(``t2v_metrics_tpu_torch/tracing.py``): the spans and counter deltas of its
newest session, which a traced window's profiler opened. A program without
that module, or a session with no span, gives nothing."""

from __future__ import annotations


def session():
    """(tracing module, spans, counter deltas), or None."""
    try:
        from t2v_metrics_tpu_torch import tracing
    except ImportError:                 # a program without its own tracing
        return None
    spans = tracing.records()
    if not spans:
        return None
    return tracing, spans, tracing.counts()


def span_ms_per_pair(ctx, names, self_time: bool = False):
    """The time of the spans ``names`` (their self time, with
    ``self_time``) summed over the session, in ms a pair of the window."""
    got = session()
    if got is None or not ctx.pairs:
        return None
    tracing, spans, _ = got
    own = tracing.self_ns(spans) if self_time else None
    ns = sum(own[s.id] if self_time else s.end_ns - s.start_ns
             for s in spans if s.name in names)
    return ns * 1e-6 / ctx.pairs


def count_per_pair(ctx, name: str):
    """The counter ``name``'s delta over the session, a pair of the window."""
    got = session()
    if got is None or not ctx.pairs:
        return None
    return got[2].get(name, 0) / ctx.pairs
