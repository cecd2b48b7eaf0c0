"""call_p50_ms.rerank: the median latency of every call in the traced
window (host clock)."""

import numpy as np


def read(ctx):
    if not ctx.call_seconds:
        return None
    return float(np.median(np.asarray(ctx.call_seconds, np.float64))) * 1e3
