"""call_p95_ms: the 95th percentile of every call's latency in the window
(host clock, from the call to its scores on the host)."""

import numpy as np


def read(ctx):
    if not ctx.call_seconds:
        return None
    return float(np.percentile(np.asarray(ctx.call_seconds, np.float64), 95)) * 1e3
