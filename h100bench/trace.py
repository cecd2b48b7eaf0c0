"""The traced run: the benchmark's own host spans, and the reduction of a
``torch.profiler`` trace to device busy time, device time by kernel family,
the top device operations and the longest idle gaps.

Spans are opened by the benchmark around the calls it makes into the port
(``Spans.wrap``); each is also a ``record_function`` range, so the trace
places it on the device's timeline, and an idle gap is labelled by the span
that was open at its middle: the main thread's first (dispatch, drain,
call), else the host stage's thread (prep).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import time

from .peaks import kernel_family

PREFIX = "h100bench."
WINDOW = PREFIX + "window"
MAIN_FIRST = ("drain", "dispatch", "prep", "call", "round")


class Spans:
    """Host spans by name: their total seconds."""

    def __init__(self):
        self.seconds = collections.defaultdict(float)
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def __call__(self, name: str):
        from torch.profiler import record_function

        t = time.perf_counter()
        with record_function(PREFIX + name):
            yield
        dt = time.perf_counter() - t
        with self._lock:
            self.seconds[name] += dt

    def reset(self) -> None:
        self.seconds.clear()

    def wrap(self, obj, attr: str, name: str, drain: bool = False) -> None:
        """Time ``obj.attr`` calls as span ``name``; with ``drain``, the
        first element of the tuple it returns is read back under a "drain"
        span (``np.asarray`` of it waits for the device)."""
        fn = getattr(obj, attr)
        spans = self

        class _Drained:
            def __init__(self, inner):
                self.inner = inner

            def __array__(self, dtype=None, copy=None):
                import numpy as np

                with spans("drain"):
                    return np.asarray(self.inner, dtype)

        def wrapped(*args, **kwargs):
            with spans(name):
                out = fn(*args, **kwargs)
            if drain and isinstance(out, tuple):
                out = (_Drained(out[0]),) + out[1:]
            return out

        setattr(obj, attr, wrapped)


@dataclasses.dataclass
class Reduced:
    window_s: float
    busy_s: float
    family_s: dict
    device_ops: list        # [[name, seconds], ...] the top 10
    idle_gaps: list         # [[label, seconds], ...] the top 10


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce(prof) -> Reduced:
    """The window's numbers from a profiler trace whose events hold one
    ``h100bench.window`` range (times in microseconds)."""
    from torch.autograd import DeviceType

    device, spans, window = [], [], None
    for evt in prof.events():
        start, end = evt.time_range.start, evt.time_range.end
        if evt.name.startswith(PREFIX) and evt.device_type == DeviceType.CUDA:
            continue                  # a span's copy on the device's timeline
        if evt.device_type == DeviceType.CUDA and not getattr(evt, "is_user_annotation", False):
            device.append((evt.name, start, end))
        elif evt.name == WINDOW:
            window = (start, end)
        elif evt.name.startswith(PREFIX):
            spans.append((evt.name[len(PREFIX):], start, end))
    if window is None:
        raise RuntimeError("the trace holds no window range")
    w0, w1 = window
    inside = [(n, max(s, w0), min(e, w1)) for n, s, e in device if e > w0 and s < w1]
    merged = _merge([(s, e) for _, s, e in inside])
    busy = sum(e - s for s, e in merged)
    family, by_name = collections.defaultdict(float), collections.defaultdict(float)
    for n, s, e in inside:
        family[kernel_family(n)] += (e - s) * 1e-6
        by_name[n] += (e - s) * 1e-6
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    def label(mid):
        open_ = {n for n, s, e in spans if s <= mid <= e}
        return next((n for n in MAIN_FIRST if n in open_), "none")

    gaps.sort(key=lambda g: g[0] - g[1])
    top_gaps = [[label((s + e) / 2), (e - s) * 1e-6] for s, e in gaps[:10]]
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return Reduced((w1 - w0) * 1e-6, busy * 1e-6, dict(family),
                   [[n, s] for n, s in top_ops], top_gaps)
