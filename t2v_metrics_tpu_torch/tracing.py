"""The port's tracing: spans at the scoring path's layer boundaries, and
always-on integer counters.

Spans. ``with span(name):`` records ``Span(name, id, parent, request,
thread, start_ns, end_ns)`` in memory (``time.perf_counter_ns()``) and opens
``torch.profiler.record_function("t2v." + name)``, so that the span lies in
the profiler's trace on the clock of the kernels (a profiler with its default
settings keeps the ranges of the thread that started it only; ``records()``
has every thread's). Spans are on exactly while a ``torch.profiler`` session
records: an operator turns them on as they would trace the card, and nothing
else does. Off, a span costs one read of a module flag and returns a shared
null context (``record_function`` is not called: it costs microseconds even
with no profiler running).

A span's parent is the innermost span open on its thread; work handed to
another thread passes ``current()`` as ``parent=``, which carries the
request id too. ``request=True`` opens a new request id (the facade's
``forward`` and ``batch_forward``).

Sessions. This module hooks the two functions through which every
``torch.autograd.profiler`` session announces its start and its stop
(``_run_on_profiler_start`` / ``_run_on_profiler_stop``, which set torch's
own flag): a session opens when a profiler starts and closes, with the
counters' totals of that moment, when it stops. A profiler started before
this module was imported turns nothing on; a torch without those functions
leaves tracing off. ``records()`` and ``counts()`` give the newest session's
spans and counter deltas, so after a traced window they hold that window
alone. Spans reach a file through the profiler's ``export_chrome_trace``.

Counters. ``count(name, n)`` adds to an always-on total; it takes no lock
(one dictionary update, which the interpreter lock keeps whole). Names:
``launch.<kernel>`` a kernel launch (read through ``ops.launch_counts()``),
``host_syncs`` a blocking copy between host and device (``to_host``,
counted also on a CPU device, where the copy is none), ``h2d_async`` a
host-to-device copy that does not block (``to_device``, counted also on a
CPU device, where the copy is none),
``t5_enc_rows`` and ``t5_enc_rows_valid`` the rows the T5 encoder computes
and the real pairs' encoder lengths among them (counted only while a span
records, since nothing else reads them); ``moe_rows``, ``moe_mean_rows``,
``moe_block_rows`` and ``moe_max_rows`` the routing of each MoE dispatch
(``ops/moe.py:_count_routing``, only while a session is open).
``count_device(name, t)`` adds a one-element device tensor into the open
session's total on the device, with no host sync; ``counts()`` reads those
totals back, and so waits for the card.

Copies. ``to_device`` and ``to_host`` are the scoring path's copies between
host and device, each spanned and counted. ``to_device`` to a CUDA device
copies from page-locked memory with ``non_blocking=True``, so it neither
blocks the host nor waits for the card; ``host_empty`` gives a page-locked
tensor for a caller to build an array in. ``to_host`` blocks: it is the one
wait of a device stage. ``CopyStream`` runs a stage's uploads on a stream of
their own, beside the compute, and hands the result to the stream that
reads it.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import NamedTuple

import numpy as np
import torch
import torch.autograd.profiler as _profiler


class Span(NamedTuple):
    """A finished span. ``parent`` 0 is a root, ``request`` 0 no request;
    ``thread`` is ``threading.get_native_id()``."""

    name: str
    id: int
    parent: int
    request: int
    thread: int
    start_ns: int
    end_ns: int


class _Session:
    def __init__(self, base: dict):
        self.spans: list[Span] = []
        self.base = base        # the counters' totals at its start
        self.end = None         # and at its end
        self.device: dict[str, torch.Tensor] = {}   # count_device's totals


_totals: collections.defaultdict = collections.defaultdict(int)
_session: _Session | None = None
_open = False
_lock = threading.Lock()        # a session's start and stop only
_local = threading.local()
_ids = itertools.count(1)
_requests = itertools.count(1)
_NULL = contextlib.nullcontext()


def _start() -> None:
    global _session, _open
    with _lock:
        _session = _Session(dict(_totals))
        _open = True


def _close() -> None:
    global _open
    with _lock:
        if _open:
            _session.end = dict(_totals)
            _open = False


def _hook(name: str, ours, after: bool) -> None:
    """Wrap ``torch.autograd.profiler.<name>`` to call ``ours`` after it
    (``after``) or before it, unwrapping an earlier import's wrapper."""
    inner = getattr(_profiler, name)
    inner = getattr(inner, "__wrapped__", inner)

    def hooked(*args, **kwargs):
        if not after:
            ours()
        out = inner(*args, **kwargs)
        if after:
            ours()
        return out

    hooked.__wrapped__ = inner
    setattr(_profiler, name, hooked)


if (hasattr(_profiler, "_run_on_profiler_start")
        and hasattr(_profiler, "_run_on_profiler_stop")):
    _hook("_run_on_profiler_start", _start, after=True)
    _hook("_run_on_profiler_stop", _close, after=False)


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class _Span:
    __slots__ = ("name", "parent", "request", "session", "ids", "rf", "start")

    def __init__(self, name: str, parent, request: bool):
        self.name, self.parent, self.request = name, parent, request

    def __enter__(self):
        self.session = _session
        stack = _stack()
        parent, req = self.parent or (stack[-1] if stack else (0, 0))
        if self.request:
            req = next(_requests)
        self.ids = (next(_ids), req, parent)
        stack.append(self.ids[:2])
        self.rf = _profiler.record_function("t2v." + self.name)
        self.rf.__enter__()
        self.start = time.perf_counter_ns()

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self.rf.__exit__(*exc)
        _local.stack.pop()
        sid, req, parent = self.ids
        self.session.spans.append(Span(self.name, sid, parent, req,
                                       threading.get_native_id(), self.start, end))
        return False


def span(name: str, parent: tuple[int, int] | None = None, request: bool = False):
    """A context manager: the span ``name`` while a profiler records, else
    nothing. ``parent``: ``current()`` of the thread that handed this work
    over; ``request``: open a new request id."""
    if not _open:
        return _NULL
    return _Span(name, parent, request)


def current() -> tuple[int, int] | None:
    """(span id, request id) of this thread's innermost open span, or None
    (none open, or tracing off)."""
    stack = getattr(_local, "stack", None)
    return stack[-1] if stack else None


def count(name: str, n: int = 1) -> None:
    _totals[name] += n


def count_device(name: str, value: torch.Tensor) -> None:
    """Add the one-element tensor ``value`` into the open session's total
    ``name``, on its device and with no host sync; nothing without a
    session. The total is an int64 tensor made outside inference mode, so
    that calls inside and outside it may add to it."""
    session = _session
    if not _open:
        return
    total = session.device.get(name)
    if total is None:
        with torch.inference_mode(False):
            session.device[name] = value.detach().reshape(()).to(torch.int64, copy=True)
    else:
        total.add_(value.reshape(()))


def host_empty(shape, dtype: torch.dtype, device) -> torch.Tensor:
    """An uninitialised host tensor to fill (through ``.numpy()``) and hand
    to ``to_device``: page-locked where ``device`` is CUDA, so its copy needs
    no staging."""
    return torch.empty(shape, dtype=dtype, pin_memory=torch.device(device).type == "cuda")


def to_device(a, device, dtype=None) -> torch.Tensor:
    """A host array or tensor on ``device`` (cast to ``dtype``, one that
    numpy has): the scoring path's one host-to-device copy. To a CUDA device
    it does not block: a source that is not a page-locked tensor of
    ``dtype`` (``host_empty``) is first copied into a page-locked tensor, and
    cast there, by numpy (one thread: a torch copy of this size would start
    the CPU's thread pool on the host path; both casts round to nearest);
    then the copy is queued with ``non_blocking=True`` on the current stream,
    and PyTorch's caching host allocator keeps the page-locked block from
    reuse until that copy has run. Elsewhere it is ``Tensor.to``, no copy
    where the dtype stays. Spanned as ``engine.h2d``; counts one
    ``h2d_async``."""
    with span("engine.h2d"):
        count("h2d_async")
        src = a if isinstance(a, torch.Tensor) else torch.from_numpy(a)
        if torch.device(device).type != "cuda":
            return src.to(device, dtype)
        if dtype not in (None, src.dtype) or not src.is_pinned():
            staged = torch.empty(src.shape, dtype=dtype or src.dtype, pin_memory=True)
            np.copyto(staged.numpy(), src.numpy(), casting="unsafe")
            src = staged
        return src.to(device, non_blocking=True)


def to_host(t: torch.Tensor) -> np.ndarray:
    """A device tensor as float32 numpy: a blocking copy that waits for
    the work queued before it on the current stream. Spanned as
    ``engine.d2h``; counts one ``host_syncs``."""
    with span("engine.d2h"):
        count("host_syncs")
        return t.float().cpu().numpy()


class Staged(NamedTuple):
    """A tensor made by ``CopyStream.run``, and the event recorded on the
    copy stream after its work (None where the work ran on the current
    stream)."""

    value: torch.Tensor
    ready: object

    def take(self) -> torch.Tensor:
        """The tensor, for the current stream: the stream waits for the
        event, and the tensor's memory is marked in use there, so that the
        caching allocator does not hand it out before the reads queued on
        this stream have run."""
        if self.ready is not None:
            stream = torch.cuda.current_stream(self.value.device)
            stream.wait_event(self.ready)
            self.value.record_stream(stream)
        return self.value


class CopyStream:
    """A CUDA device's stream for uploads made ahead of the work that reads
    them: ``run`` queues a function's copies and kernels there, beside the
    compute stream, and the reader ``take``s the result. On any other device
    ``run`` calls the function as it is."""

    def __init__(self, device):
        device = torch.device(device)
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def run(self, fn, *args) -> Staged:
        """``fn(*args)``, a device tensor, with this thread's current stream
        set to the copy stream while it runs."""
        if self.stream is None:
            return Staged(fn(*args), None)
        with torch.cuda.stream(self.stream):
            value = fn(*args)
            ready = torch.cuda.Event()
            ready.record(self.stream)
        return Staged(value, ready)


def totals() -> dict[str, int]:
    """Every counter's total since the process started."""
    return dict(_totals)


def enabled() -> bool:
    """Whether spans record now (a profiler session is open)."""
    return _open


def records() -> list[Span]:
    """The newest session's finished spans (empty before any session)."""
    session = _session
    return list(session.spans) if session is not None else []


def counts() -> dict[str, int]:
    """The counters that moved in the newest session, by how much, and its
    ``count_device`` totals (read back from the device here)."""
    session = _session
    if session is None:
        return {}
    end = session.end if session.end is not None else dict(_totals)
    out = {k: v - session.base.get(k, 0) for k, v in end.items()
           if v != session.base.get(k, 0)}
    out.update((k, int(t)) for k, t in session.device.items())
    return out


def self_ns(spans: list[Span]) -> dict[int, int]:
    """Each span's self time by id: its duration less the part of it that
    its child spans on its own thread cover."""
    children = collections.defaultdict(list)
    for s in spans:
        children[s.parent].append(s)
    out = {}
    for s in spans:
        covered, last = 0, s.start_ns
        mine = [c for c in children.get(s.id, ()) if c.thread == s.thread]
        for c in sorted(mine, key=lambda c: c.start_ns):
            lo, hi = max(c.start_ns, last), min(c.end_ns, s.end_ns)
            if hi > lo:
                covered += hi - lo
                last = hi
        out[s.id] = s.end_ns - s.start_ns - covered
    return out
