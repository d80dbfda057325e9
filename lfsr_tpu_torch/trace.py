"""The program's own spans and counters, on the profiler's clock.

:func:`span` names a stage of the program (``with trace.span("eval.pad"):``
or ``@trace.span("K1")``). It records only while ``torch.profiler``
records: off, it costs one read of the profiler's flag and returns a
shared null context; on, it opens ``record_function("lfsr." + name)``, so
the stage lands in the profiler's trace on the profiler's clock and on
the thread that ran it (for backward work, the autograd engine's), and
keeps a record in memory: the name, the thread, the span it is nested in
on that thread, its root (the outermost span open on its thread, or for a
thread with none open, the outermost one open elsewhere: the step or
dispatch the autograd engine works for), the host's start and end
(``time.perf_counter_ns``) and, where CUDA is in use, a pair of timing
events on the current stream. A span decides at entry: one entered while
the profiler is off stays unrecorded.

:func:`count` increments the one counter table (:func:`counter`,
:func:`counts`, :func:`reset_counts`): each kernel's launches
(``launches/<K>``, and ``launches/<K>/<kernel>`` for a wrapper with two
kernels) and ``h2d_copies``, the host data :func:`upload` copies to the
model's device (counted on every device, so a CPU run counts what the
card would copy). Increments made while the profiler records also go to
the recording's own tally.

:func:`summary` gives, per span name, the calls and the host and device
milliseconds, whole and self (less the spans nested in it), and the
tally. A recording starts afresh: the first span or count made after the
profiler was seen off drops the records and tally of the one before.
:func:`reset` drops them at once. The profiler's own chrome trace
(``prof.export_chrome_trace``) shows the ``lfsr.*`` spans with the kernels.
"""

from __future__ import annotations

import functools
import threading
import time

import torch
from torch.autograd import profiler as _prof

PREFIX = "lfsr."

_COUNTS: dict[str, int] = {}   # the counter table
_TALLY: dict[str, int] = {}    # its increments made while recording
_RECORDS: list = []            # spans recorded, in the order they were entered
_EVENTS: list = []             # timing events free for reuse
_local = threading.local()     # .stack: the spans open on this thread
_lock = threading.Lock()       # guards the counter table and the tally
_between = True                # the profiler was seen off since the last record
_root = None                   # the outermost span opened last


class _Record:
    __slots__ = ("name", "thread", "parent", "root", "t0", "t1", "e0", "e1", "dev_ms")

    def __init__(self, name, thread, parent, root):
        self.name, self.thread, self.parent, self.root = name, thread, parent, root
        self.t0 = self.t1 = self.e0 = self.e1 = self.dev_ms = None

    def host_ms(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def device_ms(self) -> float:
        """Event-timed on a CUDA stream; the host's time where the work ran
        on the CPU (synchronously)."""
        if self.dev_ms is None:
            self.dev_ms = self.e0.elapsed_time(self.e1) if self.e0 is not None else self.host_ms()
        return self.dev_ms


def _event():
    ev = _EVENTS.pop() if _EVENTS else torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _begin() -> None:
    """A new recording: drop the last one's records and tally."""
    global _between
    _between = False
    reset()


class _Span:
    __slots__ = ("rec", "rf")

    def __init__(self, name: str):
        if _between:
            _begin()
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.rec = _Record(name, threading.get_ident(), stack[-1] if stack else None, None)

    def __enter__(self):
        global _root
        rec = self.rec
        self.rf = torch.profiler.record_function(PREFIX + rec.name)
        self.rf.__enter__()
        stack = _local.stack
        if stack:
            rec.root = stack[0]
        elif _root is not None and _root.t1 is None:
            rec.root = _root
        else:
            rec.root = _root = rec
        stack.append(rec)
        _RECORDS.append(rec)
        if torch.cuda.is_initialized():
            rec.e0 = _event()
        rec.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        rec = self.rec
        rec.t1 = time.perf_counter_ns()
        if rec.e0 is not None:
            rec.e1 = _event()
        _local.stack.pop()
        self.rf.__exit__(*exc)
        return False

    def __call__(self, fn):
        return _spanned(self.rec.name, fn)


def _spanned(name: str, fn):
    """``fn`` with each call inside :func:`span` ``name``."""

    @functools.wraps(fn)
    def spanned(*args, **kwargs):
        with span(name):
            return fn(*args, **kwargs)

    return spanned


class _Null:
    """What :func:`span` returns while the profiler is off: enters and
    leaves doing nothing; as a decorator, spans each call of the function."""
    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __call__(self, fn):
        return _spanned(self.name, fn)


_NULLS: dict[str, _Null] = {}


def span(name: str):
    """The stage ``name`` (``lfsr.<name>`` in the profiler's trace), as a
    context manager or a decorator; recorded only while the profiler
    records."""
    global _between
    if _prof._is_profiler_enabled:
        return _Span(name)
    _between = True
    null = _NULLS.get(name)
    if null is None:
        null = _NULLS[name] = _Null(name)
    return null


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` (and to the recording's tally while
    the profiler records)."""
    global _between
    recording = _prof._is_profiler_enabled
    if recording and _between:
        _begin()
    with _lock:  # the autograd engine's threads count too
        _COUNTS[name] = _COUNTS.get(name, 0) + n
        if recording:
            _TALLY[name] = _TALLY.get(name, 0) + n
    if not recording:
        _between = True


def declare(*names: str) -> None:
    """Put counters in the table at 0, so :func:`counts` lists them before
    their first increment."""
    with _lock:
        for name in names:
            _COUNTS.setdefault(name, 0)


def counter(name: str) -> int:
    return _COUNTS.get(name, 0)


def counts(prefix: str = "") -> dict[str, int]:
    """The counters whose names start with ``prefix``, keyed by the rest of
    the name (a snapshot)."""
    with _lock:
        return {k[len(prefix):]: v for k, v in _COUNTS.items() if k.startswith(prefix)}


def reset_counts(prefix: str = "") -> None:
    """Set the counters whose names start with ``prefix`` to 0."""
    with _lock:
        for k in _COUNTS:
            if k.startswith(prefix):
                _COUNTS[k] = 0


def upload(data, device, dtype=None) -> torch.Tensor:
    """Host data (a numpy array, a Python number, a CPU tensor) as a tensor
    on ``device`` (``torch.as_tensor``), counted as one ``h2d_copies``."""
    count("h2d_copies")
    return torch.as_tensor(data, dtype=dtype, device=device)


def records() -> list:
    """The closed spans of the recording, in the order they were entered."""
    return [r for r in _RECORDS if r.t1 is not None]


def aggregate(recs: list) -> dict:
    """{name: {"calls", "host_ms", "host_self_ms", "device_ms",
    "device_self_ms"}} over the closed spans ``recs``; a span's self time
    is its time less that of the spans nested directly in it (on its
    thread, so in stream order on the device)."""
    inner: dict[int, list] = {}
    for r in recs:
        if r.parent is not None:
            acc = inner.setdefault(id(r.parent), [0.0, 0.0])
            acc[0] += r.host_ms()
            acc[1] += r.device_ms()
    spans: dict[str, dict] = {}
    for r in recs:
        s = spans.setdefault(r.name, {"calls": 0, "host_ms": 0.0, "host_self_ms": 0.0,
                                      "device_ms": 0.0, "device_self_ms": 0.0})
        h, d = inner.get(id(r), (0.0, 0.0))
        s["calls"] += 1
        s["host_ms"] += r.host_ms()
        s["host_self_ms"] += r.host_ms() - h
        s["device_ms"] += r.device_ms()
        s["device_self_ms"] += r.device_ms() - d
    return spans


def summary() -> dict:
    """{"spans": :func:`aggregate` of the recording, "counts": its tally}.
    Waits for the device first."""
    recs = records()
    if any(r.e0 is not None for r in recs):
        torch.cuda.synchronize()
    return {"spans": aggregate(recs), "counts": dict(_TALLY)}


def reset() -> None:
    """Drop the recorded spans and the tally (their events go back to the
    pool); the counter table is kept."""
    for r in _RECORDS:
        if r.t1 is not None:
            _EVENTS.extend(e for e in (r.e0, r.e1) if e is not None)
    _RECORDS.clear()
    with _lock:
        _TALLY.clear()
