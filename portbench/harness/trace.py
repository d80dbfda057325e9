"""The traced sub-window: spans from the benchmark's own files, the
profiler's device trace, and its reduction.

:class:`KernelSpans` puts a ``record_function`` span named
``portbench.<kernel>`` around every call of each kernel wrapper the
program lists in ``lfsr_tpu_torch.ops.KERNELS`` (K1 ... K10), at every
place the program's modules call it, and logs each call's operands and
outputs (shapes and dtypes), which the rooflines count. :func:`profiled`
runs a function under ``torch.profiler`` inside a span
``portbench.window``, which ends after a device synchronise, and
:func:`reduce` turns the trace into what the per-layer readers read:

- the window's length and the device's busy time (the union of every
  kernel, copy and set on the card, clipped to the window);
- every device kernel with its time and the kernel span it was launched
  from (the innermost ``portbench.K*`` span around the runtime call that
  launched it, matched by the profiler's correlation id), or None;
- the breakdown: device time by kernel name, and idle time by what the
  host was doing (the innermost host op running at the middle of each gap).
"""

from __future__ import annotations

import bisect
import sys
import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch

SPAN = "portbench."
WINDOW = "portbench.window"


@dataclass
class Operand:
    """A kernel operand or output as the counts read it."""
    shape: tuple
    dtype: str
    itemsize: int

    def numel(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    def element_size(self) -> int:
        return self.itemsize


def _describe(a):
    if isinstance(a, torch.Tensor):
        return Operand(tuple(a.shape), str(a.dtype), a.element_size())
    return a


class KernelSpans:
    """Within the block, each kernel wrapper of the program runs inside a
    span ``portbench.<K>`` and its calls are logged in ``calls[K]`` as
    (operands, outputs)."""

    def __init__(self):
        self.calls: dict[str, list] = defaultdict(list)
        self._patched: list = []

    def _wrap(self, kid: str, fn):
        calls = self.calls

        def spanned(*args, **kwargs):
            with torch.profiler.record_function(SPAN + kid):
                out = fn(*args, **kwargs)
            outs = out if isinstance(out, tuple) else (out,)
            calls[kid].append(([_describe(a) for a in args], [_describe(o) for o in outs]))
            return out

        spanned.launches = getattr(fn, "launches", 0)
        spanned.__wrapped__ = fn
        return spanned

    def __enter__(self):
        from lfsr_tpu_torch.ops import KERNELS

        wrappers = {id(fn): self._wrap(name.split()[0], fn) for name, (fn, _, _) in KERNELS.items()}
        for mname, mod in list(sys.modules.items()):
            if not (mname == "lfsr_tpu_torch" or mname.startswith("lfsr_tpu_torch.")):
                continue
            for attr, val in list(vars(mod).items()):
                if id(val) in wrappers and not attr.startswith("__"):
                    setattr(mod, attr, wrappers[id(val)])
                    self._patched.append((mod, attr, val))
        return self

    def __exit__(self, *exc):
        for mod, attr, val in reversed(self._patched):
            setattr(mod, attr, val)
        self._patched.clear()


def synchronize():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def activities():
    from torch.profiler import ProfilerActivity

    return [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])


def profiled(fn):
    """Run ``fn()`` under torch.profiler (host and device activity) inside
    the span ``portbench.window``; returns (fn's result, kineto events)."""
    from torch.profiler import profile

    synchronize()
    with profile(activities=activities()) as prof:
        with torch.profiler.record_function(WINDOW):
            out = fn()
            synchronize()
    return out, prof.profiler.kineto_results.events()


@dataclass
class Trace:
    window_s: float
    busy_s: float
    kernels: list          # (name, seconds, kernel span or None)
    device_ops: list       # [[name, seconds]] by device time, top 10
    idle_gaps: list        # [[host op, seconds]] by idle time, top 10
    calls: dict = field(default_factory=dict)   # KernelSpans.calls
    reduce_s: float = 0.0
    linked: tuple = (0, 0, 0)  # device events, matched to their launch, inside a kernel span


def _is_device(ev) -> bool:
    return ev.device_type() == torch.autograd.DeviceType.CUDA


def _is_annotation(ev) -> bool:
    flag = getattr(ev, "is_user_annotation", None)
    if flag is not None and flag():
        return True
    kind = getattr(ev, "activity_type", None)
    return kind is not None and "annotation" in str(kind()).lower()


def reduce(events, calls: dict | None = None) -> Trace:
    t_start = time.perf_counter()
    cpu, dev = [], []
    window = None
    for ev in events:
        if _is_device(ev):
            if not _is_annotation(ev):
                dev.append(ev)
        else:
            cpu.append(ev)
            if ev.name() == WINDOW:
                window = (ev.start_ns(), ev.end_ns(), ev.start_thread_id())
    if window is None:
        raise RuntimeError("the trace holds no portbench.window span")
    w0, w1, main_thread = window
    # runtime calls that launched device work, by correlation id; host ops
    # (not runtime calls) for the idle labels; kernel spans by thread
    runtime = {}
    spans = defaultdict(list)
    for ev in cpu:
        name = ev.name()
        if name.startswith("cu"):
            runtime[ev.correlation_id()] = ev
        elif name.startswith(SPAN) and name != WINDOW:
            spans[ev.start_thread_id()].append((ev.start_ns(), ev.end_ns(), name[len(SPAN):]))
    for lst in spans.values():
        lst.sort()
    starts = {t: [s for s, _, _ in lst] for t, lst in spans.items()}

    def span_of(call) -> str | None:
        """The innermost kernel span around the host call ``call``."""
        t = call.start_thread_id()
        lst = spans.get(t)
        if not lst:
            return None
        s0, e0 = call.start_ns(), call.end_ns()
        i = bisect.bisect_right(starts[t], s0) - 1
        best = None
        for j in range(i, max(-1, i - 8), -1):
            s, e, kid = lst[j]
            if s <= s0 and e0 <= e and (best is None or s > best[0]):
                best = (s, kid)
        return None if best is None else best[1]

    intervals, kernels = [], []
    by_name = defaultdict(float)
    for ev in dev:
        s, e = max(ev.start_ns(), w0), min(ev.end_ns(), w1)
        if e <= s:
            continue
        intervals.append((s, e))
        sec = (ev.end_ns() - ev.start_ns()) * 1e-9
        name = ev.name()
        by_name[name[:160]] += sec
        call = runtime.get(ev.correlation_id())
        kernels.append((name, sec, None if call is None else span_of(call)))
    intervals.sort()
    busy, gaps, end = 0, [], w0
    for s, e in intervals:
        if s > end:
            gaps.append((end, s))
        if e > end:
            busy += e - max(s, end)
            end = e
    if end < w1:
        gaps.append((end, w1))
    idle = defaultdict(float)
    for (g0, g1), label in zip(gaps, _host_labels(cpu, main_thread, [(a + b) // 2 for a, b in gaps])):
        idle[label] += (g1 - g0) * 1e-9
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    linked = (len(kernels), sum(runtime.get(ev.correlation_id()) is not None for ev in dev),
              sum(span is not None for _, _, span in kernels))
    return Trace((w1 - w0) * 1e-9, busy * 1e-9, kernels, top(by_name), top(idle),
                 dict(calls or {}), time.perf_counter() - t_start, linked)


def _host_labels(cpu, thread, points):
    """For each time in ``points`` (ascending), the innermost host op or
    runtime call (not the window span) running on ``thread`` then."""
    ops = sorted(((ev.start_ns(), -ev.end_ns(), ev.name()) for ev in cpu
                  if ev.start_thread_id() == thread and ev.name() != WINDOW),
                 key=lambda t: (t[0], t[1]))
    out, stack, i = [], [], 0
    for p in points:
        while i < len(ops) and ops[i][0] <= p:
            s, neg_e, name = ops[i]
            while stack and stack[-1][0] <= s:
                stack.pop()
            stack.append((-neg_e, name))
            i += 1
        while stack and stack[-1][0] < p:
            stack.pop()
        out.append(stack[-1][1] if stack else "python (no op)")
    return out
