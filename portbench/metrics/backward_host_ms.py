"""backward_host_ms.<cell>: host milliseconds per step in the train step's
``train.backward`` span (the program's own), under the profiler: the
calling thread's wait in ``autograd.grad`` while the autograd engine
enqueues the backward, the PlainVJP twins' recompute included."""

from portbench.metrics._program import span_ms


def read(ctx):
    return span_ms(ctx, "host_ms", lambda n: n == "train.backward")
