"""forward_host_ms.<cell>: host milliseconds per step in the train step's
``train.forward`` span (the program's own), under the profiler."""

from portbench.metrics._program import span_ms


def read(ctx):
    return span_ms(ctx, "host_ms", lambda n: n == "train.forward")
