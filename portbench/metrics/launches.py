"""launches.<cell>: device kernels per unit (scene, step) in the
traced window, copies and sets left out: the host's launch work, a count
that repeats exactly."""

from portbench.harness.readers import is_kernel, units


def read(ctx):
    t = ctx["trace"]
    return sum(1 for name, _, _ in t.kernels if is_kernel(name)) / units(ctx)
