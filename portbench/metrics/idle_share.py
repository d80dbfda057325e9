"""idle_share.<cell>: the share of the traced window in which no kernel,
copy or set ran on the card (device trace)."""


def read(ctx):
    t = ctx["trace"]
    return 1.0 - t.busy_s / t.window_s
