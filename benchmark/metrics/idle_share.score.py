"""The share of the traced stretch in which no kernel and no copy ran on the
device (the union of the profiler's device intervals), in percent."""


def read(ctx):
    t = ctx.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (t.window_s - t.busy_s) / t.window_s
