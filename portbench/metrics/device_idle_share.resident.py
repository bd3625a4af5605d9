"""Share of the traced window in which no kernel or copy ran on the
card: 1 - (union of the device intervals) / window, from the profiler."""


def read(ctx):
    tr = ctx.tracer
    if tr is None or not tr.intervals or tr.window_s <= 0:
        return None
    return 1.0 - tr.busy_s / tr.window_s
