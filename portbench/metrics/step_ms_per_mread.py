"""Device busy milliseconds of the resident step a million reads: the
union of the profiler's device intervals over the traced passes."""


def read(ctx):
    tr = ctx.tracer
    if tr is None or not tr.intervals or not ctx.window_reads:
        return None
    return tr.busy_s * 1e3 / (ctx.window_reads / 1e6)
