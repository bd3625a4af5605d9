"""Reads completed a second: every read of every call (or pass) in the
window, over all the window's time."""


def read(ctx):
    if ctx.window_s <= 0 or not ctx.window_reads:
        return None
    return ctx.window_reads / ctx.window_s
