"""Seconds from the process's start to the window's start: imports,
the build on a first run, input generation, staging, warm calls and
graph captures."""


def read(ctx):
    return ctx.setup_s
