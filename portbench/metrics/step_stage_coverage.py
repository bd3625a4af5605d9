"""Share of the replayed steps' call spans between their first and last
stage marks, from the program's step clock (lib/step_clock.py): the
rest is input binding and launch."""

from portbench.lib import step_clock


def read(ctx):
    return step_clock.coverage(ctx)
