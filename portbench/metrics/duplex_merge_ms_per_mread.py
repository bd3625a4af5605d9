"""Stream milliseconds a million reads of the fused step's
``duplex_merge`` stage: merging the two strands' consensus rows
into duplex rows.
From the program's step clock: its stage marks in the replayed
steps (lib/step_clock.py)."""

from portbench.lib import step_clock


def read(ctx):
    return step_clock.ms_per_mread(ctx, "duplex_merge")
