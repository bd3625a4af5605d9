"""Stream milliseconds a million reads of the fused step's
``cycle_cap`` stage: fitting and applying the per-cycle error
cap between the two ssc passes.
From the program's step clock: its stage marks in the replayed
steps (lib/step_clock.py)."""

from portbench.lib import step_clock


def read(ctx):
    return step_clock.ms_per_mread(ctx, "cycle_cap")
