"""Stream milliseconds a million reads of the fused step's
``consensus_math`` stage: the consensus math on the family sums
(argmax, error, quality), in every ssc pass.
From the program's step clock: its stage marks in the replayed
steps (lib/step_clock.py)."""

from portbench.lib import step_clock


def read(ctx):
    return step_clock.ms_per_mread(ctx, "consensus_math")
