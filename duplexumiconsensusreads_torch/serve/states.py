"""The job state machine — the serving fleet's single source of truth.

The JAX package's serve/states.py, copied unchanged but for this
paragraph: the state machine is engine-free.

Every journal ``state`` literal, every legal transition, and every
derived state family lives HERE and only here. ``serve/queue.py``,
``serve/service.py`` and ``serve/client.py`` import these names; no
other module may define its own state tuple. The payoff is that the
protocol is machine-checkable: dutlint's ``state-machine`` rule parses
this module's literals, rebuilds the transition graph the code actually
implements (every ``entry["state"] = ...`` write in ``serve/``, with
its from-state evidence), and fails the build on any undeclared
transition, write to a terminal state, state unreachable from
admission, or declared edge no code implements. Adding a state —
or a transition — is an edit to this file; the linter enforces the
rest (registration, reachability, coverage) at review time, where the
chaos suite could only probe it dynamically.

Keep ``JOB_STATES``, ``INITIAL_STATES`` and ``TRANSITIONS`` literal
(string tuples / a dict of string tuples): the model-checker reads
them with ``ast``, not ``import``, so the same rule also checks the
miniature fixture corpora in ``tests/test_lint.py``.
"""

from __future__ import annotations

# every state a journal entry may ever carry
JOB_STATES = ("queued", "running", "done", "failed", "rejected",
              "expired", "quarantined", "splitting", "fanned", "merging")

# states a journal entry may be CREATED in (admission writes these;
# everything else must be reached via a declared transition)
INITIAL_STATES = ("queued", "rejected")

# the legal transition graph. One edge per durable journal move:
#   queued -> running|splitting|merging   claim (the phase field picks
#                                         the literal; all three are
#                                         leased states)
#   queued -> expired                     deadline sweep before a claim
#   queued -> failed                      sibling-cancel / orphan reap
#                                         of a shard whose parent died
#   running -> done|failed                slice outcome (fenced)
#   running -> queued                     preemption / takeover /
#                                         watchdog abort-requeue
#   running -> expired                    deadline abort at a chunk
#                                         boundary (fenced)
#   running -> quarantined                crash_count hit max_crashes
#   splitting -> fanned                   the split transaction
#   splitting -> failed|queued|quarantined  same abort family as running
#   fanned -> queued                      all children done: requeue as
#                                         the merge task (phase=merge)
#   fanned -> failed                      a child terminally failed
#   merging -> done|failed|queued|quarantined  merge outcome / aborts
# Terminal states (no successors) may never be written over: their
# results/ file is the durable record and compaction may drop them.
TRANSITIONS = {
    "queued": ("running", "splitting", "merging", "expired", "failed"),
    "running": ("done", "failed", "queued", "expired", "quarantined"),
    "splitting": ("fanned", "failed", "queued", "quarantined"),
    "fanned": ("queued", "failed"),
    "merging": ("done", "failed", "queued", "quarantined"),
    "done": (),
    "failed": (),
    "rejected": (),
    "expired": (),
    "quarantined": (),
}

# ---------------------------------------------------------- derived views
#
# The families the protocol code actually branches on, derived from the
# graph (tests/test_serve.py pins them against the pre-refactor
# literals, so a TRANSITIONS edit that silently changes a family fails
# loudly). Derivations follow JOB_STATES order, keeping the tuples
# byte-identical to the literals they replaced.

# states with nothing left to schedule: no outgoing edges — compaction
# may drop them (their durable results/ file remains the record) and
# the idle check ignores them
TERMINAL_STATES = tuple(s for s in JOB_STATES if not TRANSITIONS[s])

# states held under a lease + fencing token. A claimed state is exactly
# one an UNCLEAN abort can hit: takeover/watchdog either requeue it or
# — at max_crashes — quarantine it, so "can transition to quarantined"
# IS the lease-holding property (fanned parents park without a lease
# and can do neither).
CLAIMED_STATES = tuple(
    s for s in JOB_STATES if "quarantined" in TRANSITIONS[s]
)

# states with scheduling work left: the fleet idle check and the
# admission open-jobs bound count these (a fanned parent IS open work —
# its merge hasn't happened)
OPEN_STATES = ("queued", "fanned") + CLAIMED_STATES
