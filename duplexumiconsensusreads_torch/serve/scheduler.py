"""Fair scheduling over the journaled queue.

The JAX package's serve/scheduler.py, copied unchanged but for this
paragraph: scheduling is pure over the journal.

The policy is deliberately small enough to state in full:

  * strict priority CLASSES: a queued job of a lower priority value
    always runs before any higher value (0 is the most urgent);
  * FIFO WITHIN a class, keyed on the admission sequence number the
    journal assigned;
  * per-job CHUNK BUDGET: a running job yields the device after
    ``chunk_budget`` fresh chunks — but only when another job is
    actually waiting (yielding to an empty queue is pure overhead) —
    and re-enters its class at the BACK, so a jumbo job interleaves
    with small ones instead of starving them. Preemption happens at a
    chunk boundary, where the streaming executor's checkpoint/resume
    contract makes the yield free (the next slice recomputes nothing);
  * ADMISSION SHEDDING per class: each priority class can carry a
    queue-depth bound, and a submission that would exceed its class's
    bound is rejected at admission with an explicit journaled reason —
    overload degrades by policy (urgent classes keep their budgeted
    room), never by an unbounded queue quietly absorbing everything.

Pure functions over the journal's ``jobs`` dict: no state of its own,
so every daemon of a fleet — or a restarted daemon — schedules exactly
as any other would from the same journal.
"""

from __future__ import annotations


def parse_class_depths(spec: str) -> dict[int, int]:
    """``"0=8,1=4"`` → {0: 8, 1: 4}: per-priority-class queued-depth
    bounds for ``dut-serve --class-depth``. Raises ValueError naming
    the offending entry."""
    out: dict[int, int] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        cls, eq, depth = part.partition("=")
        try:
            if not eq:
                raise ValueError
            c, d = int(cls), int(depth)
            if c < 0 or d < 1:
                raise ValueError
        except ValueError:
            raise ValueError(
                f"bad class-depth entry {part!r} (want CLASS=DEPTH with "
                f"CLASS >= 0 and DEPTH >= 1, e.g. '0=8,1=4')"
            ) from None
        out[c] = d
    return out


class FairScheduler:
    def __init__(
        self, chunk_budget: int = 0,
        class_depths: dict[int, int] | None = None,
    ):
        """``chunk_budget`` = fresh chunks a slice may commit before
        yielding (0 = run to completion; no preemption).
        ``class_depths`` maps priority class -> max QUEUED jobs of that
        class (absent classes are unbounded up to the queue's global
        open-jobs cap)."""
        if chunk_budget < 0:
            raise ValueError(f"chunk_budget must be >= 0 (got {chunk_budget})")
        self.chunk_budget = chunk_budget
        self.class_depths = dict(class_depths or {})

    def shed_reason(self, jobs: dict, priority: int) -> str | None:
        """Admission-control verdict for one incoming submission: a
        reason string when its priority class is at its queued-depth
        bound (the queue journals it as an explicit shed), else None.
        Pure over the journal, so every daemon sheds identically."""
        bound = self.class_depths.get(int(priority))
        if bound is None:
            return None
        depth = sum(
            1 for e in jobs.values()
            if e.get("state") == "queued"
            and int(e.get("priority", 1)) == int(priority)
        )
        if depth >= bound:
            return (
                f"shed: priority class {priority} queue depth "
                f"{depth}/{bound} (admission control)"
            )
        return None

    @staticmethod
    def pick(jobs: dict, now: float | None = None) -> str | None:
        """The next job to run: min (priority, seq) over queued jobs.

        ``now`` (a ``time.monotonic()`` reading — deadlines live only
        in the monotonic domain) makes the pick deadline-aware: a
        queued job whose admission-stamped ``deadline_m`` has passed is
        never claimed. The service's deadline sweep journals such jobs
        terminal ``expired`` in the same pass; refusing here too closes
        the fleet race where another daemon picks between this
        daemon's sweep and its claim."""
        best = None
        best_key = None
        for job_id, entry in jobs.items():
            if entry.get("state") != "queued":
                continue
            if now is not None:
                deadline_m = entry.get("deadline_m")
                if deadline_m is not None and float(deadline_m) <= now:
                    continue  # expired: the sweep owns its terminal move
            key = (int(entry.get("priority", 1)), int(entry.get("seq", 0)))
            if best_key is None or key < best_key:
                best, best_key = job_id, key
        return best

    @staticmethod
    def others_waiting(jobs: dict, job_id: str) -> bool:
        """Would any queued job actually run if ``job_id`` yielded now?
        Only a waiter of EQUAL-OR-MORE-URGENT class counts: yielding to
        a strictly less urgent job would just re-pick the yielder
        (strict priority), burning a preempt/resume cycle for nothing —
        and with an empty queue the running job keeps the device."""
        mine = int(jobs.get(job_id, {}).get("priority", 1))
        return any(
            jid != job_id
            and entry.get("state") == "queued"
            and int(entry.get("priority", 1)) <= mine
            for jid, entry in jobs.items()
        )
