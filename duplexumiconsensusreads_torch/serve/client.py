"""Client side of the service: submit / status / wait.

The JAX package's serve/client.py, copied with the imports rewritten:
the same job files and ids (a job carries no device; the daemon owns
its card). Nothing here imports the executor stack or touches CUDA.

Submission is one durable file write into the spool inbox — no RPC, no
daemon handshake: the spool directory IS the protocol, which is what
lets a killed daemon lose nothing (the submission either is or is not
durably in the inbox/journal; there is no in-flight third state).
``call --submit/--status/--wait`` (cli/main.py) are thin wrappers over
these functions.
"""

from __future__ import annotations

import hashlib
import json
import os
import random
import time

from duplexumiconsensusreads_torch.serve.job import validate_spec
from duplexumiconsensusreads_torch.serve.queue import SpoolQueue
from duplexumiconsensusreads_torch.serve import states

# states with nothing left to wait for: the journal's terminal family
# (from the declared state machine) plus the client-side "unknown"
# pseudo-state status() reports for a job no record answers for
TERMINAL_STATES = states.TERMINAL_STATES + ("unknown",)

# --wait backoff: the delay doubles from poll_s up to this cap, with
# multiplicative jitter so a herd of waiting clients (every `--wait`
# is a journal read off the shared spool) decorrelates instead of
# hammering the filesystem in lockstep
WAIT_BACKOFF_CAP_S = 2.0
_WAIT_JITTER = (0.5, 1.0)


def make_job_id(spec_fields: dict) -> str:
    """Content hash + random suffix: collision-free without any
    coordination between clients (two submissions of the same job spec
    are two jobs, as two `call` invocations would be two runs)."""
    base = hashlib.sha256(
        json.dumps(spec_fields, sort_keys=True).encode() + os.urandom(8)
    ).hexdigest()[:12]
    return f"job-{base}"


def submit(
    spool_dir: str,
    input_path: str,
    output_path: str,
    config: dict | None = None,
    priority: int = 1,
    chaos: str | None = None,
    trace: str | None = None,
    deadline_s: float | None = None,
    shards: int | None = None,
    shard_bytes: int | None = None,
) -> str:
    """Validate + durably spool one job; returns its id. Raises
    ValueError on a bad spec and FileNotFoundError on a missing input —
    submission-time failures belong to the submitter, not the daemon.
    ``deadline_s``: wall budget from admission; past it the job is
    journaled terminal "expired" instead of run (a running slice aborts
    at its next checkpoint boundary, keeping the committed prefix).
    ``shards``/``shard_bytes`` (mutually exclusive): scatter-gather
    sharding — split the job into K range sub-jobs fanned across the
    fleet and merged into one output byte-identical to the unsharded
    run (``--status``/``--wait`` on the returned id aggregate the
    sub-jobs; the job is done only when the merge publishes)."""
    if not os.path.exists(input_path):
        raise FileNotFoundError(f"job input does not exist: {input_path}")
    fields = {
        "input": os.path.abspath(input_path),
        "output": os.path.abspath(output_path),
        "priority": priority,
        "config": dict(config or {}),
    }
    if chaos:
        fields["chaos"] = chaos
    if trace:
        fields["trace"] = os.path.abspath(trace)
    if deadline_s is not None:
        fields["deadline_s"] = deadline_s
    if shards is not None:
        fields["shards"] = shards
    if shard_bytes is not None:
        fields["shard_bytes"] = shard_bytes
    spec = validate_spec({"job_id": make_job_id(fields), **fields})
    return SpoolQueue(spool_dir).submit(spec)


def status(spool_dir: str, job_id: str) -> dict:
    return SpoolQueue(spool_dir).status(job_id)


def status_document(st: dict) -> dict:
    """Normalize a :func:`status`/:func:`wait` answer into the stable
    machine-readable document ``call --status/--wait --json`` prints:
    state + reason + shards rollup + RELATIVE timestamps. The journal's
    ``*_m`` stamps are raw stamp-clock readings that mean nothing off
    their spool — external monitors get ages/countdowns instead
    (``admitted_age_s``, ``deadline_in_s``, ``progress_age_s``,
    ``lease_expires_in_s``), computed against the SAME clock: the
    ``now_m`` the status read attached (the spool store's now — on a
    sharedfs spool the client's own monotonic clock is the wrong
    domain), falling back to local monotonic for pre-store answers."""
    now_m = st.get("now_m")
    if isinstance(now_m, (int, float)) and not isinstance(now_m, bool):
        now = float(now_m)
    else:
        now = time.monotonic()
    doc: dict = {
        "job_id": st.get("job_id"),
        "state": st.get("state"),
        "reason": st.get("error"),
    }
    for key in ("priority", "slices", "chunks_done", "token",
                "crash_count", "shed", "compacted", "timed_out",
                "phase", "parent", "shard_idx", "n_shards", "shards",
                "snapshot_seq", "reads_emitted", "result"):
        if key in st:
            doc[key] = st[key]
    ts: dict = {}
    for src, dst, sign in (
        ("admitted_m", "admitted_age_s", -1),
        ("progress_m", "progress_age_s", -1),
        ("deadline_m", "deadline_in_s", +1),
    ):
        v = st.get(src)
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            ts[dst] = round(sign * (float(v) - now), 3)
    lease = st.get("lease")
    if isinstance(lease, dict):
        doc["lease_owner"] = lease.get("owner")
        exp = lease.get("expires_m")
        if isinstance(exp, (int, float)) and not isinstance(exp, bool):
            ts["lease_expires_in_s"] = round(float(exp) - now, 3)
    doc["timestamps"] = ts
    return doc


def wait(
    spool_dir: str, job_id: str, timeout_s: float = 0.0, poll_s: float = 0.5
) -> dict:
    """Poll until the job reaches a terminal state ("unknown" counts:
    waiting on a job nobody submitted must not hang). ``timeout_s`` 0 =
    wait forever; on expiry the last status is returned with
    ``timed_out: true`` rather than raising — the job is still running,
    which is an answer, not an error.

    Polling is jitter-backed-off: delays start at ``poll_s``, double up
    to ~:data:`WAIT_BACKOFF_CAP_S`, and each is scaled by a random
    factor — long jobs cost a handful of journal reads per second of
    waiting fleet-wide instead of a fixed-rate stampede, while a job
    finishing quickly is still noticed quickly."""
    q = SpoolQueue(spool_dir)
    t0 = time.monotonic()
    delay = min(poll_s, WAIT_BACKOFF_CAP_S)
    while True:
        st = q.status(job_id)
        if st.get("state") in TERMINAL_STATES:
            return st
        remaining = timeout_s - (time.monotonic() - t0) if timeout_s > 0 else None
        if remaining is not None and remaining <= 0:
            return {**st, "timed_out": True}
        step = delay * random.uniform(*_WAIT_JITTER)
        if remaining is not None:
            step = min(step, remaining)  # never oversleep the deadline
        time.sleep(step)
        delay = min(delay * 2, WAIT_BACKOFF_CAP_S)
