"""Durable spool + admission queue for the consensus service.

The JAX package's serve/queue.py, copied with the imports rewritten
(the quarantine diagnosis finds the spool's service captures through
telemetry/fleet.py's ``discover_service_captures``, as there). The
journal format is the JAX package's, key for key.

Spool layout (one directory, shared by clients and N daemons):

  inbox/<job_id>.json   client submissions — written durably by the
                        client, removed by the daemon only AFTER the
                        job is durably journaled (so a kill anywhere in
                        admission re-admits instead of losing the job;
                        job_id is the dedupe key, so re-admission can
                        never double-enter)
  queue.json            the admission-queue journal: every accepted job
                        with its state machine (queued → running →
                        done | failed), persisted via the tmp+fsync+
                        rename protocol on EVERY transition — whatever
                        the journal says survived the crash is exactly
                        what a restarted (or surviving) daemon resumes
  journal.lock          flock target serializing journal transactions
                        (holds no data; see "Fleet transactions" below)
  results/<job_id>.json final per-job report (durable), read by
                        ``call --status/--wait``
  metrics.json          the live service heartbeat snapshot

Fleet transactions: with several ``dut-serve`` daemons on one spool the
journal is multi-writer, so every mutation is a flock'd READ-MODIFY-
WRITE — take ``journal.lock``, reload queue.json, apply the transition,
persist durably, release. In-memory ``jobs`` is only ever a cache of
the last transaction's view. flock arbitrates both across processes and
between one daemon's threads (each transaction opens its own fd), and a
SIGKILLed holder releases it automatically — the lock can never outlive
a crash the way journal state does.

Leases: a job enters ``running`` only by CLAIMING it — the claiming
transaction writes a lease entry (daemon id + owner identity, a
monotonically increasing per-job FENCING TOKEN, and a stamp-domain
expiry) into the journal. Leases are renewed from the daemon's
heartbeat and from every chunk commit; an expired lease — or one whose
owner is provably dead — lets another daemon reclaim the job (queued
again, original seq), resuming from the last durable checkpoint mark.
The token is checked at every durable commit (chunk checkpoint mark
via the executor's ``commit_guard``, result publish, every journal
update by the slice), so a zombie daemon that wakes up after its job
was reclaimed raises :class:`JobFenced` before splicing a single byte.

WHICH clock stamps ``*_m`` fields and WHAT proves an owner dead are
the spool's lease-store backend (serve/store.py, pinned per spool in
``store.json``): ``local`` stamps machine-wide CLOCK_MONOTONIC and
probes pids — NTP-proof, scoped to one host, today's exact semantics;
``sharedfs`` stamps a filesystem-calibrated shared clock and reads
durable heartbeat documents, so N hosts sharing the spool agree on
expiry without ever probing a pid. Every ``SpoolQueue`` timestamp and
liveness decision goes through ``self.store``; the fencing token —
not the liveness oracle — remains the exactly-once authority in both.

The journal lock is acquired with a bounded, jittered poll
(:class:`JournalLockTimeout` past ``lock_timeout_s``): a wedged
shared-filesystem flock must surface as a typed error plus a
``lock_stall`` ledger event, not an invisible forever-block. The
heartbeat document keeps beating while a transaction waits — beats
never take the journal lock.

Fault sites: ``serve.accept`` guards the read+parse+validate of each
submission and ``serve.journal`` every durable journal persist (both
here); the serving layer wraps the lease operations at their own sites
— ``serve.lease`` around :meth:`SpoolQueue.claim`, ``serve.renew``
around renewal, ``serve.expire`` around :meth:`SpoolQueue.reclaim_dead`,
``serve.fence`` around :meth:`SpoolQueue.verify_lease`,
``serve.deadline`` around the deadline sweep/expiry commits and
``serve.watchdog`` around :meth:`SpoolQueue.reclaim_stalled` — so chaos
schedules can target each step of the lease state machine. All ride
the streaming executor's bounded host-I/O retry ladder, so transient
faults are absorbed and an injected kill leaves exactly the on-disk
state a real SIGKILL would.
"""

from __future__ import annotations

import contextlib
import fcntl
import json
import os
import random
import time

from duplexumiconsensusreads_torch.io.durable import (
    free_bytes,
    unique_tmp,
    write_durable,
)
from duplexumiconsensusreads_torch.serve.job import JobSpec, validate_spec
from duplexumiconsensusreads_torch.serve.store import (
    LeaseStore,
    ceil_ms,
    resolve_store,
)

# the job state machine — states, legal transitions, and the derived
# families — lives in serve/states.py (the single declared source of
# truth dutlint's state-machine rule checks the code against); the
# names are re-exported here so queue-side callers keep one import
from duplexumiconsensusreads_torch.serve.states import (  # noqa: F401
    CLAIMED_STATES,
    JOB_STATES,
    OPEN_STATES,
    TERMINAL_STATES,
    TRANSITIONS,
)

JOURNAL_VERSION = 1


# helpers that may touch the in-memory jobs cache OUTSIDE a lexical
# `with self._txn():` body because their caller owns the transaction
# (or, for _load, because the client-side read path is documented
# single-threaded — see status()). dutlint's txn-discipline rule reads
# this registry; everything not named here (and not *_locked/__init__)
# must mutate the cache inside a transaction.
TXN_CACHE_HELPERS = ("_load", "_compact")

# poison quarantine: a job whose run aborts THIS many times without a
# clean preemption (daemon death takeovers, watchdog stall reclaims) is
# journaled terminal `quarantined` with a diagnosis bundle instead of
# re-entering the queue — without this bound a deterministic poison job
# ping-pongs between fleet daemons forever, killing each in turn
MAX_CRASHES_DEFAULT = 3

# per-job lease claims kept for the quarantine diagnosis bundle
_LEASE_HISTORY_KEPT = 8

# disk-pressure low-water mark: admission sheds new jobs when the spool
# filesystem has less than this free (after a grace GC pass over
# terminal jobs' shard/checkpoint litter). The durable design spends
# disk on every transition — journal rewrites, shard writes, finalise
# staging — so refusing new work while it can still be refused cleanly
# beats dying on ENOSPC mid-commit.
DISK_LOW_WATER_BYTES = 64 << 20

# default lease length. Healthy daemons renew every chunk commit AND
# every heartbeat, so expiry only ever fires on a daemon that stopped
# making progress for this long — a real zombie, not a slow chunk.
LEASE_DEFAULT_S = 30.0

# journal-lock acquisition bounds: a transaction that cannot take
# journal.lock within the timeout raises JournalLockTimeout (an
# OSError — the serving layer's I/O ladders absorb it like any other
# transient and the heartbeat keeps running); past the stall threshold
# ONE lock_stall event is ledgered so a wedged shared-filesystem lock
# is visible long before the timeout fires
LOCK_TIMEOUT_DEFAULT_S = 30.0
LOCK_STALL_EVENT_S = 1.0


class JournalLockTimeout(OSError):
    """journal.lock could not be acquired within ``lock_timeout_s``.
    OSError on purpose: every caller's retry/absorb ladder already
    handles transient I/O failure, and a wedged lock (a dead NFS
    client holding flock, a hung filesystem) must degrade the same
    way — loudly typed, never an invisible forever-block."""


class JobFenced(BaseException):
    """A daemon's fencing token no longer matches the journal: its job
    was reclaimed (lease expired / owner presumed dead) and every
    durable commit it still owes is void. BaseException on purpose —
    like InjectedKill, no retry or isolation ladder may absorb it: the
    slice must abort immediately, committing nothing, and the service
    drops the result on the floor (the reclaiming daemon owns the job
    now and will produce the identical bytes)."""


def _remove_counting(path: str) -> int:
    """Remove one file, returning the bytes it held (0 when absent or
    unremovable — GC is best-effort)."""
    try:
        size = os.path.getsize(path)
        os.remove(path)
    except OSError:
        return 0
    return size


def _trace_tail(path: str, max_bytes: int = 8192, max_lines: int = 20):
    """Last ``max_lines`` lines of a (JSONL) capture file, for the
    quarantine diagnosis bundle. Read-only and size-bounded: the bundle
    must stay a small durable JSON, not re-spool the whole capture."""
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            f.seek(max(size - max_bytes, 0))
            data = f.read(max_bytes)
    except OSError:
        return None
    lines = data.decode("utf-8", "replace").splitlines()
    return [ln[:500] for ln in lines[-max_lines:]] or None


def _capture_stitched_end(path: str) -> float | None:
    """A service capture's END on the stitched fleet timeline:
    ``meta.epoch_m`` (the recorder's stamp-domain start — the fleet
    recorder's alignment key) plus the last record's relative ``t``.
    None when the capture predates the fleet recorder (no numeric
    epoch_m in the meta line) — those fall back to mtime ordering.
    Read-only and bounded like :func:`_trace_tail`."""
    try:
        with open(path, "rb") as f:
            head = f.readline(4096)
        meta = json.loads(head.decode("utf-8", "replace"))
    except (OSError, ValueError):
        return None
    if not isinstance(meta, dict) or meta.get("type") != "meta":
        return None
    epoch = meta.get("epoch_m")
    if not isinstance(epoch, (int, float)) or isinstance(epoch, bool):
        return None
    last_t = 0.0
    for line in _trace_tail(path, max_bytes=65536, max_lines=512) or ():
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        t = rec.get("t") if isinstance(rec, dict) else None
        if isinstance(t, (int, float)) and not isinstance(t, bool):
            last_t = max(last_t, float(t))
    return float(epoch) + last_t


def _last_fault_site(tail_lines) -> str | None:
    """The last injected-fault site named in a capture tail — the
    poison job's smoking gun when it carries a chaos schedule."""
    site = None
    for line in tail_lines:
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        if (
            isinstance(rec, dict)
            and rec.get("name") == "fault_injected"
            and isinstance(rec.get("site"), str)
        ):
            site = rec["site"]
    return site


class SpoolQueue:
    """The admission queue over one spool directory.

    All mutating methods are flock'd journal transactions (reload →
    mutate → durable persist), safe against concurrent daemons; the
    in-memory ``jobs`` dict is only ever a cache of queue.json.
    In-process thread safety rides the same flock (each transaction
    opens a private fd); serve.service additionally serializes its own
    scheduling decisions under its lock.
    """

    def __init__(self, root: str, max_queue: int = 64,
                 max_terminal_kept: int = 256,
                 max_crashes: int = MAX_CRASHES_DEFAULT,
                 default_deadline_s: float = 0.0,
                 min_free_bytes: int = DISK_LOW_WATER_BYTES,
                 store: LeaseStore | str | None = None,
                 lock_timeout_s: float = LOCK_TIMEOUT_DEFAULT_S):
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1 (got {max_queue})")
        if max_terminal_kept < 0:
            raise ValueError(
                f"max_terminal_kept must be >= 0 (got {max_terminal_kept})"
            )
        if max_crashes < 1:
            raise ValueError(f"max_crashes must be >= 1 (got {max_crashes})")
        if default_deadline_s < 0:
            raise ValueError(
                f"default_deadline_s must be >= 0 (got {default_deadline_s})"
            )
        self.root = root
        self.max_queue = max_queue
        # quarantine bound: aborts-without-clean-preemption before a job
        # is declared poison (see reclaim_dead/reclaim_stalled)
        self.max_crashes = max_crashes
        # daemon-level deadline default (seconds; 0 = none): admission
        # stamps spec.deadline_s or this onto the journal entry as a
        # monotonic expiry
        self.default_deadline_s = default_deadline_s
        # disk-pressure admission bound (bytes; 0 disables the probe)
        self.min_free_bytes = min_free_bytes
        # the journal is rewritten+fsynced on every transition, so it
        # must stay bounded on a long-lived daemon: terminal entries
        # (done/failed/rejected) beyond this many are compacted away on
        # save — their durable per-job report in results/ remains the
        # record (status() falls back to it). Compaction NEVER touches
        # open (queued/running) entries, so lease/token state survives
        # every rewrite.
        self.max_terminal_kept = max_terminal_kept
        # admission policy hook (serve.service wires the scheduler's
        # shed policy here): callable(jobs, spec) -> rejection reason
        # string, or None to admit. Purely advisory load shedding —
        # invalid specs and the global bound are still enforced here.
        self.admission_policy = None
        # the spool's clock/liveness backend: an instance is adopted
        # as-is (the service injects a pinned store), a string or None
        # resolves against the spool's store.json marker WITHOUT
        # pinning it — the client poll path must never decide a
        # spool's backend, only inherit it
        if isinstance(store, LeaseStore):
            self.store = store
        else:
            self.store = resolve_store(root, store)
        # bounded journal-lock acquisition (<=0 disables the bound)
        self.lock_timeout_s = lock_timeout_s
        self.inbox_dir = os.path.join(root, "inbox")
        self.results_dir = os.path.join(root, "results")
        os.makedirs(self.inbox_dir, exist_ok=True)
        os.makedirs(self.results_dir, exist_ok=True)
        self.journal_path = os.path.join(root, "queue.json")
        self._lock_path = os.path.join(root, "journal.lock")
        self.jobs: dict[str, dict] = {}
        self.seq = 0
        self._load()

    # ------------------------------------------------------- client side

    def submit(self, spec: JobSpec) -> str:
        """Durably spool one validated job into the inbox (client side;
        the daemon never calls this). Returns the job id."""
        path = os.path.join(self.inbox_dir, spec.job_id + ".json")
        payload = json.dumps(spec.to_dict(), sort_keys=True).encode()
        write_durable(path, payload, tmp=unique_tmp(path))
        return spec.job_id

    def status(self, job_id: str) -> dict:
        """One job's observable state, from the journal + inbox +
        results — readable while daemons run (every file involved is
        only ever atomically replaced), no lock taken. Client-side
        only: the bare reloads here assume a single-threaded instance
        (daemon threads sharing a queue must use :meth:`refresh`, which
        serializes against in-flight transactions).

        Admission-race discipline: the daemon journals BEFORE unlinking
        the inbox file, but a reader that loads the journal first and
        checks the inbox second can see neither (journal read pre-save,
        inbox checked post-unlink). After an inbox miss the journal is
        therefore RE-read — a live job must never be reported "unknown"
        (which ``client.wait`` treats as terminal)."""
        self._load()
        entry = self.jobs.get(job_id)
        if entry is None:
            if os.path.exists(os.path.join(self.inbox_dir, job_id + ".json")):
                return {"job_id": job_id, "state": "submitted"}
            self._load()  # close the accept-vs-status window
            entry = self.jobs.get(job_id)
        if entry is None:
            return self._status_from_result(job_id)
        out = {"job_id": job_id, **{k: v for k, v in entry.items()
                                    if k != "spec"}}
        # the reader's "now" in the SPOOL's stamp domain: ages and
        # expires-in arithmetic against the entry's *_m stamps is only
        # well-defined on the clock that produced them, which on a
        # sharedfs spool is not the client's own monotonic clock
        out["now_m"] = round(self.store.now(), 3)
        if entry.get("children"):
            out["shards"] = self._shard_rollup(entry)
        result_path = os.path.join(self.results_dir, job_id + ".json")
        if entry.get("state") in (
            "done", "failed", "expired", "quarantined"
        ) and os.path.exists(result_path):
            try:
                with open(result_path) as f:
                    out["result"] = json.load(f)
            except (OSError, ValueError):
                pass  # result file torn/racing: state alone still answers
        return out

    def _status_from_result(self, job_id: str) -> dict:
        """Jobs whose terminal journal entry was compacted away still
        answer from their durable result file — rejections included,
        so a shed reason survives overload-time journal churn (which is
        exactly when sheds are frequent and compaction fastest)."""
        result_path = os.path.join(self.results_dir, job_id + ".json")
        try:
            with open(result_path) as f:
                result = json.load(f)
        except (OSError, ValueError):
            return {"job_id": job_id, "state": "unknown"}
        state = (
            "rejected" if result.get("rejected")
            else "quarantined" if result.get("quarantined")
            else "expired" if result.get("expired")
            else "failed" if "error" in result
            else "done"
        )
        out = {"job_id": job_id, "state": state, "result": result,
               "compacted": True}
        if result.get("shed"):
            out["shed"] = True
        if "error" in result:
            out["error"] = result["error"]
        return out

    def _write_rejection_result(
        self, job_id: str, reason: str, shed: bool
    ) -> None:
        """Durable record of WHY a submission never ran: like
        done/failed results, it outlives the journal entry's
        compaction."""
        path = os.path.join(self.results_dir, job_id + ".json")
        payload: dict = {"error": reason[:2000], "rejected": True}
        if shed:
            payload["shed"] = True
        write_durable(
            path,
            json.dumps(payload, sort_keys=True).encode(),
            tmp=unique_tmp(path),
        )

    # ------------------------------------------------------- daemon side

    @contextlib.contextmanager
    def _txn(self):
        """One flock'd journal transaction: exclusive lock (bounded —
        see :meth:`_flock_bounded`), fresh load, caller mutates and
        persists, lock released (incl. on error/kill — the kernel
        drops flock with the fd)."""
        fd = os.open(self._lock_path, os.O_CREAT | os.O_RDWR, 0o644)
        try:
            self._flock_bounded(fd)
            self._load()
            yield
        finally:
            os.close(fd)

    def _flock_bounded(self, fd: int) -> None:
        """Take the exclusive journal flock with a bounded, jittered
        poll instead of a blocking wait. A healthy lock is free or
        held for one tmp+fsync+rename, so the fast path is a single
        non-blocking attempt; contention polls with small jittered
        backoff (jitter decorrelates N daemons hammering one shared-
        filesystem lock). Past ``LOCK_STALL_EVENT_S`` one ``lock_stall``
        event is ledgered; past ``lock_timeout_s`` the transaction
        fails typed (:class:`JournalLockTimeout`) rather than wedging
        the daemon invisibly forever."""
        try:
            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
            return
        except OSError:
            pass
        start = time.monotonic()
        stalled = False
        while True:
            try:
                fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
                return
            except OSError:
                waited = time.monotonic() - start
                if 0 < self.lock_timeout_s <= waited:
                    raise JournalLockTimeout(
                        f"journal.lock on {self.root!r} not acquired "
                        f"after {ceil_ms(waited):.3f}s (lock_timeout_s="
                        f"{self.lock_timeout_s}): wedged holder?"
                    )
                if not stalled and waited >= LOCK_STALL_EVENT_S:
                    stalled = True
                    # lazy import: the client poll path must not drag
                    # the telemetry stack in on every status read
                    from duplexumiconsensusreads_torch.telemetry.trace import (
                        emit_event,
                    )

                    emit_event(
                        "lock_stall",
                        waited_s=ceil_ms(waited),
                        spool=self.root,
                    )
                # small cap: transactions are sub-ms when healthy, and
                # the serving tests take this path with real sleeps
                time.sleep(random.uniform(0.001, 0.005))

    def refresh(self) -> None:
        """Re-read the journal so the service's idle check sees other
        daemons' transitions — UNDER the transaction lock: a bare
        reload would rebind the ``jobs`` cache while a concurrent
        transaction on this same instance (a commit-guard renewal, the
        heartbeat's renew_all) sits between its load and its save, and
        that transaction would then durably write the rebound,
        mutation-less dict — silently dropping a lease renewal or, at
        worst, a claim."""
        with self._txn():
            pass

    def _load(self) -> None:
        """Refresh the in-memory view from queue.json. A torn or
        garbage journal is discarded (never fatal): the inbox files
        still exist for every job whose admission didn't complete, and
        jobs already dispatched wrote their own durable outputs."""
        try:
            with open(self.journal_path) as f:
                on_disk = json.load(f)
            if not isinstance(on_disk, dict) or not isinstance(
                on_disk.get("jobs"), dict
            ):
                raise ValueError("journal is not a {jobs: {...}} object")
        except FileNotFoundError:
            return
        except (OSError, ValueError):
            return
        self.jobs = on_disk["jobs"]
        self.seq = int(on_disk.get("seq", len(self.jobs)))

    def _compact(self) -> None:
        """Bound the journal: drop the OLDEST terminal entries beyond
        ``max_terminal_kept`` (their results/ file stays the durable
        record). Open jobs (queued/running) are never touched — their
        lease/token state must survive every save, or a restarted
        daemon would schedule (and fence) differently than the dead
        one would have."""
        # a done sub-job of a still-open parent must survive compaction:
        # the parent's advance sweep decides fanned -> merge by reading
        # its children's journal states, and compacting one away would
        # stall (or mis-fail) the merge forever
        open_parents = {
            jid for jid, e in self.jobs.items()
            if e.get("state") not in TERMINAL_STATES
        }
        terminal = sorted(
            (
                (int(e.get("seq", 0)), jid)
                for jid, e in self.jobs.items()
                if e.get("state") in TERMINAL_STATES
                and e.get("parent") not in open_parents
            ),
        )
        for _, jid in terminal[: max(len(terminal) - self.max_terminal_kept, 0)]:
            del self.jobs[jid]

    def save(self) -> None:
        """Durable journal persist (fault site ``serve.journal``)."""
        # _io_retry imported lazily: the CLIENT side of this module
        # (submit/status for `call --submit/--status/--wait`) must not
        # drag in runtime.stream and the executor stack on every poll
        from duplexumiconsensusreads_torch.runtime.stream import _io_retry

        self._compact()
        payload = json.dumps(
            {"version": JOURNAL_VERSION, "seq": self.seq, "jobs": self.jobs},
            sort_keys=True,
        ).encode()
        _io_retry(
            "serve.journal",
            lambda: write_durable(
                self.journal_path, payload, tmp=unique_tmp(self.journal_path)
            ),
            "queue journal save",
        )

    def pending_submissions(self) -> list[str]:
        """Inbox job ids in ARRIVAL order (mtime of the durable spool
        file, name as tiebreak): admission seq — and therefore FIFO
        order within a priority class — follows submission time, not
        the job-id hash the filenames happen to sort by."""
        entries = []
        try:
            for n in os.listdir(self.inbox_dir):
                if not n.endswith(".json"):
                    continue
                try:
                    mt = os.stat(os.path.join(self.inbox_dir, n)).st_mtime
                except OSError:
                    continue  # raced away mid-listing
                entries.append((mt, n))
        except OSError:
            return []
        return [n[:-5] for _, n in sorted(entries)]

    def accept_one(self, job_id: str) -> tuple[JobSpec | None, str | None]:
        """Admit one inbox submission: read + validate (fault site
        ``serve.accept``), journal it durably, THEN remove the inbox
        file — one flock'd transaction, so two daemons scanning the
        same inbox admit each job exactly once. Returns (spec, None) on
        admission, (None, reason) on rejection (shed policy, bounded
        queue, invalid spec), (None, None) when the submission was a
        duplicate of an already-journaled job.

        Kill-anywhere safety: before the journal save the inbox file is
        untouched (restart re-admits); after it, re-admission dedupes on
        job_id and merely removes the leftover inbox file."""
        from duplexumiconsensusreads_torch.runtime.stream import _io_retry

        path = os.path.join(self.inbox_dir, job_id + ".json")

        def _read():
            with open(path, "rb") as f:
                return f.read()

        with self._txn():
            try:
                raw = _io_retry("serve.accept", _read, f"job {job_id} accept")
            except FileNotFoundError:
                return None, None  # raced away (another daemon admitted it)
            if job_id in self.jobs:
                # already journaled (kill landed between journal +
                # unlink, or another daemon won the race): admission
                # already happened exactly once — just clean up
                self._unlink_inbox(path)
                return None, None
            try:
                spec = validate_spec(json.loads(raw.decode()))
                if spec.job_id != job_id:
                    raise ValueError(
                        f"spec job_id {spec.job_id!r} does not match the "
                        f"spool filename"
                    )
            except (ValueError, UnicodeDecodeError) as e:
                self._write_rejection_result(job_id, str(e), shed=False)
                self.jobs[job_id] = {
                    "state": "rejected", "error": str(e)[:500], "seq": self.seq,
                }
                self.seq += 1
                self.save()
                self._unlink_inbox(path)
                return None, str(e)
            # admission control: disk pressure first (accepting a job
            # the spool cannot even journal for is the worst shed),
            # then the scheduler's per-class shed policy, then the
            # global open-jobs bound as the backstop — all journaled as
            # explicit shed-with-reason rejections, so an overloaded
            # fleet degrades by policy (and tells the client why),
            # never by an inbox silently rotting
            reason = self._disk_shed_reason()
            if reason is None and self.admission_policy is not None:
                reason = self.admission_policy(self.jobs, spec)
            if reason is None:
                n_open = sum(
                    1 for j in self.jobs.values()
                    if j.get("state") in OPEN_STATES
                )
                if n_open >= self.max_queue:
                    reason = (
                        f"shed: queue full ({n_open}/{self.max_queue} "
                        f"jobs open)"
                    )
            if reason is not None:
                self._write_rejection_result(job_id, reason, shed=True)
                self.jobs[job_id] = {
                    "state": "rejected", "error": reason, "shed": True,
                    "priority": spec.priority, "seq": self.seq,
                }
                self.seq += 1
                self.save()
                self._unlink_inbox(path)
                return None, reason
            entry = {
                "state": "queued",
                "seq": self.seq,
                "priority": spec.priority,
                "spec": spec.to_dict(),
                "slices": 0,
                "chunks_done": 0,
                # admission timestamp on the spool's shared stamp
                # clock: whichever daemon eventually claims the job
                # computes its queue-wait against this
                "admitted_m": round(self.store.now(), 3),
            }
            # deadline: the job's own budget wins over the daemon-level
            # default; stamped as a stamp-domain expiry at admission
            # (the budget runs from acceptance, queue-wait included),
            # the one clock domain the whole lease machinery uses
            deadline_s = spec.deadline_s or self.default_deadline_s
            if deadline_s and deadline_s > 0:
                entry["deadline_m"] = ceil_ms(
                    self.store.now() + float(deadline_s)
                )
            if spec.shards is not None or spec.shard_bytes is not None:
                # sharding parent: the phase field decides what a claim
                # means — "split" until the planner fans the sub-jobs
                # out, "merge" once the parent is requeued to splice
                entry["phase"] = "split"
            if spec.shard is not None:
                # a directly-spooled sub-job (normally planner-internal):
                # keep the lineage columns status/serve_report read
                entry["parent"] = str(spec.shard.get("parent"))
                entry["shard_idx"] = int(spec.shard.get("idx", 0))
            self.jobs[job_id] = entry
            self.seq += 1
            self.save()
            self._unlink_inbox(path)
            return spec, None

    @staticmethod
    def _unlink_inbox(path: str) -> None:
        try:
            os.remove(path)
        except OSError:
            pass  # re-admission dedupes; a leftover file is harmless

    # ------------------------------------------------------------ leases

    def _check_fence(self, job_id: str, daemon_id: str, token: int) -> dict:
        """Raise :class:`JobFenced` unless ``daemon_id`` still holds
        ``job_id``'s CURRENT lease under fencing token ``token``.
        Returns the journal entry. Caller holds the transaction."""
        entry = self.jobs.get(job_id)
        lease = (entry or {}).get("lease")
        if (
            entry is None
            or entry.get("state") not in CLAIMED_STATES
            or lease is None
            or lease.get("owner") != daemon_id
            or int(entry.get("token", 0)) != int(token)
        ):
            raise JobFenced(
                f"job {job_id}: lease lost (holder token {token}, journal "
                f"token {(entry or {}).get('token')!r}, owner "
                f"{(lease or {}).get('owner')!r})"
            )
        return entry

    def claim(
        self, job_id: str, daemon_id: str, lease_s: float = LEASE_DEFAULT_S
    ) -> int | None:
        """Claim a queued job for ``daemon_id``: bump the fencing token,
        write the lease, mark it running — one durable transaction
        (fault site ``serve.lease``). Returns the new token, or None if
        the job raced away (another daemon claimed or finished it)."""
        with self._txn():
            entry = self.jobs.get(job_id)
            if entry is None or entry.get("state") != "queued":
                return None
            token = int(entry.get("token", 0)) + 1
            entry["token"] = token
            # stage-aware claim: a sharding parent's claim means
            # planning ("split" phase) or merging ("merge" phase), and
            # the journal says which — all three literals are leased
            # states under the same fence/takeover machinery
            phase = entry.get("phase")
            entry["state"] = (
                "splitting" if phase == "split"
                else "merging" if phase == "merge"
                else "running"
            )
            entry["slices"] = int(entry.get("slices", 0)) + 1
            entry["lease"] = self.store.lease_doc(daemon_id, lease_s)
            # durable-progress stamp: a fresh claim counts as progress
            # (the watchdog must not declare a just-claimed job stalled
            # while it compiles); every chunk-commit renewal re-stamps
            entry["progress_m"] = ceil_ms(self.store.now())
            # bounded claim history: who ran this job under which token
            # — the quarantine diagnosis bundle's lease trail
            hist = entry.setdefault("lease_history", [])
            hist.append(self.store.claim_rec(daemon_id, token))
            del hist[:-_LEASE_HISTORY_KEPT]
            self.save()
            return token

    def verify_lease(self, job_id: str, daemon_id: str, token: int) -> None:
        """The fence check: raise :class:`JobFenced` unless this
        (daemon, token) is still the job's current lease. Read-only;
        called (under fault site ``serve.fence``) before every durable
        commit a slice makes."""
        with self._txn():
            self._check_fence(job_id, daemon_id, token)

    def renew_lease(
        self, job_id: str, daemon_id: str, token: int,
        lease_s: float = LEASE_DEFAULT_S, progress: dict | None = None,
    ) -> None:
        """Extend the lease (fault site ``serve.renew``), fenced: a
        zombie must not be able to resurrect a reclaimed lease.

        Called from the per-chunk commit guard — i.e. exactly when a
        chunk became durable — so it also re-stamps ``progress_m``, the
        watchdog's DURABLE-progress clock. The heartbeat's
        :meth:`renew_all` deliberately does not: a wedged device step
        keeps the heartbeat (liveness) alive while committing nothing,
        and conflating the two is exactly the hang this distinction
        exists to catch.

        ``progress`` (optional) merges observable per-chunk counters
        into the journal entry inside the SAME fenced transaction —
        follow-mode jobs ride this to publish ``snapshot_seq`` /
        ``reads_emitted`` (a follow job can run for hours between slice
        boundaries, so ``--status`` must not have to wait for one). A
        fenced write on purpose: a zombie must not be able to stamp
        stale progress over the journal any more than a stale lease."""
        with self._txn():
            entry = self._check_fence(job_id, daemon_id, token)
            entry["lease"]["expires_m"] = ceil_ms(self.store.now() + lease_s)
            entry["progress_m"] = ceil_ms(self.store.now())
            if progress:
                entry.update(progress)
            self.save()

    def renew_all(self, daemon_id: str, lease_s: float = LEASE_DEFAULT_S) -> int:
        """Heartbeat-path renewal: extend every running lease this
        daemon holds. Returns the number renewed (0 = nothing to save)."""
        with self._txn():
            renewed = 0
            deadline = ceil_ms(self.store.now() + lease_s)
            for entry in self.jobs.values():
                lease = entry.get("lease")
                if (
                    entry.get("state") in CLAIMED_STATES
                    and lease is not None
                    and lease.get("owner") == daemon_id
                ):
                    lease["expires_m"] = deadline
                    renewed += 1
            if renewed:
                self.save()
            return renewed

    def reclaim_dead(
        self, daemon_id: str, is_live=None, hosts=None
    ) -> list[dict]:
        """Dead-daemon takeover: requeue every running job whose lease
        no longer protects it — expired (the zombie case: the owner may
        still be alive, which is exactly what the fencing token guards
        against), provably dead by the store's liveness oracle (a dead
        local pid, a stale/rebooted heartbeat document), or missing
        entirely (a pre-lease journal). Reclaimed jobs keep their
        ORIGINAL seq (they reached the front once already) and their
        token (the NEXT claim bumps it, fencing the previous holder).

        ``is_live`` (optional callable daemon_id -> bool) identifies
        live daemons within THIS process — the in-process fleet used by
        tests and the bench, where every daemon shares one pid (local
        store only; the sharedfs backend trusts documents, not process
        state). ``hosts`` is a heartbeat snapshot from the store's
        ``observe()`` — the caller takes it under fault site
        ``serve.store``; None re-observes here. Returns [{job_id,
        reason, prev_owner, crash_count[, quarantined]}, ...]; the
        persist rides fault site ``serve.expire``.

        Every reclaim here is an abort that was NOT a clean preemption
        (the owner died or went silent holding the lease), so it
        increments the job's ``crash_count``; at ``max_crashes`` the
        job is quarantined instead of requeued (see
        :meth:`_abort_requeue_locked`)."""
        now = self.store.now()
        if hosts is None:
            hosts = self.store.observe()
        with self._txn():
            reclaimed = []
            for job_id, entry in self.jobs.items():
                if entry.get("state") not in CLAIMED_STATES:
                    continue
                reason = self.store.reclaim_reason(
                    entry.get("lease"), now, is_live=is_live, hosts=hosts
                )
                if reason is None:
                    continue
                reclaimed.append(
                    self._abort_requeue_locked(job_id, entry, reason)
                )
                entry.pop("lease", None)
            if reclaimed:
                self.save()
            return reclaimed

    def reclaim_stalled(self, stall_s: float | None) -> list[dict]:
        """Stuck-run watchdog reclaim: abort-requeue every RUNNING job
        whose last durable progress (``progress_m``: stamped at claim
        and on every chunk-commit renewal) is older than ``stall_s`` —
        regardless of lease freshness. This is the hole lease expiry
        cannot see: a wedged device step keeps the owner's heartbeat
        (and therefore its lease renewals) alive while committing
        nothing, forever. The requeue rides the normal lease/fence
        path: the token is kept and the NEXT claim bumps it, so the
        wedged slice — should it ever wake — is fenced at its first
        durable commit, exactly like a zombie after expiry takeover.

        ``stall_s`` None = disabled (returns []); the call still sits
        under fault site ``serve.watchdog`` at the caller, so chaos
        schedules target the watchdog step even when it reclaims
        nothing. Counts as a crash (not a clean preemption) toward
        quarantine, like takeover."""
        if stall_s is None or stall_s <= 0:
            return []
        now = self.store.now()
        with self._txn():
            reclaimed = []
            for job_id, entry in self.jobs.items():
                if entry.get("state") not in CLAIMED_STATES:
                    continue
                progress_m = entry.get("progress_m")
                if progress_m is None:
                    continue  # pre-watchdog journal: expiry still covers
                stalled = now - float(progress_m)
                if stalled <= stall_s:
                    continue
                rec = self._abort_requeue_locked(job_id, entry, "stalled")
                rec["stalled_s"] = ceil_ms(stalled)
                reclaimed.append(rec)
                entry.pop("lease", None)
            if reclaimed:
                self.save()
            return reclaimed

    def _abort_requeue_locked(
        self, job_id: str, entry: dict, reason: str
    ) -> dict:
        """One unclean abort of a running job: bump ``crash_count``,
        then either requeue at ORIGINAL seq with the token kept (the
        next claim fences the old holder) or — at ``max_crashes`` —
        move the job to terminal ``quarantined`` with a durable
        diagnosis bundle. The CALLER holds the transaction, pops the
        lease and saves ONCE after its sweep — saving per job here
        would run compaction mid-iteration (mutating the dict being
        swept) and rewrite+fsync the journal N times for one sweep.
        Returns the reclaim record for the caller's counters/events."""
        # only a leased state can abort uncleanly — and this assert is
        # also the from-state evidence the state-machine lint reads
        assert entry.get("state") in CLAIMED_STATES, entry.get("state")
        lease = entry.get("lease")
        prev = (lease or {}).get("owner")
        crashes = int(entry.get("crash_count", 0)) + 1
        entry["crash_count"] = crashes
        rec = {
            "job_id": job_id, "reason": reason, "prev_owner": prev,
            "crash_count": crashes,
        }
        if crashes >= self.max_crashes:
            diagnosis = self._diagnosis(entry, reason)
            error = (
                f"quarantined after {crashes} crashed runs "
                f"(max_crashes={self.max_crashes}; last abort: {reason})"
            )
            self._write_terminal_result(
                job_id, {"error": error, "quarantined": True,
                         "diagnosis": diagnosis},
            )
            entry["state"] = "quarantined"
            entry["error"] = error[:500]
            rec["quarantined"] = True
        else:
            entry["state"] = "queued"
        return rec

    def _diagnosis(self, entry: dict, reason: str) -> dict:
        """The quarantine post-mortem bundle, durable in the job's
        result file: why the fleet gave up, who held the job when, and
        — when the job carried its own trace capture — the capture's
        tail with the last injected/observed fault site, so the
        operator (or the poison-job test) never has to re-run the
        poison to learn what it does."""
        out = {
            "crash_count": int(entry.get("crash_count", 0)),
            "max_crashes": self.max_crashes,
            "last_abort": reason,
            "lease_history": list(entry.get("lease_history", [])),
        }
        # capture sources, most-specific first: the job's own --trace
        # capture, then the SERVICE captures — a daemon running with
        # the (default) service trace owns the process-global telemetry
        # hook, so the poison's fault_injected event lands in the
        # service capture, not the job's; and the daemon the poison
        # crashed is a PREVIOUS daemon whose capture the current one
        # rotated to .prev on startup. Each is scanned over a generous
        # suffix (the fault event lands before the in-flight drain
        # spans that follow it into the capture), but only a short tail
        # is bundled — the diagnosis must stay a small durable JSON.
        candidates = []
        trace = (entry.get("spec") or {}).get("trace")
        if trace:
            candidates.append(trace)
        # service captures are per-daemon (service.<id>.trace.jsonl +
        # rotated .prev) since the fleet recorder; the legacy shared
        # name still matters for --trace overrides and old spools.
        # Newest STITCHED END first (meta epoch_m + last relative t —
        # the clock the journal stamps live on), so the most recent
        # capture naming a fault site — the one that saw THIS job's
        # last crash — wins the setdefault/break scan below over stale
        # history. mtime is meaningless across hosts (skewed wall
        # clocks, coarse shared-fs timestamps) and only ranks the
        # pre-fleet captures that carry no epoch — those sort behind
        # every epoch-bearing capture.
        from duplexumiconsensusreads_torch.telemetry.fleet import (
            discover_service_captures,
        )

        svc = []
        for p in discover_service_captures(self.root):
            end = _capture_stitched_end(p)
            if end is not None:
                svc.append((1, end, p))
            else:
                try:
                    svc.append((0, os.path.getmtime(p), p))
                except OSError:
                    continue
        candidates += [p for _, _, p in sorted(svc, reverse=True)]
        for path in candidates:
            lines = _trace_tail(path, max_bytes=65536, max_lines=512)
            if not lines:
                continue
            out.setdefault("trace_tail", lines[-20:])
            site = _last_fault_site(lines)
            if site is not None:
                out["last_fault_site"] = site
                break
        return out

    def _write_terminal_result(self, job_id: str, payload: dict) -> None:
        """Durable result write shared by the quarantine/expiry paths
        (same protocol as done/failed results: the file outlives the
        journal entry's compaction)."""
        path = os.path.join(self.results_dir, job_id + ".json")
        write_durable(
            path,
            json.dumps(payload, sort_keys=True).encode(),
            tmp=unique_tmp(path),
        )

    # --------------------------------------------- scatter-gather sharding

    def _shard_rollup(self, entry: dict) -> dict:
        """A parent's aggregate view of its sub-jobs: K done/claimed/
        queued plus the first failure's reason — what ``call --status
        <parent>`` and ``--wait`` progress read. Children are protected
        from compaction while the parent is open, so the journal always
        answers."""
        counts = {"n_shards": len(entry.get("children", ())),
                  "done": 0, "running": 0, "queued": 0, "failed": 0}
        compacted = 0
        first_failure = None
        for cid in entry.get("children", ()):
            c = self.jobs.get(cid)
            if c is None:
                # child entry compacted away — only possible once the
                # parent itself is terminal (open parents protect their
                # children from compaction), so this is history, not a
                # failure: the durable results/ file remains the record
                compacted += 1
                continue
            state = c.get("state")
            if state == "done":
                counts["done"] += 1
            elif state in CLAIMED_STATES:
                counts["running"] += 1
            elif state == "queued":
                counts["queued"] += 1
            else:
                counts["failed"] += 1
                if first_failure is None:
                    first_failure = {
                        "shard": cid,
                        "state": state,
                        "error": c.get("error"),
                    }
        if compacted:
            counts["compacted"] = compacted
        if first_failure is not None:
            counts["first_failure"] = first_failure
        return counts

    def register_shards(
        self, parent_id: str, daemon_id: str, token: int,
        child_dicts: list[dict],
    ) -> int:
        """The split transaction (fault site ``serve.split`` at the
        caller): register the planned sub-jobs as ordinary queued
        entries and move the fenced parent splitting -> fanned, all in
        one durable journal write. Idempotent under re-planning: child
        ids derive from (parent_id, shard_idx), so a kill between plan
        and save — or a takeover mid-split — re-registers the same ids
        and dedupes exactly like inbox re-admission. Returns the number
        of children newly registered."""
        from duplexumiconsensusreads_torch.serve.job import validate_spec

        registered = 0
        with self._txn():
            parent = self._check_fence(parent_id, daemon_id, token)
            children = []
            for d in child_dicts:
                spec = validate_spec(d)  # the daemon never trusts a dict
                children.append(spec.job_id)
                if spec.job_id in self.jobs:
                    continue  # re-plan after a kill: already registered
                entry = {
                    "state": "queued",
                    "seq": self.seq,
                    "priority": spec.priority,
                    "spec": spec.to_dict(),
                    "slices": 0,
                    "chunks_done": 0,
                    "admitted_m": round(self.store.now(), 3),
                    "parent": parent_id,
                    "shard_idx": int((spec.shard or {}).get("idx", 0)),
                }
                deadline_m = parent.get("deadline_m")
                if deadline_m is not None:
                    # children inherit the parent's admission-stamped
                    # expiry: the deadline bounds the whole pipeline
                    entry["deadline_m"] = deadline_m
                self.jobs[spec.job_id] = entry
                self.seq += 1
                registered += 1
            parent["children"] = children
            parent["n_shards"] = len(children)
            parent["state"] = "fanned"
            parent.pop("lease", None)
            self.save()
            return registered

    def advance_parents(self) -> list[dict]:
        """One parent sweep (fault site ``serve.merge`` at the caller):
        every ``fanned`` parent whose sub-jobs all published is requeued
        as a merge task (phase "merge", ORIGINAL seq — the merge is the
        oldest work its class has); a parent with a terminally-failed
        sub-job goes terminal ``failed`` with a durable diagnosis
        naming the shard, and its still-queued siblings are failed
        alongside (running ones finish harmlessly — their outputs are
        never read). Returns [{job_id, decision, ...}] for the
        service's events/counters."""
        with self._txn():
            moved = []
            for job_id, entry in list(self.jobs.items()):
                if entry.get("state") != "fanned":
                    continue
                rollup = self._shard_rollup(entry)
                if rollup["failed"]:
                    first = rollup.get("first_failure", {})
                    error = (
                        f"shard {first.get('shard')} "
                        f"{first.get('state')}: {first.get('error')}"
                    )
                    self._write_terminal_result(
                        job_id,
                        {"error": error[:2000], "shard_failure": first},
                    )
                    entry["state"] = "failed"
                    entry["error"] = error[:500]
                    for cid in entry.get("children", ()):
                        c = self.jobs.get(cid)
                        if c is not None and c.get("state") == "queued":
                            reason = f"parent {job_id} failed: {error}"
                            self._write_terminal_result(
                                cid, {"error": reason[:2000]},
                            )
                            c["state"] = "failed"
                            c["error"] = reason[:500]
                    moved.append({
                        "job_id": job_id, "decision": "failed",
                        "shard_failure": first,
                    })
                elif rollup["done"] == rollup["n_shards"]:
                    entry["state"] = "queued"
                    entry["phase"] = "merge"
                    moved.append({
                        "job_id": job_id, "decision": "merge",
                        "n_shards": rollup["n_shards"],
                    })
            # orphan reaping: a child that was RUNNING when its parent
            # failed escapes the sibling cancellation above — it later
            # preempts (or is takeover-requeued) back to "queued", and
            # without this sweep the fleet would keep re-claiming and
            # running it forever for a result nothing will ever read
            for job_id, entry in self.jobs.items():
                if entry.get("state") != "queued":
                    continue
                parent_id = entry.get("parent")
                if parent_id is None:
                    continue
                parent = self.jobs.get(parent_id)
                if parent is None:
                    # no journal entry for the parent at all: this is a
                    # DIRECTLY-spooled sub-job (debug/re-run — submit()
                    # admits those on purpose), not an orphan; only a
                    # journaled-terminal parent proves the merge is dead
                    continue
                if parent.get("state") not in TERMINAL_STATES:
                    continue
                reason = (
                    f"parent {parent_id} is terminal "
                    f"({parent.get('state')}): "
                    f"orphaned shard will never be merged"
                )
                self._write_terminal_result(job_id, {"error": reason})
                entry["state"] = "failed"
                entry["error"] = reason[:500]
                moved.append({
                    "job_id": job_id, "decision": "orphaned",
                    "parent": parent_id,
                })
            if moved:
                self.save()
            return moved

    # ---------------------------------------------------------- deadlines

    def expire_deadlines(self) -> list[dict]:
        """Terminal-ize every QUEUED job whose admission-stamped
        monotonic deadline has passed: journal state ``expired`` with a
        durable reason (fault site ``serve.deadline`` at the caller).
        Running jobs are not touched here — their own slice aborts at
        the next checkpoint boundary via the commit-path deadline check
        — and the partial checkpoint is left intact either way, so a
        re-submitted job resumes instead of recomputing (and can never
        splice: resume re-verifies every shard)."""
        now = self.store.now()
        with self._txn():
            expired = []
            for job_id, entry in self.jobs.items():
                if entry.get("state") != "queued":
                    continue
                deadline_m = entry.get("deadline_m")
                if deadline_m is None or float(deadline_m) > now:
                    continue
                overdue = now - float(deadline_m)
                error = (
                    f"expired: deadline passed {overdue:.3f}s ago before "
                    f"the job could run (queued since admission)"
                )
                self._write_terminal_result(
                    job_id, {"error": error, "expired": True},
                )
                entry["state"] = "expired"
                entry["error"] = error[:500]
                expired.append({"job_id": job_id, "reason": error})
            if expired:
                self.save()
            return expired

    def mark_expired(
        self, job_id: str, reason: str,
        daemon_id: str | None = None, token: int | None = None,
    ) -> None:
        """A RUNNING slice hit its deadline at a chunk boundary: fenced
        terminal transition to ``expired`` with a durable reason. The
        committed checkpoint prefix is preserved byte-for-byte — the
        abort happened between commits, so the manifest is a valid
        gap-free prefix and a re-submitted job resumes from it."""
        with self._txn():
            if daemon_id is not None:
                self._check_fence(job_id, daemon_id, int(token or 0))
            self._write_terminal_result(
                job_id, {"error": reason[:2000], "expired": True},
            )
            entry = self.jobs[job_id]
            entry["state"] = "expired"
            entry["error"] = reason[:500]
            entry.pop("lease", None)
            self.save()

    # ----------------------------------------------- state transitions

    def requeue(
        self, job_id: str, chunks_done: int, back: bool,
        daemon_id: str | None = None, token: int | None = None,
    ) -> None:
        """Preempted job back to the queue, releasing its lease.
        ``back=True`` moves it behind its class's waiting jobs (the
        budget-yield fairness rule); ``back=False`` keeps its original
        seq (drain must not penalise the interrupted job). Fenced when
        the caller passes its lease identity: a zombie's requeue of a
        job someone else now owns must be void."""
        with self._txn():
            if daemon_id is not None:
                self._check_fence(job_id, daemon_id, int(token or 0))
            entry = self.jobs[job_id]
            entry["state"] = "queued"
            entry["chunks_done"] = int(chunks_done)
            entry.pop("lease", None)
            if back:
                entry["seq"] = self.seq
                self.seq += 1
            self.save()

    def mark_done(
        self, job_id: str, result: dict,
        daemon_id: str | None = None, token: int | None = None,
    ) -> None:
        """Result file first, journal second: a kill between the two
        re-runs the job's (idempotent, checkpointed) tail rather than
        journaling a result that was never durably written. The fence
        check and the publish share one transaction, so a reclaim
        cannot slip between them."""
        with self._txn():
            if daemon_id is not None:
                self._check_fence(job_id, daemon_id, int(token or 0))
            path = os.path.join(self.results_dir, job_id + ".json")
            write_durable(
                path,
                json.dumps(result, sort_keys=True).encode(),
                tmp=unique_tmp(path),
            )
            entry = self.jobs[job_id]
            entry["state"] = "done"
            entry.pop("error", None)
            entry.pop("lease", None)
            self.save()

    def mark_failed(
        self, job_id: str, error: str,
        daemon_id: str | None = None, token: int | None = None,
    ) -> None:
        with self._txn():
            if daemon_id is not None:
                self._check_fence(job_id, daemon_id, int(token or 0))
            path = os.path.join(self.results_dir, job_id + ".json")
            write_durable(
                path,
                json.dumps({"error": error[:2000]}, sort_keys=True).encode(),
                tmp=unique_tmp(path),
            )
            entry = self.jobs[job_id]
            entry["state"] = "failed"
            entry["error"] = error[:500]
            entry.pop("lease", None)
            self.save()

    def queue_depth(self) -> int:
        return sum(
            1 for j in self.jobs.values() if j.get("state") == "queued"
        )

    # ------------------------------------------------------ disk pressure

    def _disk_shed_reason(self) -> str | None:
        """Admission-control verdict for disk pressure: a ``shed:
        disk`` reason when the spool filesystem is below the low-water
        mark even after a grace GC pass over terminal jobs' litter,
        else None. An unprobeable filesystem admits (the durable writes
        themselves will say otherwise soon enough)."""
        if self.min_free_bytes <= 0:
            return None
        free = free_bytes(self.root)
        if free is None or free >= self.min_free_bytes:
            return None
        # grace pass: terminal jobs' shard/checkpoint litter is the one
        # reclaimable thing the queue owns — drop it and re-probe
        # before refusing work
        self.gc_terminal_litter()
        free = free_bytes(self.root)
        if free is None or free >= self.min_free_bytes:
            return None
        return (
            f"shed: disk free {free >> 20}MB below low-water "
            f"{self.min_free_bytes >> 20}MB on the spool filesystem"
        )

    def gc_terminal_litter(self) -> int:
        """Delete terminal jobs' recovery litter: the ``<output>.ckpt``
        manifest, ``<output>.shards/`` directory and ``<output>.tmp``
        staging file of every journaled done/failed/expired/quarantined
        job. A terminal job will never resume, so its checkpoint state
        is pure disk pressure; the published output itself (and the
        durable result) is never touched. Returns bytes freed.
        Best-effort by design — called under disk pressure and before
        failing a job on ENOSPC, where raising would only make the
        victim's story worse."""
        freed = 0
        for entry in list(self.jobs.values()):
            if entry.get("state") not in TERMINAL_STATES:
                continue
            output = (entry.get("spec") or {}).get("output")
            if not output:
                continue
            parent_id = entry.get("parent")
            if parent_id is not None:
                parent = self.jobs.get(parent_id)
                if parent is None or parent.get("state") in TERMINAL_STATES:
                    # a shard sub-job's published output is intermediate:
                    # once its parent is terminal (merged, failed or
                    # gone) the merge will never read it again — unlike
                    # user-facing outputs, it IS reclaimable litter
                    freed += _remove_counting(output)
            if entry.get("n_shards"):
                # terminal PARENT: its shard outputs are derivable even
                # after the child entries compact away (the one case
                # the per-child branch above cannot see — e.g. a daemon
                # killed between the merge publish and its cleanup)
                from duplexumiconsensusreads_torch.serve.shard.plan import (
                    shard_output_path,
                )

                for i in range(int(entry["n_shards"])):
                    freed += _remove_counting(
                        shard_output_path(output, i)
                    )
            for path in (output + ".ckpt", output + ".tmp"):
                freed += _remove_counting(path)
            # pid/tid-suffixed staging litter next to the output (an
            # aborted merge's unique_tmp after a real SIGKILL): the
            # names are never reused, so only this sweep reclaims them.
            # Safe against a live zombie merger: its publish-by-rename
            # of a removed tmp fails loudly and the fence absorbs it.
            out_dir = os.path.dirname(output) or "."
            stem = os.path.basename(output) + ".tmp."
            try:
                names = os.listdir(out_dir)
            except OSError:
                names = []
            for n in names:
                if n.startswith(stem):
                    freed += _remove_counting(os.path.join(out_dir, n))
            shard_dir = output + ".shards"
            try:
                names = os.listdir(shard_dir)
            except OSError:
                continue
            for n in names:
                freed += _remove_counting(os.path.join(shard_dir, n))
            try:
                os.rmdir(shard_dir)
            except OSError:
                pass
        return freed

    # ------------------------------------------------------- maintenance

    def sweep_orphan_tmps(self) -> int:
        """Remove staging files orphaned by dead daemons. Fleet writers
        stage through ``<dst>.tmp.<pid>.<tid>`` names (io.durable.
        unique_tmp) so concurrent writers can't collide — but a daemon
        killed between its tmp write and the rename leaves that file
        behind forever (no later writer reuses the name). A file is an
        orphan exactly when its embedded pid is dead — no clocks, no
        guessing; live daemons' in-flight staging files are untouched.
        The pid probe is the STORE's liveness oracle: on a sharedfs
        spool pids from other hosts are unprobeable, so the store
        answers "possibly alive" for every pid and this sweep removes
        nothing (unreaped litter is inert; gc_terminal_litter still
        reclaims the bulk per terminal job). Called at daemon startup;
        returns the number removed."""
        removed = 0
        for d in (self.root, self.inbox_dir, self.results_dir):
            try:
                names = os.listdir(d)
            except OSError:
                continue
            for n in names:
                parts = n.rsplit(".", 3)
                if len(parts) != 4 or parts[1] != "tmp":
                    continue
                try:
                    pid = int(parts[2])
                    int(parts[3])
                except ValueError:
                    continue
                if self.store.pid_alive(pid):
                    continue
                try:
                    os.remove(os.path.join(d, n))
                    removed += 1
                except OSError:
                    pass  # raced away / permissions: litter, not a fault
        return removed
