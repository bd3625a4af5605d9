"""The consensus service: admission → fair scheduling → warm slices.

One ``ConsensusService`` owns a spool directory and drains it through a
small pool of warm workers — and N services (processes or instances)
can share ONE spool as a fleet: every queue/journal mutation is a
flock'd transaction (serve.queue), a job runs only under a durable
LEASE claimed in that journal, and every durable commit a slice makes
is fenced by the lease's token. Two daemons can therefore never run one
job at the same time, a daemon that dies mid-job is taken over (lease
expiry, or immediately when its pid is provably dead) with the next
slice resuming from the last durable checkpoint mark, and a zombie
daemon that wakes up after takeover aborts before splicing a byte.
In-process scheduling decisions stay serialized under one lock; the
slices themselves (the expensive part) run outside it. The service is
equally usable in-process (tests, the bench's ``serve_n_jobs`` /
``serve_fleet`` legs) and as the ``dut-serve`` daemon (serve.daemon).

Admission control: beyond the global open-jobs bound, each priority
class can carry a queued-depth bound (``class_depths``); submissions
over a bound are journaled as explicit shed-with-reason rejections
(``job_shed`` trace events, ``shed: ...`` reasons in ``--status``), and
per-class queue-wait / time-to-first-chunk percentiles land in
``metrics.json`` — overload degrades by policy, observably.

Defensive layer (deadlines / watchdog / quarantine / disk pressure):
jobs may carry a ``deadline_s`` (or inherit the daemon's default) —
admission stamps a monotonic expiry, the scheduler refuses expired
picks, a per-pass sweep journals overdue queued jobs terminal
``expired``, and a running slice aborts at its next checkpoint
boundary with the committed prefix preserved for a re-submitted
resume. A per-daemon WATCHDOG thread compares each running job's
durable-progress stamp (re-written on every chunk-commit lease
renewal, NOT by the heartbeat) against a stall threshold (explicit, or
derived from the observed chunk-commit p95) and abort-requeues wedged
runs through the lease/fence path. Every such unclean abort — watchdog
or dead-daemon takeover — bumps the job's ``crash_count``; at
``max_crashes`` the job is QUARANTINED terminally with a durable
diagnosis bundle instead of re-poisoning the fleet. Admission sheds
new jobs when the spool filesystem is below a low-water mark (after a
grace GC of terminal jobs' litter), and an ENOSPC inside a job fails
that job cleanly — durable reason, daemon alive.

Graceful drain: :meth:`request_drain` (the daemon's SIGTERM handler)
makes every running slice yield at its next chunk boundary — the
executor checkpoints the committed prefix, the job is re-journaled as
queued (lease released), and :meth:`run` returns cleanly. A restarted
service resumes both the queue and every interrupted job from exactly
that state; the chaos-kill path (InjectedKill anywhere in admission or
a slice) leaves the same journal a real SIGKILL would, which the
recovery tests pin.

Telemetry: with ``trace_path`` set the service records a
kind="service" capture (telemetry/trace.py): job lifecycle events on
``job-<id>`` lanes (now including ``job_shed``, ``job_fenced`` and
``lease_takeover``), service heartbeats carrying the queue snapshot,
and — because the recorder is installed as the process-global hook —
every fault/retry/durable event the switchboard emits while jobs run.
``tools/serve_report.py`` summarises it; ``tools/check_trace.py``
validates it.

Port note (the JAX package's service, copied; what the card changed):

- The device belongs to the daemon: ``device`` ("cuda" by default,
  "cuda:<i>" to pin a card, "cpu" only when asked) is resolved in the
  constructor, which raises when there is no card; nothing falls back
  to the CPU or to a kernel's plain version. Jobs carry no device.
- The compile cache: the JAX service enables XLA's persistent cache in
  :meth:`run`; here ``build_dir`` (``serve.daemon --build-dir``) points
  the kernel and native-loader builds at one directory
  (utils/compile_cache.py), so the daemon's first job builds and the
  later ones, and later daemons, load. A failed build fails the job.
- Device seconds and MFU: the slices' ``device_seconds`` are the
  streaming executor's CUDA-event spans (not the host clock), and the
  peak is ``telemetry/device.py:device_peak_flops`` for this daemon's
  card (its H100 entry on the H100).
- ``compile_hit_rate`` counts warm bucket-spec signatures, not jit hits
  (serve/worker.py).
"""

from __future__ import annotations

import errno
import os
import threading
import time
import uuid

from duplexumiconsensusreads_torch.io.durable import unique_tmp, write_durable
from duplexumiconsensusreads_torch.runtime.stream import _io_retry
from duplexumiconsensusreads_torch.serve.job import validate_spec
from duplexumiconsensusreads_torch.serve.queue import (
    DISK_LOW_WATER_BYTES,
    LEASE_DEFAULT_S,
    MAX_CRASHES_DEFAULT,
    JobFenced,
    SpoolQueue,
)
from duplexumiconsensusreads_torch.serve.states import OPEN_STATES
from duplexumiconsensusreads_torch.serve.store import (
    LeaseStore,
    floor_ms,
    resolve_store,
)
from duplexumiconsensusreads_torch.serve.scheduler import FairScheduler
from duplexumiconsensusreads_torch.serve.worker import (
    JobDeadlineExceeded,
    LeaseContext,
    WarmWorker,
)
from duplexumiconsensusreads_torch.telemetry import trace as telemetry
from duplexumiconsensusreads_torch.telemetry.device import (
    device_peak_flops,
    round_mfu,
)
from duplexumiconsensusreads_torch.telemetry.report import _pctl
from duplexumiconsensusreads_torch.telemetry.trace import Heartbeat, TraceRecorder

# Live daemons in THIS process, by daemon id. The lease liveness probe
# can ask the kernel whether another process's pid is alive, but an
# in-process fleet (tests, the bench's serve_fleet leg, embedded use)
# shares one pid — this registry is the equivalent probe for those:
# a lease whose owner registered here and then unwound (crash or clean
# exit both pass through run()'s finally) is reclaimable immediately.
_LIVE_LOCK = threading.Lock()
_LIVE_DAEMONS: set = set()


def _daemon_is_live(daemon_id: str) -> bool:
    with _LIVE_LOCK:
        return daemon_id in _LIVE_DAEMONS


# per-class latency sample caps: enough for honest p95s on a long-lived
# daemon without unbounded growth (oldest samples age out)
_LAT_SAMPLES_KEPT = 512

# stuck-run watchdog: with no explicit --watchdog the stall threshold
# derives from this daemon's OBSERVED chunk cadence — a run is declared
# stalled only when its current chunk has made no durable progress for
# WATCHDOG_P95_MULT x the p95 inter-commit interval (floored at
# WATCHDOG_MIN_S), and only once enough samples exist to know what
# "normal" looks like. Conservative by design: a watchdog that fires on
# a slow-but-alive chunk converts honest work into a fenced abort and a
# crash_count tick.
WATCHDOG_MIN_S = 10.0
WATCHDOG_P95_MULT = 20.0
WATCHDOG_MIN_SAMPLES = 8
_CHUNK_SAMPLES_KEPT = 256
# how often run()'s join of the workers returns to run pending signal
# handlers
JOIN_POLL_S = 0.25


class ConsensusService:
    def __init__(
        self,
        spool_dir: str,
        chunk_budget: int = 8,
        max_queue: int = 64,
        workers: int = 1,
        poll_s: float = 0.25,
        heartbeat_s: float = 0.0,
        trace_path: str | None = None,
        n_devices: int | None = None,
        device="cuda",
        device_indices: list[int] | None = None,
        lease_s: float = LEASE_DEFAULT_S,
        class_depths: dict | None = None,
        daemon_id: str | None = None,
        default_deadline_s: float = 0.0,
        watchdog_s: float | None = None,
        max_crashes: int = MAX_CRASHES_DEFAULT,
        min_free_bytes: int = DISK_LOW_WATER_BYTES,
        store: str | LeaseStore | None = None,
        build_dir: str | None = None,
    ):
        """Defensive knobs: ``default_deadline_s`` (daemon-level job
        deadline, 0 = none; a job's own ``deadline_s`` wins),
        ``watchdog_s`` (stall threshold for the stuck-run watchdog —
        None = derive from observed chunk p95, 0 = disabled),
        ``max_crashes`` (unclean aborts before a job is quarantined),
        ``min_free_bytes`` (disk low-water mark below which admission
        sheds, 0 = no probe), ``store`` (the spool's lease-store
        backend — "local"/"sharedfs"/a LeaseStore instance; None
        inherits the spool's store.json pin, defaulting to local).
        ``device``: where every slice runs (no card raises here);
        ``n_devices`` and ``device_indices``: the daemon's mesh size and
        its index subset of that device's pool (serve.daemon
        --devices), checked against the pool here;
        ``build_dir``: the kernel build directory :meth:`run` points
        the process at (None keeps ``$DUT_BUILD_DIR`` or the default)."""
        from duplexumiconsensusreads_torch.runtime.executor import resolve_device
        if workers < 1:
            raise ValueError(f"workers must be >= 1 (got {workers})")
        if poll_s <= 0:
            raise ValueError(f"poll_s must be > 0 (got {poll_s})")
        if lease_s <= 0:
            raise ValueError(f"lease_s must be > 0 (got {lease_s})")
        if watchdog_s is not None and watchdog_s < 0:
            raise ValueError(f"watchdog_s must be >= 0 (got {watchdog_s})")
        # daemons PIN the spool's backend (clients only inherit): the
        # first daemon's choice — the implicit local default included —
        # is durably recorded so a later daemon cannot diverge
        if not isinstance(store, LeaseStore):
            store = resolve_store(spool_dir, store, pin=True)
        self.store = store
        self.queue = SpoolQueue(
            spool_dir, max_queue=max_queue, max_crashes=max_crashes,
            default_deadline_s=default_deadline_s,
            min_free_bytes=min_free_bytes, store=store,
        )
        self.sched = FairScheduler(
            chunk_budget=chunk_budget, class_depths=class_depths
        )
        # the scheduler's shed policy gates admission (pure over the
        # journal, so every fleet member sheds identically)
        self.queue.admission_policy = (
            lambda jobs, spec: self.sched.shed_reason(jobs, spec.priority)
        )
        # the daemon's devices (serve.daemon --device, narrowed to an
        # index subset by --devices i,j,..): a fleet on one host can
        # partition the cards so each daemon's jobs own real devices —
        # mesh size then resolves within the subset
        from duplexumiconsensusreads_torch.parallel.mesh import run_mesh

        dev = resolve_device(device)
        self.device = str(dev)
        lanes = run_mesh(dev, n_devices, device_indices).devices
        if dev.type == "cuda":
            import torch

            self._device_kind = torch.cuda.get_device_name(lanes[0])
        else:
            self._device_kind = "cpu"
        self.build_dir = build_dir
        self.worker = WarmWorker(
            n_devices=n_devices, device=self.device, devices=device_indices
        )
        # fleet-shared tuner verdicts (tuning/store.py): auto-ladder
        # jobs consult/persist per-input-profile bucket-shape verdicts
        # through the spool, so every daemon serving this traffic mix
        # converges on the same fast shapes (and the same compiles)
        from duplexumiconsensusreads_torch.tuning.store import spool_store

        self.verdicts = spool_store(spool_dir)
        self.worker.verdict_store = self.verdicts
        self.worker.on_verdict = self._tuner_verdict_event
        self.workers = workers
        self.poll_s = poll_s
        self.heartbeat_s = heartbeat_s
        self.trace_path = trace_path
        self.lease_s = lease_s
        # fleet identity: unique per service INSTANCE (not per pid), so
        # an in-process restart is a new daemon whose predecessor's
        # leases are provably dead via the live registry
        self.daemon_id = daemon_id or (
            f"{os.getpid()}-{uuid.uuid4().hex[:8]}"
        )
        # bind the fleet identity to the lease store: backends with
        # durable heartbeat documents write the first one here, and
        # every later beat (fault site serve.hb) refreshes it — the
        # cross-host liveness evidence other daemons' reclaim sweeps
        # read under fault site serve.store
        self.store.attach(self.daemon_id, lease_s)
        # rate limiter for in-loop/on-chunk beats: first call always
        # due, then at most one per half lease
        self._hb_due_m = 0.0
        self._lock = threading.Lock()
        self._drain = threading.Event()
        self._fatal: BaseException | None = None
        self._n_running = 0
        self._t0 = time.monotonic()
        self._job_seconds: dict[str, dict] = {}
        # per-job wire-byte totals accumulated across slices (the
        # serving-side byte ledger: h2d/d2h/reads per job, snapshotted
        # into metrics.json as job_bytes with bytes_per_read derived).
        # TRAFFIC-attributed: chunks in flight at a preemption are
        # re-transferred and re-counted by the resuming slice (see
        # WarmWorker.run_slice) — these measure bytes moved, not
        # bytes committed
        self._job_bytes: dict[str, dict] = {}
        # per-priority-class latency samples: queue-wait (admission ->
        # first claim) and time-to-first-chunk (admission -> first
        # fresh chunk durable), bounded FIFO
        self._lat: dict[int, dict[str, list]] = {}
        self.watchdog_s = watchdog_s
        # observed inter-chunk-commit intervals (bounded FIFO): the
        # auto-mode watchdog threshold derives from their p95
        self._chunk_durs: list[float] = []
        self.counters = {
            "jobs_accepted": 0, "jobs_rejected": 0, "jobs_shed": 0,
            "jobs_done": 0, "jobs_failed": 0, "jobs_fenced": 0,
            "preemptions": 0, "jobs_recovered": 0,
            "jobs_expired": 0, "jobs_quarantined": 0, "watchdog_fired": 0,
            # scatter-gather sharding: parents fanned out (split) and
            # merged back by THIS daemon — any fleet member may do
            # either half of a given parent
            "jobs_split": 0, "jobs_merged": 0,
            # cumulative wire bytes across every slice this daemon
            # committed — rides the heartbeat line and metrics.json, so
            # a long-lived daemon's transfer pressure is live-readable
            "h2d_bytes": 0, "d2h_bytes": 0,
            # cumulative executed device FLOPs and device-busy seconds
            # (the device-ledger twin of the byte counters): stats()
            # derives the daemon's live MFU from these
            "device_flops": 0.0, "device_s": 0.0,
        }
        # a restarted daemon's counters must not lie about the spool it
        # serves: seed the job-outcome counters from the journal the
        # restart inherited, so metrics.json stays truthful across
        # restarts (bounded by journal compaction — results/ remains
        # the per-job record beyond it)
        self._rebuild_counters_from_journal()
        self._tr: TraceRecorder | None = None

    def _rebuild_counters_from_journal(self) -> None:
        """Seed the outcome counters from the durable journal at
        startup. Only JOURNAL-derivable counters are rebuilt (terminal
        states and admissions); event counters a restart cannot know
        (preemptions, fenced slices, takeovers, byte totals) start at
        zero, honestly."""
        by_state = {
            "done": "jobs_done", "failed": "jobs_failed",
            "expired": "jobs_expired", "quarantined": "jobs_quarantined",
        }
        for entry in self.queue.jobs.values():
            state = entry.get("state")
            if state == "rejected":
                if entry.get("shed"):
                    self.counters["jobs_shed"] += 1
                else:
                    self.counters["jobs_rejected"] += 1
                continue
            # every non-rejected journal entry passed admission
            self.counters["jobs_accepted"] += 1
            key = by_state.get(state)
            if key is not None:
                self.counters[key] += 1

    # ------------------------------------------------------------ control

    def request_drain(self) -> None:
        """Graceful shutdown: running slices yield at the next chunk
        boundary and are re-journaled as queued; :meth:`run` returns.
        Safe from signal handlers and any thread."""
        self._drain.set()

    # ------------------------------------------------------------- stats

    def stats(self) -> dict:
        with self._lock:
            # tuner verdict traffic: slices that reused a stored
            # bucket-shape verdict over all verdict resolutions (reuses
            # + fresh persists) — the counters have existed since the
            # tuner landed but never rode the live line
            v_hits = self.worker.n_verdict_hits
            v_total = v_hits + self.worker.n_verdict_puts
            snap = {
                "elapsed_s": round(time.monotonic() - self._t0, 1),
                # short-form fleet identity on every heartbeat line and
                # metrics snapshot: N daemons interleave on one stderr
                # and one spool, and an anonymous beat is unattributable
                "daemon": self.daemon_id[:12],
                "queue_depth": self.queue.queue_depth(),
                "jobs_inflight": self._n_running,
                **self.counters,
                "slices": self.worker.n_slices,
                "compile_hit_rate": round(self.worker.compile_hit_rate(), 3),
                "verdict_hit_rate": (
                    round(v_hits / v_total, 3) if v_total else 0.0
                ),
            }
            # daemon-level honest MFU: executed FLOPs over device-busy
            # seconds over the shared peak table — the serve analogue of
            # the capture's device ledger (fleet_report folds it)
            dev_s = self.counters["device_s"]
            snap["mfu"] = (
                round_mfu(
                    self.counters["device_flops"] / dev_s
                    / self._peak_flops()
                )
                if dev_s > 0 else 0.0
            )
        return snap

    def _peak_flops(self) -> float:
        """Peak FLOP/s of this daemon's device for MFU denominators,
        resolved per call (the env override may change under test)."""
        return device_peak_flops(self._device_kind)[0]

    def _note_chunk_locked(self, interval_s: float) -> None:
        """One observed inter-chunk-commit interval (caller holds the
        lock): the auto-watchdog's notion of a normal chunk."""
        self._chunk_durs.append(round(interval_s, 4))
        del self._chunk_durs[:-_CHUNK_SAMPLES_KEPT]

    def _watchdog_threshold(self) -> float | None:
        """The effective stall threshold: the explicit setting, or —
        in auto mode — WATCHDOG_P95_MULT x the observed chunk-commit
        p95 (floored at WATCHDOG_MIN_S) once enough samples exist.
        None = the watchdog must not fire (disabled, or auto mode still
        calibrating)."""
        if self.watchdog_s is not None:
            return self.watchdog_s if self.watchdog_s > 0 else None
        with self._lock:
            if len(self._chunk_durs) < WATCHDOG_MIN_SAMPLES:
                return None
            vals = sorted(self._chunk_durs)
        return max(WATCHDOG_MIN_S, WATCHDOG_P95_MULT * _pctl(vals, 0.95))

    def _note_latency_locked(self, priority: int, kind: str, value_s: float) -> None:
        samples = self._lat.setdefault(
            int(priority), {"queue_wait": [], "ttfc": []}
        )[kind]
        samples.append(round(value_s, 4))
        del samples[:-_LAT_SAMPLES_KEPT]

    def _note_bytes_locked(self, job_id: str, sb: dict) -> None:
        """Fold one slice's byte snapshot into the per-job and daemon
        cumulative totals (caller holds the lock)."""
        jb = self._job_bytes.setdefault(
            job_id, {"h2d_bytes": 0, "d2h_bytes": 0, "reads": 0,
                     "device_flops": 0.0, "device_s": 0.0}
        )
        for key in ("h2d_bytes", "d2h_bytes", "reads"):
            jb[key] += int(sb.get(key, 0) or 0)
        # device-ledger twin: FLOPs/seconds accumulate per job and per
        # daemon the same traffic-attributed way the bytes do
        for key in ("device_flops", "device_s"):
            v = float(sb.get(key, 0.0) or 0.0)
            jb[key] = round(jb.get(key, 0.0) + v, 6)
            self.counters[key] = round(self.counters[key] + v, 6)
        self.counters["h2d_bytes"] += int(sb.get("h2d_bytes", 0) or 0)
        self.counters["d2h_bytes"] += int(sb.get("d2h_bytes", 0) or 0)

    def _job_bytes_snapshot_locked(self) -> dict:
        """metrics.json's job_bytes: per-job totals plus the derived
        bytes_per_read (total wire traffic over fresh reads)."""
        out = {}
        for job_id, jb in self._job_bytes.items():
            wire = jb["h2d_bytes"] + jb["d2h_bytes"]
            dev_s = jb.get("device_s", 0.0)
            out[job_id] = {
                **jb,
                "bytes_per_read": (
                    round(wire / jb["reads"], 1) if jb["reads"] else 0.0
                ),
                # per-job honest MFU off the slices' snapshots (0.0 for
                # jobs whose slices predate the device ledger)
                "mfu": (
                    round_mfu(
                        jb.get("device_flops", 0.0) / dev_s
                        / self._peak_flops()
                    )
                    if dev_s > 0 else 0.0
                ),
            }
        return out

    def _class_latency_locked(self) -> dict:
        """Per-priority-class p50/p95 of queue-wait and time-to-first-
        chunk — the service's SLO surface, snapshotted into
        metrics.json beside the queue depth."""
        out = {}
        for pri in sorted(self._lat):
            row = {}
            for kind, key in (("queue_wait", "queue_wait"), ("ttfc", "ttfc")):
                vals = sorted(self._lat[pri][kind])
                row[f"n_{key}"] = len(vals)
                row[f"{key}_p50_s"] = round(_pctl(vals, 0.50), 4)
                row[f"{key}_p95_s"] = round(_pctl(vals, 0.95), 4)
            out[str(pri)] = row
        return out

    def _write_metrics(self, snap: dict) -> None:
        """The live snapshot file beside the journal: queue depth, jobs
        in flight, per-job phase seconds, compile-cache hit rate, and
        the per-class latency percentiles — readable by ops/`call
        --status` while the daemon runs. Fleet note: every daemon
        snapshots the same legacy path (private tmp, atomic replace —
        never torn); last writer wins and names itself in ``daemon_id``.
        Each daemon ALSO owns ``metrics/<daemon_id>.json`` — the
        per-daemon snapshot the fleet aggregator (telemetry/fleet.py,
        tools/fleet_report.py) merges, which additionally carries the
        RAW bounded latency sample FIFOs (``class_latency_samples``):
        fleet-level percentiles need the samples, because percentiles
        of percentiles are not percentiles."""
        import json

        with self._lock:
            doc = {
                **snap,
                "daemon_id": self.daemon_id,
                "lease_s": self.lease_s,
                "job_seconds": self._job_seconds,
                "job_bytes": self._job_bytes_snapshot_locked(),
                "class_latency": self._class_latency_locked(),
                "class_latency_samples": {
                    str(pri): {k: list(v) for k, v in kinds.items()}
                    for pri, kinds in self._lat.items()
                },
            }
            payload = json.dumps(doc, sort_keys=True).encode()
        path = os.path.join(self.queue.root, "metrics.json")
        mine = os.path.join(
            self.queue.root, "metrics", f"{self.daemon_id}.json"
        )
        try:
            os.makedirs(os.path.dirname(mine), exist_ok=True)
            write_durable(path, payload, tmp=unique_tmp(path))
            write_durable(mine, payload, tmp=unique_tmp(mine))
        except OSError:
            pass  # the snapshot is observability, never worth a crash

    def _beat_if_due(self) -> None:
        """Rate-limited liveness-document beat for the worker-loop and
        chunk-commit paths (the heartbeat thread, when enabled, beats
        on its own cadence through :meth:`_beat_stats`). At most one
        durable write per half lease; the first call is always due, so
        every daemon leaves at least one document. Same fault site and
        absorb policy as the heartbeat path: serve.hb, transient
        faults retried, OSError beyond the ladder tolerated (expiry
        still covers), a modelled kill re-raised to die properly."""
        now = time.monotonic()
        with self._lock:
            if now < self._hb_due_m:
                return
            self._hb_due_m = now + self.lease_s / 2.0
        try:
            _io_retry(
                "serve.hb", self.store.beat, "liveness heartbeat document"
            )
        except OSError:
            pass  # staleness backstop only; expiry still covers

    def _beat_stats(self) -> dict:
        # the heartbeat is the lease keep-alive path: every beat
        # refreshes the store's liveness document (serve.hb — the
        # cross-host evidence; journal-lock-free, so it keeps beating
        # even while a transaction waits out a wedged flock) and then
        # extends this daemon's running leases, so a paused daemon
        # (whose beats stop) expires within lease_s while a healthy
        # one can never expire between chunk commits. A dying daemon
        # (fatal set) must NOT renew — its leases should lapse so the
        # fleet takes its jobs over as fast as possible.
        if self._fatal is None:
            try:
                _io_retry(
                    "serve.hb",
                    self.store.beat,
                    "liveness heartbeat document",
                )
            except OSError:
                pass  # staleness backstop only; expiry still covers
            except BaseException as e:  # noqa: BLE001 — modelled kill
                with self._lock:
                    if self._fatal is None:
                        self._fatal = e
                self._drain.set()
                raise
        if self._fatal is None:
            try:
                _io_retry(
                    "serve.renew",
                    lambda: self.queue.renew_all(self.daemon_id, self.lease_s),
                    "heartbeat lease renewal",
                )
            except OSError:
                pass  # beyond retries: per-chunk renewal still covers
            except BaseException as e:  # noqa: BLE001 — modelled kill
                # an InjectedKill landing on the heartbeat thread must
                # take the DAEMON down, not just this thread — a
                # half-alive daemon that keeps committing after its
                # modelled death would break the kill-equals-SIGKILL
                # contract the chaos suite is phrased over
                with self._lock:
                    if self._fatal is None:
                        self._fatal = e
                self._drain.set()
                raise
        snap = self.stats()
        self._write_metrics(snap)
        return snap

    # ----------------------------------------------------------- running

    def run(self, once: bool = False) -> dict:
        """Drain the spool. ``once=True`` returns when the queue, inbox
        and all fleet work are idle (tests, the bench legs);
        ``once=False`` runs until :meth:`request_drain`. Returns the
        final stats snapshot; re-raises a fatal error (injected kill,
        journal I/O beyond retries) after the surviving workers stop."""
        from duplexumiconsensusreads_torch.utils.compile_cache import (
            enable_compile_cache,
        )

        if self.build_dir:
            enable_compile_cache(self.build_dir)
        with _LIVE_LOCK:
            _LIVE_DAEMONS.add(self.daemon_id)
        tr = None
        hooked = False
        hb = None
        wd_stop = threading.Event()
        wd = None
        try:
            if self.trace_path:
                # the meta header names this daemon: every record in
                # the capture is this daemon's testimony, and the fleet
                # stitcher (telemetry/fleet.py) attributes run slices
                # to daemons by exactly this attr. On a cross-host
                # store the meta also OVERRIDES epoch_m into the
                # spool's stamp domain (the recorder's own t0 is this
                # host's arbitrary monotonic epoch): relative ts then
                # stitch against other hosts' captures and the
                # journal's *_m stamps without any per-host offset
                meta = {"daemon_id": self.daemon_id}
                epoch = self.store.capture_epoch()
                if epoch is not None:
                    meta["epoch_m"] = round(epoch, 6)
                tr = TraceRecorder(self.trace_path, kind="service",
                                   meta=meta)
                self._tr = tr
                if telemetry.get_active() is None:
                    # the service capture doubles as the switchboard
                    # sink: fault/retry/durable events from admissions
                    # AND from untraced job slices land here
                    telemetry.install(tr)
                    hooked = True
            if self.heartbeat_s and self.heartbeat_s > 0:
                hb = Heartbeat(self.heartbeat_s, self._beat_stats, recorder=tr)
                hb.start()
            # the stuck-run watchdog: independent of the workers (a
            # wedged slice freezes them) and of the heartbeat (which
            # keeps renewing the very lease a wedged run hides behind)
            wd = threading.Thread(
                target=self._watchdog_loop, args=(wd_stop,),
                name="dut-watchdog", daemon=True,
            )
            wd.start()
            # startup sweeps: staging files orphaned by dead daemons
            # (crash litter — their pid-suffixed tmps are never reused)
            # and jobs the journal says are running under a dead
            # daemon's (or no) lease, requeued before the workers start
            # so recovery counters/events land once
            self.queue.sweep_orphan_tmps()
            with self._lock:
                self._reclaim_locked()
            threads = [
                threading.Thread(
                    target=self._worker_loop, args=(once,),
                    name=f"dut-serve_{i}", daemon=True,
                )
                for i in range(self.workers)
            ]
            for t in threads:
                t.start()
            for t in threads:
                # timed: a signal the kernel hands to another thread
                # runs its Python handler (the daemon's SIGTERM drain)
                # only when this thread next runs bytecode, which an
                # untimed join puts off until the workers end
                while t.is_alive():
                    t.join(JOIN_POLL_S)
        except BaseException as e:  # noqa: BLE001 — incl. startup kills
            # a kill during setup/startup reclaim is the same modelled
            # death as one inside a worker: record it, clean up below,
            # re-raise with durable state exactly as the kill left it
            with self._lock:
                if self._fatal is None:
                    self._fatal = e
        finally:
            # the service ends with its own threads: a beat or a
            # watchdog sweep still in flight would go on renewing
            # leases, writing the spool's metrics and hitting fault
            # sites after run() returned, into the next daemon's run
            wd_stop.set()
            if hb is not None:
                hb.stop()
                hb.join()
            if wd is not None and wd.is_alive():
                wd.join()
            snap = self._beat_stats()
            if tr is not None:
                if self._fatal is None:
                    # clean shutdown only: a fatal exit must leave a
                    # summary-less capture, the post-mortem marker
                    tr.write_summary(counters=snap)
                if hooked:
                    telemetry.uninstall()
                tr.close()
                self._tr = None
            # crash or clean exit, this daemon is dead to the fleet:
            # deregistering lets a successor reclaim its leases
            # immediately instead of waiting out the expiry
            with _LIVE_LOCK:
                _LIVE_DAEMONS.discard(self.daemon_id)
        if self._fatal is not None:
            raise self._fatal
        return snap

    def run_until_idle(self) -> dict:
        return self.run(once=True)

    # ------------------------------------------------------- worker loop

    def _accept_pending_locked(self) -> None:
        """Admit every spooled submission (caller holds the lock)."""
        tr = self._tr
        for job_id in self.queue.pending_submissions():
            spec, reason = self.queue.accept_one(job_id)
            if spec is not None:
                self.counters["jobs_accepted"] += 1
                if tr is not None:
                    tr.event(
                        "job_accepted", job=spec.job_id,
                        lane=f"job-{spec.job_id}", priority=spec.priority,
                        seq=self.queue.jobs[spec.job_id]["seq"],
                        queue_depth=self.queue.queue_depth(),
                    )
            elif reason is not None:
                entry = self.queue.jobs.get(job_id, {})
                if entry.get("shed"):
                    # admission-control rejection: valid job, no room
                    # in its class (or the global bound) — a distinct
                    # event so overload is legible in the capture
                    self.counters["jobs_shed"] += 1
                    if tr is not None:
                        tr.event(
                            "job_shed", job=job_id, lane=f"job-{job_id}",
                            reason=reason[:200],
                            priority=entry.get("priority", 1),
                        )
                else:
                    self.counters["jobs_rejected"] += 1
                    if tr is not None:
                        tr.event(
                            "job_rejected", job=job_id, lane=f"job-{job_id}",
                            reason=reason[:200],
                        )

    def _reclaim_locked(self) -> list[dict]:
        """One takeover sweep (caller holds the lock): requeue every
        running job whose lease is expired or whose owner is provably
        dead. The heartbeat-document scan rides fault site
        ``serve.store`` and the scan itself fault site ``serve.expire``
        (the persist inside reclaim_dead does too), so chaos schedules
        can target each step even on passes that reclaim nothing."""
        tr = self._tr
        hosts = _io_retry(
            "serve.store",
            self.store.observe,
            "lease-store liveness scan",
        )
        reclaimed = _io_retry(
            "serve.expire",
            lambda: self.queue.reclaim_dead(
                self.daemon_id, is_live=_daemon_is_live, hosts=hosts
            ),
            "lease reclaim sweep",
        )
        requeued = [r for r in reclaimed if not r.get("quarantined")]
        if requeued:
            self.counters["jobs_recovered"] += len(requeued)
        for r in reclaimed:
            if tr is not None:
                lane = f"job-{r['job_id']}"
                tr.event(
                    "lease_takeover", job=r["job_id"], lane=lane,
                    reason=r["reason"],
                    prev_owner=str(r["prev_owner"])[:80],
                    by=self.daemon_id,
                )
                if not r.get("quarantined"):
                    tr.event(
                        "resume", job=r["job_id"], lane=lane,
                        decision="requeued_running",
                    )
        # a reclaim that crossed max_crashes went to quarantine, not
        # back to the queue: count + record it
        self._note_reclaim_quarantines_locked(reclaimed)
        return reclaimed

    def _expire_deadlines_locked(self) -> list[dict]:
        """One deadline sweep (caller holds the lock): journal every
        queued job whose monotonic deadline has passed as terminal
        ``expired`` with a durable reason. Rides fault site
        ``serve.deadline`` every pass (like the takeover sweep), so
        chaos schedules can target the deadline step even when nothing
        expires."""
        tr = self._tr
        expired = _io_retry(
            "serve.deadline",
            self.queue.expire_deadlines,
            "deadline sweep",
        )
        if expired:
            self.counters["jobs_expired"] += len(expired)
        for r in expired:
            if tr is not None:
                tr.event(
                    "job_expired", job=r["job_id"],
                    lane=f"job-{r['job_id']}", reason=r["reason"][:200],
                )
        return expired

    def _note_reclaim_quarantines_locked(self, reclaimed: list[dict]) -> int:
        """Shared bookkeeping for takeover/watchdog reclaims whose
        crash count crossed the quarantine bound: counter + event per
        quarantined job. CALLER HOLDS the service lock (the recorder
        has its own lock and never takes this one, so recording under
        it cannot invert an ordering). Returns how many of
        ``reclaimed`` were quarantined (the rest were requeued)."""
        tr = self._tr
        n = 0
        for r in reclaimed:
            if not r.get("quarantined"):
                continue
            n += 1
            self.counters["jobs_quarantined"] += 1
            if tr is not None:
                tr.event(
                    "job_quarantined", job=r["job_id"],
                    lane=f"job-{r['job_id']}", reason=r["reason"],
                    crash_count=r.get("crash_count", 0),
                    prev_owner=str(r.get("prev_owner"))[:80],
                )
        return n

    def _advance_parents_locked(self) -> list[dict]:
        """One sharding-parent sweep (caller holds the lock): requeue
        every fanned parent whose sub-jobs all published as a merge
        task, and fail parents with a terminally-failed shard. Rides
        fault site ``serve.merge`` on every pass (like the takeover and
        deadline sweeps), so chaos schedules can target the merge
        step's scheduling edge even on passes that move nothing."""
        tr = self._tr
        moved = _io_retry(
            "serve.merge", self.queue.advance_parents, "parent sweep",
        )
        for r in moved:
            if r["decision"] == "failed":
                self.counters["jobs_failed"] += 1
                if tr is not None:
                    first = r.get("shard_failure", {})
                    tr.event(
                        "job_failed", job=r["job_id"],
                        lane=f"job-{r['job_id']}",
                        error=f"shard {first.get('shard')} "
                              f"{first.get('state')}: "
                              f"{str(first.get('error'))[:120]}",
                        shard=first.get("shard"),
                    )
            elif r["decision"] == "orphaned":
                # a requeued child of an already-terminal parent was
                # reaped instead of re-run
                self.counters["jobs_failed"] += 1
                if tr is not None:
                    tr.event(
                        "job_failed", job=r["job_id"],
                        lane=f"job-{r['job_id']}",
                        error=f"orphaned shard of terminal parent "
                              f"{r.get('parent')}",
                    )
            elif tr is not None:
                tr.event(
                    "resume", job=r["job_id"], lane=f"job-{r['job_id']}",
                    decision="requeued_merge",
                )
        return moved

    def _watchdog_sweep(self) -> list[dict]:
        """One stuck-run scan: abort-requeue every running job with no
        durable progress for the stall threshold (the lease/fence path
        does the fencing — a wedged slice that wakes later is fenced at
        its first commit). Rides fault site ``serve.watchdog`` on every
        tick, reclaim or not, so chaos can target the watchdog step."""
        tr = self._tr
        threshold = self._watchdog_threshold()
        reclaimed = _io_retry(
            "serve.watchdog",
            lambda: self.queue.reclaim_stalled(threshold),
            "watchdog stall scan",
        )
        for r in reclaimed:
            if tr is not None:
                tr.event(
                    "watchdog_fired", job=r["job_id"],
                    lane=f"job-{r['job_id']}",
                    stalled_s=r.get("stalled_s"),
                    threshold_s=floor_ms(threshold),
                    prev_owner=str(r.get("prev_owner"))[:80],
                )
        if reclaimed:
            with self._lock:
                self.counters["watchdog_fired"] += len(reclaimed)
                self._note_reclaim_quarantines_locked(reclaimed)
        return reclaimed

    def _watchdog_loop(self, stop: threading.Event) -> None:
        """The per-daemon watchdog thread. A separate thread on
        purpose: with every worker wedged inside a stuck slice the
        scheduler loop never runs again, so only an independent thread
        can notice that durable progress stopped while the heartbeat
        kept the lease alive."""
        while not stop.wait(0.25):
            try:
                self._watchdog_sweep()
            except OSError:
                continue  # beyond retries: observe again next tick
            except BaseException as e:  # noqa: BLE001 — modelled kill
                # same contract as the heartbeat thread: an injected
                # kill on the watchdog takes the daemon down whole
                with self._lock:
                    if self._fatal is None:
                        self._fatal = e
                self._drain.set()
                raise

    def _idle_done(self, once: bool) -> bool:
        if not once:
            return False
        with self._lock:
            # fleet-aware idleness: a job running under ANOTHER
            # daemon's live lease is still open work — a --once drain
            # must not declare victory (or strand a waiting takeover)
            # while the journal holds any open job
            self.queue.refresh()
            open_jobs = any(
                e.get("state") in OPEN_STATES
                for e in self.queue.jobs.values()
            )
            return (
                not open_jobs
                and self._n_running == 0
                and not self.queue.pending_submissions()
            )

    def _worker_loop(self, once: bool) -> None:
        try:
            while not self._drain.is_set():
                claimed = None
                # liveness document refresh, rate-limited (first pass
                # always due): a daemon running with the heartbeat
                # thread disabled must still leave cross-host evidence
                # it is alive, or a sharedfs peer's staleness backstop
                # would read silence as death
                self._beat_if_due()
                with self._lock:
                    self._accept_pending_locked()
                    self._reclaim_locked()
                    self._expire_deadlines_locked()
                    self._advance_parents_locked()
                    # deadline-aware pick: never claim a job the sweep
                    # (or another daemon's sweep) is about to expire —
                    # "now" on the spool's stamp clock, the domain of
                    # the entries' deadline_m
                    job_id = self.sched.pick(
                        self.queue.jobs, now=self.store.now()
                    )
                    if job_id is not None:
                        # the pick is advisory until the CLAIM commits:
                        # the flock'd transaction re-checks the state,
                        # so two daemons picking the same job resolve
                        # to exactly one lease holder. The claim rides
                        # fault site serve.lease — a transient fault is
                        # retried, a kill dies with the job still queued
                        token = _io_retry(
                            "serve.lease",
                            lambda: self.queue.claim(
                                job_id, self.daemon_id, self.lease_s
                            ),
                            f"job {job_id} lease claim",
                        )
                        if token is not None:
                            entry = self.queue.jobs[job_id]
                            # journaled spec, not a cached object: a
                            # daemon restarted onto an old journal must
                            # run exactly what admission durably recorded
                            spec = validate_spec(entry["spec"])
                            first_slice = entry["slices"] == 1
                            if first_slice and "admitted_m" in entry:
                                self._note_latency_locked(
                                    entry.get("priority", 1), "queue_wait",
                                    self.store.now() - entry["admitted_m"],
                                )
                            self._n_running += 1
                            # what the claim MEANT is in the journal:
                            # a sharding parent claims as splitting or
                            # merging, everything else as running
                            claimed = (
                                spec, first_slice, token, entry["state"]
                            )
                if claimed is None:
                    if self._idle_done(once):
                        return
                    self._drain.wait(self.poll_s)
                    continue
                try:
                    spec, first_slice, token, stage = claimed
                    if stage == "splitting":
                        self._run_split(spec, token)
                    elif stage == "merging":
                        self._run_merge(spec, token)
                    else:
                        self._run_one(spec, first_slice, token)
                finally:
                    with self._lock:
                        self._n_running -= 1
        except BaseException as e:  # noqa: BLE001 — modelled process death
            # an injected kill or a journal failure beyond the retry
            # ladder is the daemon dying: stop every worker, surface the
            # exception from run() with the journal exactly as durable
            # state left it (the recovery tests restart from there)
            with self._lock:
                if self._fatal is None:
                    self._fatal = e
            self._drain.set()

    def _tuner_verdict_event(self, job_id: str, attrs: dict) -> None:
        """The worker's on_verdict hook: ledger a bucket-ladder verdict
        decision (persisted fresh, source="run", or reused from the
        spool store, source="store") into the service capture — the
        KNOWN_EVENTS registry promises the fleet's shape decisions are
        auditable from any capture."""
        tr = self._tr
        if tr is not None:
            tr.event("tuner_verdict", job=job_id, lane=f"job-{job_id}",
                     **attrs)

    def _fenced(self, job_id: str, lane: str, detail: str,
                token: int | None = None) -> None:
        """A slice lost its lease: count it, record it, commit nothing.
        Not a failure — the reclaiming daemon owns the job and will
        produce the identical bytes. ``token`` names the STALE lease
        the zombie slice held, so the stitcher can tie the fence back
        to the slice it voids."""
        tr = self._tr
        with self._lock:
            self.counters["jobs_fenced"] += 1
        attrs = {} if token is None else {"token": token}
        if tr is not None:
            tr.event("job_fenced", job=job_id, lane=lane,
                     detail=detail[:200], **attrs)

    def _fenced_renew(self, job_id: str, token: int) -> None:
        """Fence check + lease renewal in one flock'd txn — the planner
        and merger's commit guard, THE SAME helper a consensus slice's
        per-chunk guard runs (serve.worker.fenced_renew), so the two
        stages cannot drift."""
        from duplexumiconsensusreads_torch.serve.worker import fenced_renew

        fenced_renew(
            self.queue, job_id, self.daemon_id, token, self.lease_s
        )

    def _fail_job(self, job_id: str, lane: str, e: Exception,
                  token: int) -> None:
        """Journal a job-scoped failure (fenced) — shared by the slice,
        split and merge stages. ENOSPC gets the disk-pressure grace
        pass: before journaling the failure (itself a durable write
        that needs space), drop terminal jobs' shard/checkpoint litter
        so the victim fails cleanly and the daemon lives on."""
        tr = self._tr
        enospc = isinstance(e, OSError) and e.errno == errno.ENOSPC
        if enospc:
            self.queue.gc_terminal_litter()
        try:
            with self._lock:
                self.queue.mark_failed(job_id, repr(e), self.daemon_id, token)
                self.counters["jobs_failed"] += 1
        except JobFenced as f:
            # the job died HERE but was already reclaimed: the new
            # owner decides its fate; this daemon records nothing
            self._fenced(job_id, lane, str(f), token=token)
            return
        if tr is not None:
            # token: the slice's lease identity — the stitcher pairs
            # this terminal with its job_started on the same token
            tr.event("job_failed", job=job_id, lane=lane,
                     error=repr(e)[:200], enospc=enospc, token=token)

    def _run_split(self, spec, token: int) -> None:
        """The parent's split stage: scan the input's chunk grid, plan
        K range sub-jobs, register them + move the parent to ``fanned``
        in one fenced journal transaction (fault site ``serve.split``).
        The scan runs outside any lock or transaction — only the
        registration is a journal move — and a kill anywhere re-plans
        idempotently (derived child ids dedupe)."""
        from duplexumiconsensusreads_torch.serve.job import job_params
        from duplexumiconsensusreads_torch.serve.shard.plan import (
            child_spec_dicts,
            plan_shards,
        )

        tr = self._tr
        job_id = spec.job_id
        lane = f"job-{job_id}"
        if tr is not None:
            with self._lock:
                n_slice = self.queue.jobs[job_id]["slices"]
            tr.event("job_started", job=job_id, lane=lane, slice=n_slice,
                     stage="split", token=token)
        t0 = time.monotonic()
        # the scan is pure host I/O with no chunk commits, so the
        # watchdog's durable-progress clock would run dry on a large
        # input: stamp progress (one fenced renewal) at most every
        # half lease interval while scanning — a wedged scan still
        # stops stamping and stays watchdog-visible
        last_renew = [time.monotonic()]

        def scan_progress():
            now = time.monotonic()
            if now - last_renew[0] >= self.lease_s / 2:
                last_renew[0] = now
                self._fenced_renew(job_id, token)

        try:
            _, cp, kwargs = job_params(spec)
            plan = plan_shards(
                spec.input, kwargs["chunk_reads"],
                duplex=(cp.mode == "duplex"),
                n_shards=spec.shards, shard_bytes=spec.shard_bytes,
                mate_aware=kwargs["mate_aware"],
                progress=scan_progress,
                # one parent must not swamp the fleet's open-jobs
                # bound: the fan-out is capped at the admission bound
                # the parent itself was admitted under
                max_shards=self.queue.max_queue,
            )
            dicts = child_spec_dicts(spec, plan)
            # the scan can outlive a lease renewal interval: re-arm
            # (and fence) before committing the plan
            self._fenced_renew(job_id, token)
            _io_retry(
                "serve.split",
                lambda: self.queue.register_shards(
                    job_id, self.daemon_id, token, dicts
                ),
                f"job {job_id} shard registration",
            )
        except JobFenced as e:
            self._fenced(job_id, lane, str(e), token=token)
            return
        except Exception as e:  # noqa: BLE001 — job-scoped failure
            self._fail_job(job_id, lane, e, token)
            return
        with self._lock:
            self.counters["jobs_split"] += 1
        if tr is not None:
            tr.event(
                "job_split", job=job_id, lane=lane, token=token,
                n_shards=len(dicts), n_chunks=plan.n_chunks,
                n_records=plan.n_records,
                wall_s=round(time.monotonic() - t0, 3),
            )

    def _run_merge(self, spec, token: int) -> None:
        """The parent's merge stage: splice the per-shard outputs (in
        shard order) into the final BAM, rebuild its index, publish the
        aggregate result and journal the parent done — every commit
        fenced, every durable move on fault site ``serve.merge``. Pure
        function of the shard files: a kill mid-merge re-runs it
        whole on whichever daemon claims the parent next."""
        from duplexumiconsensusreads_torch.serve.job import job_params
        from duplexumiconsensusreads_torch.serve.shard.merge import (
            splice_shards,
        )
        from duplexumiconsensusreads_torch.serve.shard.plan import (
            shard_output_path,
        )

        tr = self._tr
        job_id = spec.job_id
        lane = f"job-{job_id}"
        with self._lock:
            entry = self.queue.jobs.get(job_id, {})
            children = list(entry.get("children", ()))
            n_slice = entry.get("slices", 0)
        if tr is not None:
            tr.event("job_started", job=job_id, lane=lane, slice=n_slice,
                     stage="merge", token=token)
        t0 = time.monotonic()
        shard_paths = [
            shard_output_path(spec.output, i) for i in range(len(children))
        ]
        try:
            _, _, kwargs = job_params(spec)
            merged = splice_shards(
                spec.output, shard_paths,
                fence=lambda: self._fenced_renew(job_id, token),
                write_index=bool(kwargs["write_index"]),
            )
            result = self._aggregate_shard_results(children)
            result["output"] = os.path.abspath(spec.output)
            result["sharded"] = {
                **merged, "merge_s": round(time.monotonic() - t0, 3),
            }
            with self._lock:
                self.queue.mark_done(job_id, result, self.daemon_id, token)
                self.counters["jobs_done"] += 1
                self.counters["jobs_merged"] += 1
        except JobFenced as e:
            self._fenced(job_id, lane, str(e), token=token)
            return
        except Exception as e:  # noqa: BLE001 — job-scoped failure
            self._fail_job(job_id, lane, e, token)
            return
        wall = round(time.monotonic() - t0, 3)
        if tr is not None:
            tr.event(
                "job_merged", job=job_id, lane=lane, token=token,
                n_shards=len(shard_paths), merge_s=wall,
                output_bytes=result["sharded"]["output_bytes"],
            )
            tr.event(
                "job_completed", job=job_id, lane=lane, wall_s=wall,
                token=token,
                n_chunks=result.get("n_chunks", 0),
                n_consensus=result.get("n_consensus", 0),
                warm=False, seconds=result.get("seconds", {}),
            )
        # the published merge supersedes the intermediate shard
        # outputs: reclaim their disk now, not at the next GC pass
        for p in shard_paths:
            try:
                os.remove(p)
            except OSError:
                pass

    def _aggregate_shard_results(self, children: list[str]) -> dict:
        """The parent's result: sums of the sub-jobs' durable results —
        read from results/ (the files outlive journal compaction), so
        the rollup answers whichever daemon merges."""
        import json

        totals = {"n_chunks": 0, "n_consensus": 0, "n_records": 0,
                  "n_consensus_pairs": 0}
        for cid in children:
            path = os.path.join(self.queue.results_dir, cid + ".json")
            try:
                with open(path) as f:
                    r = json.load(f)
            except (OSError, ValueError):
                continue  # best-effort rollup; the merge bytes are the contract
            for key in totals:
                v = r.get(key)
                if isinstance(v, (int, float)):
                    totals[key] += int(v)
        return totals

    def _run_one(self, spec, first_slice: bool, token: int) -> None:
        tr = self._tr
        job_id = spec.job_id
        lane = f"job-{job_id}"
        warm = self.worker.note_job_start(spec, first_slice)
        if tr is not None:
            with self._lock:
                n_slice = self.queue.jobs[job_id]["slices"]
            lineage = {}
            if spec.shard is not None:
                # shard lineage on the wire: serve_report's parent
                # rollup and per-job lineage column read these
                lineage = {
                    "parent": spec.shard.get("parent"),
                    "shard_idx": spec.shard.get("idx"),
                }
            tr.event(
                "job_started", job=job_id, lane=lane, slice=n_slice,
                warm=warm, resumed=not first_slice, token=token,
                **lineage,
            )

        def should_yield() -> bool:
            with self._lock:
                return self.sched.others_waiting(self.queue.jobs, job_id)

        on_first_chunk = None
        with self._lock:
            entry = self.queue.jobs.get(job_id, {})
            admitted_m = entry.get("admitted_m")
            priority = entry.get("priority", 1)
            deadline_m = entry.get("deadline_m")
        if first_slice and admitted_m is not None:

            def on_first_chunk():
                with self._lock:
                    self._note_latency_locked(
                        priority, "ttfc",
                        self.store.now() - admitted_m,
                    )

        # chunk-cadence sampling: inter-commit intervals feed the
        # auto-watchdog threshold (what a "normal" chunk costs here).
        # Each commit also refreshes the liveness document (rate-
        # limited): a long slice must keep its cross-host heartbeat
        # honest even when the heartbeat thread is off.
        last_commit = [time.monotonic()]

        def on_chunk():
            now = time.monotonic()
            with self._lock:
                self._note_chunk_locked(now - last_commit[0])
            last_commit[0] = now
            self._beat_if_due()

        lease = LeaseContext(
            queue=self.queue, daemon_id=self.daemon_id, token=token,
            lease_s=self.lease_s, on_first_chunk=on_first_chunk,
            on_chunk=on_chunk, deadline_m=deadline_m,
            now_fn=self.store.now,
        )
        t0 = time.monotonic()
        try:
            out = self.worker.run_slice(
                spec, self.sched.chunk_budget, should_yield, self._drain,
                lease=lease,
            )
        except JobFenced as e:
            self._fenced(job_id, lane, str(e), token=token)
            return
        except JobDeadlineExceeded as e:
            # deadline abort at a chunk boundary: terminal `expired`
            # with a durable reason; the committed checkpoint prefix is
            # preserved byte-for-byte for a future re-submission. The
            # fenced transition rides fault site serve.deadline, like
            # the queued-side sweep.
            try:
                _io_retry(
                    "serve.deadline",
                    lambda: self.queue.mark_expired(
                        job_id, str(e), self.daemon_id, token
                    ),
                    f"job {job_id} deadline expiry",
                )
            except JobFenced as f:
                self._fenced(job_id, lane, str(f), token=token)
                return
            with self._lock:
                self.counters["jobs_expired"] += 1
            if tr is not None:
                tr.event("job_expired", job=job_id, lane=lane,
                         reason=str(e)[:200],
                         chunks_done=e.chunks_done, token=token)
            return
        except Exception as e:  # noqa: BLE001 — job-scoped failure
            self._fail_job(job_id, lane, e, token)
            return
        wall = round(time.monotonic() - t0, 3)
        if out[0] == "done":
            _, result = out
            try:
                with self._lock:
                    self.queue.mark_done(
                        job_id, result, self.daemon_id, token
                    )
                    self.counters["jobs_done"] += 1
                    self._job_seconds[job_id] = result.get("seconds", {})
                    self._note_bytes_locked(job_id, {
                        "h2d_bytes": result.get("bytes_h2d", 0),
                        "d2h_bytes": result.get("bytes_d2h", 0),
                        "reads": result.get("n_records", 0),
                        "device_flops": result.get("device_flops", 0.0),
                        "device_s": result.get("device_seconds", 0.0),
                    })
                    jb = dict(self._job_bytes.get(job_id, {}))
            except JobFenced as f:
                self._fenced(job_id, lane, str(f), token=token)
                return
            if tr is not None:
                wire = jb.get("h2d_bytes", 0) + jb.get("d2h_bytes", 0)
                tr.event(
                    "job_completed", job=job_id, lane=lane, wall_s=wall,
                    token=token,
                    n_chunks=result.get("n_chunks", 0),
                    n_consensus=result.get("n_consensus", 0),
                    warm=warm, seconds=result.get("seconds", {}),
                    # the job's whole-life byte totals (every slice,
                    # preempted ones included) — serve_report's per-job
                    # byte column reads straight off this event
                    h2d_bytes=jb.get("h2d_bytes", 0),
                    d2h_bytes=jb.get("d2h_bytes", 0),
                    bytes_per_read=(
                        round(wire / jb["reads"], 1)
                        if jb.get("reads") else 0.0
                    ),
                    # whole-life device ledger: executed FLOPs and the
                    # job's honest MFU (serve_report's mfu column)
                    device_flops=round(jb.get("device_flops", 0.0), 3),
                    mfu=(
                        round_mfu(
                            jb.get("device_flops", 0.0)
                            / jb["device_s"] / self._peak_flops()
                        )
                        if jb.get("device_s") else 0.0
                    ),
                )
        else:
            _, chunks_done, reason, slice_bytes = out
            with self._lock:
                self._note_bytes_locked(job_id, slice_bytes)

            def _requeue():
                with self._lock:
                    self.queue.requeue(
                        job_id, chunks_done, back=(reason == "budget"),
                        daemon_id=self.daemon_id, token=token,
                    )

            # serve.preempt guards the preemption commit: a transient
            # fault re-runs the idempotent requeue; an injected kill
            # leaves the job journaled "running" under this lease,
            # which takeover (expiry/dead-owner) requeues — the same
            # convergence a real crash gets
            try:
                _io_retry("serve.preempt", _requeue, f"job {job_id} requeue")
            except JobFenced as f:
                self._fenced(job_id, lane, str(f), token=token)
                return
            with self._lock:
                self.counters["preemptions"] += 1
            if tr is not None:
                tr.event(
                    "job_preempted", job=job_id, lane=lane,
                    chunks_done=chunks_done, reason=reason, wall_s=wall,
                    token=token,
                )
