"""Thread-safe span recorder for the streaming executor.

Since the drain is pipelined, per-stage busy seconds overlap each
other and the main loop, so `RunReport.seconds` can say how much work
each stage did but not WHERE the wall went: a slow run might be
ingest-bound, stalled on drain back-pressure, or serialized on one hot
drain worker, and the aggregate cannot tell them apart. This module is
the missing lens — the Dapper-lineage span model applied to the
per-chunk pipeline:

  span   one timed occurrence of a pipeline stage for one chunk, on
         one LANE (the thread that ran it: "main", "xfer-N",
         "drain-N"). The executor records the SAME (t0, dt) pair it
         adds to its busy-time phase accumulators, so summing a
         stage's spans reproduces `RunReport.seconds[stage]` exactly —
         the sum-check `tools/trace_report.py` enforces.
  event  one structured point occurrence: a fault-injection trigger,
         a retry attempt (site + attempt + backoff), a resume decision
         (shard reused vs recomputed), a durable write, a heartbeat.
  xfer   one byte-ledger transfer (telemetry/ledger.py): logical vs
         wire bytes per chunk per direction (h2d/d2h/shard), with the
         same (t, dur) pair as the stage span that moved them — the
         capture's byte accounting, sum-checked by tools/wirestat.py
         the way spans are sum-checked by tools/trace_report.py.
  dev    one device-ledger dispatch (telemetry/devledger.py): the
         bucket-class identity (capacity/cycles/buckets/method),
         executed analytic FLOPs, the dispatch's wire bytes, and the
         measured device interval — (t, dur) is the SAME pair as the
         chunk's device_wait_fetch span and ``disp_s`` the same
         seconds the dispatch phase accumulator received, so per-class
         MFU/intensity/roofline fall out of any capture and
         tools/devstat.py sum-checks the records against the phase
         totals the way wirestat sum-checks bytes.

Capture format: JSONL, one record per line, strictly in write order —
a `meta` line first, then spans/events as they complete (NOT in start
order: a span is written when it ends), and a `summary` line last on
clean shutdown (a crashed run's capture simply lacks it; the file is
still valid for post-mortem). Timestamps are seconds relative to the
recorder's monotonic epoch — wall-clock never appears, so an NTP step
cannot corrupt a capture any more than it can the phase accounting.

The recorder is BOUNDED: past ``max_events`` records it drops (and
counts) instead of growing the capture without limit — a 200M-read run
must not be able to fill the disk with its own telemetry.

Cost contract: when no recorder is installed, every hook in the hot
path is a single global load + ``None`` check (the same discipline as
``faults.fault_point``) — measured <1% on the e2e capture. When
recording, each span costs one dict build + one ``json.dumps`` + one
buffered write under a lock, per STAGE per CHUNK (not per read).
"""

from __future__ import annotations

import json
import os
import threading
import time

TRACE_VERSION = 1

# Every span stage the streaming executor records — one per step of the
# per-chunk pipeline plus the main loop's back-pressure stall. Keep in
# sync with the instrumentation in runtime/stream.py, the phase dict it
# feeds, and the "Telemetry" section of ARCHITECTURE.md.
KNOWN_STAGES = (
    "ingest",  # rolling BGZF read + native inflate + chunk parse (main)
    "bucketing",  # build_buckets on the parsed chunk (main)
    "dispatch",  # stack/pack/device_put (xfer worker; drain on retry)
    "mesh_h2d",  # per-device H2D puts of a multi-device dispatch: one
    # span per device on its "dev-N" lane, emitted from inside the
    # dispatch body (same threads as "dispatch", whose busy time
    # excludes these windows); 0 on single-device runs
    "device_wait_fetch",  # device execution wait + d2h materialise (drain)
    "scatter",  # scatter-back to batch coordinates (drain)
    "deflate",  # BGZF-compress the shard's record stream (drain)
    "shard_write",  # serialize + durable shard write, minus deflate (drain)
    "ckpt",  # per-chunk checkpoint manifest mark (main)
    "finalise",  # incremental tmp appends + terminal EOF/fsync/rename (main)
    "main_loop_stall",  # main loop blocked on drain back-pressure (main)
    "prefetch_stall",  # main loop blocked on the bounded H2D prefetch
    # window (--prefetch-depth): dispatch of chunk k+depth may not start
    # until chunk k's device results are materialised (main)
    "ingest_stall",  # overlap mode: main loop blocked waiting for the
    # ingest producer's next chunk (main) — the honest residue of
    # ingest cost the background pipeline could NOT hide behind device
    # time; 0 in forced-sync mode, where "ingest" itself is main wall
    "ingest_backpressure",  # overlap mode: the ingest producer blocked
    # on the full bounded handoff queue (ingest lane) — ingest running
    # AHEAD of the pipeline, the healthy steady state
    "live_poll",  # follow mode: tailer poll cycles against the growing
    # input — stat + incremental read + complete-block scan (accrued on
    # the consumer side at chunk boundaries from the tailer's clock)
    "live_wait",  # follow mode: ingest blocked waiting for the tailer
    # to admit more bytes — the instrument-is-slower-than-us residue,
    # distinct from ingest_stall (pipeline slower than ingest)
)

# Structured point events. Attrs are per-name (see the emitting sites);
# unknown extra attrs are legal — the validator checks names and the
# core envelope only, so new context can ride along without a schema
# bump.
KNOWN_EVENTS = (
    "fault_injected",  # runtime/faults.py: a scheduled fault fired
    "retry",  # a bounded-backoff retry attempt (site/attempt/backoff_s)
    "bucket_isolation",  # class retries exhausted -> per-bucket re-dispatch
    "resume",  # per-chunk resume decision: reused vs recomputed
    "durable_write",  # io/durable.py: a tmp+fsync+rename completed
    "heartbeat",  # periodic liveness sample (also printed to stderr)
    "truncated",  # the bounded recorder hit max_events; tail dropped
    "lock_stall",  # serve/queue.py: journal.lock not acquired within
    # the stall threshold — one event per stalled acquisition (attrs:
    # waited_s, spool), the wedged-shared-filesystem-lock alarm; the
    # acquisition itself keeps polling until lock_timeout_s, then
    # fails typed (JournalLockTimeout)
    "packed_fallback",  # wire packing downgraded a rung (pos ids past
    # u16, qual cap past the 6-bit payload, per-base tags forcing an
    # unpacked d2h, a class capacity overflowing the u16 ids lane): the
    # per-chunk packing decision the ledger records instead of a
    # mid-dispatch job failure (attrs: reason, scope)
    "tuner_verdict",  # bucket auto-tuner (tuning/): the profile pass
    # settled the run's bucket ladder (attrs: ladder, fill_factor,
    # fill_factor_off, predicted_speedup, source) — in a run capture at
    # the first profiled chunk, in a service capture when a verdict is
    # persisted/reused for a job's input profile
    "jit_compile",  # device ledger: the FIRST pipeline call of a fresh
    # dispatch class (a spec the executor had not dispatched before),
    # and every call that captured its class's step into a CUDA graph
    # on a lane (runtime/graphs.py, the counterpart of a jit compile) —
    # attrs: compile_s (the call's host seconds), mode (how lane 0 ran:
    # eager, captured or replayed), capture_s (the lanes' capture
    # seconds), cap/cycles/method (the class identity devstat groups
    # by). An eager first call pays lazy CUDA module loading, library
    # handles and caching-allocator growth; the name and fields are
    # kept so one schema reads both engines.
    "profile_written",  # --profile: the torch.profiler trace directory
    # was finalised (attrs: profile_dir) — the capture records that a
    # profiler trace exists alongside it
    # serving layer (serve/service.py): the job lifecycle in a
    # kind="service" capture. Every job_* event carries a "job" attr and
    # a "job-<id>" lane, so one capture decomposes per job the way a run
    # capture decomposes per chunk (validate_service_trace enforces it).
    "job_accepted",  # admission: inbox submission -> journaled queue
    "job_rejected",  # admission refused (invalid spec)
    "job_shed",  # admission-control rejection: class/queue bound hit
    "job_started",  # a scheduler slice began (attrs: slice, resumed)
    "job_preempted",  # chunk-boundary yield (budget or drain)
    "job_completed",  # finalise done (attrs: wall_s, per-phase seconds)
    "job_failed",  # slice raised; job journaled failed, service lives on
    # fleet lease protocol (serve/queue.py): takeover of a dead/expired
    # lease, and a zombie slice aborted by its stale fencing token
    "lease_takeover",  # running job reclaimed (attrs: reason, prev_owner)
    "job_fenced",  # slice lost its lease; committed nothing, not a failure
    # defensive serving (deadlines / watchdog / quarantine): all
    # job-scoped — they ride job-<id> lanes like every job_* event
    "job_expired",  # deadline passed: terminal, durable reason
    "job_quarantined",  # crash_count hit max_crashes: terminal + diagnosis
    "watchdog_fired",  # no durable progress for watchdog_s: abort-requeue
    # scatter-gather sharding (serve/shard/): the parent's two stage
    # completions — sub-jobs registered (attrs: n_shards, n_chunks) and
    # shard outputs spliced into the final BAM (attrs: merge_s,
    # output_bytes); the parent still gets the standard job_completed
    "job_split",  # planner fanned the parent out into K sub-jobs
    "job_merged",  # shard outputs spliced + indexed into one output
    # live follow-mode ingest (live/ + runtime/stream.py): an indexed
    # partial snapshot (valid BAM prefix + BAI) was durably published
    # at a checkpoint mark (attrs: snapshot_seq, chunks_done, reads)
    "snapshot_published",
)

# Byte-ledger directions (the third record kind, ``xfer`` — see
# telemetry/ledger.py for the record schema and the analysis). One
# registry like KNOWN_STAGES/KNOWN_EVENTS: the capture validator and
# dutlint's phase-registry rule both pin literal ``xfer("...")`` call
# sites to this tuple.
KNOWN_XFER_DIRS = (
    "h2d",  # dispatch: stacked/packed input tensors -> device
    "d2h",  # fetch: consensus output tensors -> host
    "shard",  # drain: raw record stream -> deflated durable shard
)

# Schema attrs an h2d ledger record may carry beyond the core envelope
# (logical/wire/t/dur/chunk/lane) — a registry like the dirs above, so
# dutlint's phase-registry rule pins every literal keyword at the
# emitting site and the xfer schema golden cannot drift silently:
#   bpc        the packing rung's wire bits per base/qual cycle
#   rows_real  real read rows in the dispatch (bucket fill numerator)
#   rows_pad   padded row-slots dispatched (capacity x padded buckets)
#   cap        the dispatch class's bucket capacity (its ladder rung)
#   mesh_pad   mesh-alignment pad buckets in this dispatch (slice):
#              empty buckets appended so the class's bucket count is a
#              device-count multiple — they cross the wire, so they are
#              ledgered; the per-record sums must reproduce the summary
#              counter n_mesh_pad_buckets exactly (wirestat checks)
KNOWN_H2D_XFER_ATTRS = ("bpc", "rows_real", "rows_pad", "cap", "mesh_pad")

# Schema fields a ``dev`` (device-ledger) record carries beyond the
# core envelope (type/t/dur/chunk/lane) — a registry like the h2d
# attrs above; the capture validator checks the envelope against it
# and dutlint's dev-ledger rule pins every literal keyword at the
# emitting site, so the devstat schema cannot drift silently:
#   cap       bucket capacity of the dispatch class (its ladder rung)
#   cycles    read length L of the class's bucket tensors
#   buckets   padded bucket count dispatched (mesh-pad included — pads
#             ride the wire and the GEMM, so they are in the FLOPs too)
#   method    the class's ssc kernel method (a kernels/consensus.py
#             literal; every one has a registered cost function in
#             ops/pipeline.py's SSC_METHOD_COSTS — dutlint enforces it)
#   flops     executed analytic FLOPs of the class's dispatches
#             (analytic_flops x padded bucket count, retries counted
#             like the byte ledger counts re-transfers)
#   h2d_wire  wire bytes the dispatches put on the device (the same
#             bytes the chunk's h2d xfer records ledger)
#   d2h_wire  wire bytes the materialised fetch moved back
#   disp_s    host-side dispatch busy seconds of the class's
#             dispatches — the SAME seconds phase["dispatch"] received,
#             so devstat's dispatch sum-check holds by construction
KNOWN_DEV_FIELDS = (
    "cap", "cycles", "buckets", "method", "flops", "h2d_wire",
    "d2h_wire", "disp_s",
)

# Literal lane ids/prefixes a recording site may pass as ``lane=``.
# Most lanes derive from thread names (current_lane: main / xfer-N /
# drain-N) and are never literals; the two literal families are the
# service's per-job lanes and the mesh dispatch's per-device lanes.
# dutlint's phase-registry rule pins every literal ``lane=`` argument
# (f-string prefixes included) to this registry, so a typo'd lane
# family cannot silently fork the capture schema consumers group by.
KNOWN_LANE_PREFIXES = ("main", "xfer-", "drain-", "job-", "dev-", "ingest")


def current_lane() -> str:
    """Lane id of the calling thread. The executor's pools carry
    ``dut-`` thread-name prefixes precisely so spans can self-identify:
    ``main`` / ``xfer-N`` / ``drain-N`` / ``ingest`` (the background
    producer); anything else keeps its raw thread name (still a valid
    lane)."""
    name = threading.current_thread().name
    if name == "MainThread":
        return "main"
    if name == "dut-ingest":
        return "ingest"
    for prefix, lane in (("dut-xfer_", "xfer-"), ("dut-drain_", "drain-")):
        if name.startswith(prefix):
            return lane + name[len(prefix):]
    return name


class TraceRecorder:
    """Bounded JSONL span/event recorder on one shared monotonic epoch.

    Writes through to ``path`` as records arrive (buffered file I/O —
    a crash loses at most the OS buffer, never corrupts earlier lines).
    All methods are thread-safe; the executor's drain/xfer workers and
    the heartbeat thread all write to one recorder.
    """

    def __init__(
        self, path: str, max_events: int = 1_000_000, kind: str = "run",
        meta: dict | None = None,
    ):
        """``kind`` tags the capture's meta header: "run" (a streaming
        executor capture, the default) or "service" (a serve/ daemon
        capture — job-lifecycle events instead of per-chunk spans).
        Consumers (tools/check_trace.py) key their extra checks on it;
        pre-kind captures read as "run". ``meta`` adds extra attrs to
        the meta header (the service stamps its ``daemon_id`` so a
        capture names its writer — telemetry/fleet.py keys cross-daemon
        stitching on it)."""
        if max_events < 1:
            raise ValueError(f"max_events must be >= 1 (got {max_events})")
        if kind not in ("run", "service"):
            raise ValueError(f"unknown capture kind {kind!r}")
        self.path = path
        self.kind = kind
        self.max_events = max_events
        self.n_events = 0  # admitted spans + events (meta/summary free)
        self.n_dropped = 0
        self._truncated = False
        self._sealed = False  # summary written: no records may follow it
        self._lock = threading.Lock()
        self._t0 = time.monotonic()
        # rotate, don't truncate: a capture at this path is most often
        # the PREVIOUS (possibly crashed) run's post-mortem evidence,
        # and the documented recovery flow is to rerun the same command
        # with --resume — which would otherwise destroy it here
        try:
            if os.path.getsize(path) > 0:
                os.replace(path, path + ".prev")
        except OSError:
            pass
        # service captures are LINE-buffered: a SIGKILLed daemon's
        # capture is exactly the evidence the fleet stitcher
        # (telemetry/fleet.py) post-mortems the takeover from, and at
        # block buffering a short-lived daemon's whole capture can die
        # in the 8KB userspace buffer (a real-SIGKILL drive produced a
        # 0-byte file). Event rate is per job lifecycle, so the
        # per-line write cost is noise. Run captures keep block
        # buffering (per-chunk spans at scale) — their kill story is
        # the in-process finally/close path, which flushes.
        self._f = open(path, "w", buffering=1 if kind == "service" else -1)
        # epoch_m: this recorder's epoch as a RAW machine-wide
        # CLOCK_MONOTONIC reading. Record times stay epoch-relative
        # (NTP-proof as documented above), but the epoch itself makes
        # captures from N processes on one host alignable onto one
        # timeline (epoch_m + t), which is what the fleet stitcher
        # reconstructs cross-daemon job timelines from — the same
        # one-host scope flock and the lease clock already impose on a
        # spool.
        self._line({"type": "meta", "version": TRACE_VERSION,
                    "kind": kind, "clock": "monotonic-relative",
                    "epoch_m": round(self._t0, 6), **(meta or {})})
        self._f.flush()  # the header must survive any crash

    # ------------------------------------------------------- internals

    def rel(self, t_monotonic: float) -> float:
        """Map a ``time.monotonic()`` reading onto the trace epoch."""
        return t_monotonic - self._t0

    def _line(self, rec: dict) -> None:
        self._f.write(json.dumps(rec, separators=(",", ":")) + "\n")

    def _emit(self, rec: dict) -> None:
        with self._lock:
            if self._f is None or self._sealed:
                # closed, or the terminal summary is already written (a
                # straggling heartbeat/worker): drop silently — summary
                # must stay the last record, the validator checks it
                return
            if self.n_events >= self.max_events:
                self.n_dropped += 1
                if not self._truncated:
                    self._truncated = True
                    self._line({
                        "type": "event", "name": "truncated",
                        "t": round(time.monotonic() - self._t0, 6),
                        "lane": current_lane(),
                        "max_events": self.max_events,
                    })
                return
            self.n_events += 1
            self._line(rec)

    # ------------------------------------------------------ record API

    def span(
        self,
        stage: str,
        t_start: float,
        dur: float,
        chunk: int | None = None,
        lane: str | None = None,
        **attrs,
    ) -> None:
        """Record one completed span. ``t_start`` is the raw
        ``time.monotonic()`` reading at stage start and ``dur`` the
        measured duration — pass the SAME dt the busy-time phase
        accumulator receives, so the capture's per-stage sums and
        ``RunReport.seconds`` agree by construction."""
        rec = {
            "type": "span", "stage": stage,
            "t": round(self.rel(t_start), 6), "dur": round(dur, 6),
            "lane": lane or current_lane(),
        }
        if chunk is not None:
            rec["chunk"] = int(chunk)
        if attrs:
            rec.update(attrs)
        self._emit(rec)

    def event(
        self,
        name: str,
        chunk: int | None = None,
        lane: str | None = None,
        **attrs,
    ) -> None:
        """Record one structured point event at 'now'."""
        rec = {
            "type": "event", "name": name,
            "t": round(self.rel(time.monotonic()), 6),
            "lane": lane or current_lane(),
        }
        if chunk is not None:
            rec["chunk"] = int(chunk)
        if attrs:
            rec.update(attrs)
        self._emit(rec)

    def xfer(
        self,
        direction: str,
        logical: int | None,
        wire: int,
        t_start: float,
        dur: float,
        chunk: int | None = None,
        lane: str | None = None,
        **attrs,
    ) -> None:
        """Record one byte-ledger transfer (``type == "xfer"``).

        ``logical`` is the payload before packing/deflate and ``wire``
        the bytes actually moved/stored; pass ``logical=None`` when the
        pre-wire size is unknowable (resume-reused shards). ``t_start``
        / ``dur`` are the raw monotonic reading and measured span of
        the transfer — the SAME pair the matching stage span records,
        so (bytes, dt) yields a bandwidth the time sum-check already
        vouches for."""
        rec = {
            "type": "xfer", "dir": direction,
            "t": round(self.rel(t_start), 6), "dur": round(dur, 6),
            "wire": int(wire),
            "lane": lane or current_lane(),
        }
        if logical is not None:
            rec["logical"] = int(logical)
        if chunk is not None:
            rec["chunk"] = int(chunk)
        if attrs:
            rec.update(attrs)
        self._emit(rec)

    def dev(
        self,
        t_start: float,
        dur: float,
        chunk: int | None = None,
        lane: str | None = None,
        **fields,
    ) -> None:
        """Record one device-ledger dispatch (``type == "dev"``).

        ``t_start`` / ``dur`` are the raw monotonic reading and
        measured span of the chunk's device wait + fetch for this
        dispatch class — the SAME pair the ``device_wait_fetch`` span
        records, so summing ``dur`` over a capture's dev records
        reproduces that phase total (the devstat time sum-check), and
        ``fields["disp_s"]`` likewise sums to the dispatch phase.
        ``fields`` are the KNOWN_DEV_FIELDS schema attrs."""
        rec = {
            "type": "dev",
            "t": round(self.rel(t_start), 6), "dur": round(dur, 6),
            "lane": lane or current_lane(),
        }
        if chunk is not None:
            rec["chunk"] = int(chunk)
        if fields:
            rec.update(fields)
        self._emit(rec)

    def write_summary(self, **fields) -> None:
        """Append the terminal summary record (clean shutdown only).
        The executor passes its ``RunReport.seconds`` busy totals here;
        ``tools/trace_report.py`` sum-checks span totals against them."""
        with self._lock:
            if self._f is None or self._sealed:
                return
            self._sealed = True  # nothing may be recorded after this
            self._line({
                "type": "summary",
                "t": round(time.monotonic() - self._t0, 6),
                "n_events": self.n_events,
                "n_dropped": self.n_dropped,
                **fields,
            })

    def close(self) -> None:
        """Flush and close the capture. Idempotent; safe to call from a
        ``finally`` on every exit path — a crashed run's capture simply
        ends without a summary record."""
        with self._lock:
            f, self._f = self._f, None
        if f is not None:
            f.flush()
            f.close()


# ------------------------------------------------- global hook registry
#
# faults.py, io/durable.py and the executor's module-level retry helper
# are not threaded a recorder handle; they emit through this registry.
# Mirrors the faults.py switchboard: one module-global, a single load +
# None check when tracing is off.

_active: TraceRecorder | None = None


def install(recorder: TraceRecorder | None) -> None:
    global _active
    _active = recorder


def uninstall() -> None:
    install(None)


def get_active() -> TraceRecorder | None:
    return _active


def emit_event(name: str, chunk: int | None = None, **attrs) -> None:
    """Hot-path event hook: no-op unless a recorder is installed."""
    tr = _active
    if tr is not None:
        tr.event(name, chunk=chunk, **attrs)


# ------------------------------------------------------------ heartbeat

class Heartbeat:
    """Periodic liveness line for long streaming runs.

    Every ``interval_s`` a daemon thread calls ``stats_fn`` (a cheap
    closure over the executor's live counters) and prints one
    ``[duplexumi] heartbeat`` line to stderr: chunks done/inflight,
    stall fraction, retries, drain utilization. With a recorder
    attached the same sample is also written as a ``heartbeat`` event,
    so a capture carries the run's liveness curve. The thread is a
    daemon and ``stop()`` is join-bounded: a wedged sink can never hold
    the run open.
    """

    def __init__(
        self,
        interval_s: float,
        stats_fn,
        recorder: TraceRecorder | None = None,
        sink=None,  # overridable for tests; defaults to stderr print
    ):
        if interval_s <= 0:
            raise ValueError(f"heartbeat interval must be > 0 (got {interval_s})")
        self.interval_s = interval_s
        self._stats_fn = stats_fn
        self._recorder = recorder
        self._sink = sink
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="dut-heartbeat", daemon=True
        )

    def start(self) -> "Heartbeat":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread.is_alive():
            # set() wakes the interval wait immediately, so the only
            # thing worth waiting on is an in-flight beat(); a wedged
            # sink must be bounded by ~1s, never the full interval
            self._thread.join(timeout=min(self.interval_s, 1.0))

    def join(self) -> None:
        """Wait, after :meth:`stop`, until an in-flight beat has ended:
        for an owner whose beats change shared state (the service's
        lease renewals) and so must not outlive it."""
        if self._thread.is_alive():
            self._thread.join()

    def beat(self) -> None:
        """One sample -> stderr line (+ trace event). Exposed for tests
        and for a final sample at shutdown."""
        stats = dict(self._stats_fn())
        line = "[duplexumi] heartbeat " + " ".join(
            f"{k}={v}" for k, v in stats.items()
        )
        if self._sink is not None:
            self._sink(line)
        else:
            import sys

            print(line, file=sys.stderr, flush=True)
        if self._recorder is not None:
            self._recorder.event("heartbeat", **stats)

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.beat()
            except Exception:
                # telemetry must never take down the run it observes
                pass
