"""Warm-device worker: runs job slices on the long-lived process.

The worker is why the service exists: every ``stream_call_consensus``
invocation in a fresh process pays interpreter and torch start-up, the
CUDA context, the kernel libraries' build or load, and the caching
allocator's growth before the first chunk moves. Inside the daemon all
of that is paid once: the libraries are loaded from the daemon's build
directory (utils/compile_cache.py, ``serve.daemon --build-dir``), the
context lives as long as the process, and the allocator keeps the
blocks a dispatch class needs.

Port note (the JAX package's worker, copied; what changed). This
package has no jit, so there is no compiled program to hit. The
metrics key ``compile_hit_rate`` stays (the report tools read it) and
counts what is real here: the share of jobs whose FIRST slice had a
bucket-spec signature (``serve.job.spec_signature``) that this worker
had already run to a chunk commit, i.e. jobs that started with the
kernel libraries loaded and the allocator warm for their dispatch
classes. Slices run on the daemon's devices (``device``: "cuda",
"cuda:<i>" or "cpu", narrowed by ``devices``, the daemon's --devices
index subset; a job's ``mesh`` config sizes the mesh within them),
never on a device the job names: the job spec carries none.

A SLICE is one bounded run of a job: ``stream_call_consensus`` with
``resume=True`` under the job's own checkpoint (the executor's default
``out + ".ckpt"``), preempted at a chunk boundary by raising
:class:`JobPreempted` from the executor's ``progress`` callback — which
fires on the main commit path right AFTER the chunk's checkpoint mark
is durable, so a preempted slice leaves exactly the state a resumed
slice needs and nothing else. Fault-site scoping: a job carrying a
``chaos`` schedule gets its own FaultPlan installed for its slices only
(counters live across the job's slices, not across jobs).

Thread model: this code runs on the daemon's ``dut-serve`` worker
thread — the ``serve-worker`` row of THREAD_ROLES in
``runtime/knobs.py``, which grants it all three effects (device,
durable, journal) because a slice IS a full streaming run plus its
lease bookkeeping. Job-config resolution is registry-driven too: the
defaults/choices the slices run under come from the same KNOB_TABLE
(via serve/job.py), so a knob edit lands here without touching this
file.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time

from duplexumiconsensusreads_torch.runtime import faults
from duplexumiconsensusreads_torch.serve.job import (
    JobSpec,
    job_params,
    serve_provenance,
    spec_signature,
)
from duplexumiconsensusreads_torch.serve.queue import LEASE_DEFAULT_S, SpoolQueue


class JobPreempted(Exception):
    """A slice yielded the device at a chunk boundary (budget or
    drain). Not an error: the job goes back to the queue and a later
    slice resumes from the checkpoint."""

    def __init__(self, chunks_done: int, reason: str):
        super().__init__(f"preempted after {chunks_done} chunks ({reason})")
        self.chunks_done = chunks_done
        self.reason = reason


class JobDeadlineExceeded(Exception):
    """A slice crossed its job's monotonic deadline and aborted at the
    next checkpoint boundary — the same yield point preemption uses, so
    every committed chunk stays durable and byte-identical: a
    re-submitted job RESUMES the checkpoint, it never splices. The
    service journals the job terminal ``expired`` with this message."""

    def __init__(self, chunks_done: int, overdue_s: float):
        super().__init__(
            f"expired: deadline passed {overdue_s:.3f}s ago; slice "
            f"aborted at the chunk boundary after {chunks_done} committed "
            f"chunks (checkpoint preserved for resume)"
        )
        self.chunks_done = chunks_done
        self.overdue_s = overdue_s


@dataclasses.dataclass
class LeaseContext:
    """The slice's fleet identity: which lease it runs under and how to
    keep it alive. The worker turns this into the executor's
    ``commit_guard``: before EVERY durable chunk commit the fencing
    token is verified against the journal (site ``serve.fence``) and
    the lease deadline is pushed out (site ``serve.renew``) — so a
    healthy slice can never expire mid-run, and a zombie slice aborts
    via :class:`~..serve.queue.JobFenced` before splicing a byte.
    ``on_first_chunk`` (optional) fires once, right after the job's
    first fresh chunk of its first slice is durable — the service's
    time-to-first-chunk sample. ``on_chunk`` (optional) fires on EVERY
    chunk commit — the service's chunk-cadence sample, which derives
    the watchdog's default stall threshold. ``deadline_m`` is the
    job's admission-stamped expiry (None = no deadline): the commit
    path checks it right after each chunk's mark is durable and aborts
    the slice with :class:`JobDeadlineExceeded` when passed.
    ``now_fn`` supplies "now" in the SAME clock domain ``deadline_m``
    was stamped in — the spool's lease-store clock (the service wires
    ``store.now``); None falls back to the local monotonic clock, the
    single-host domain."""

    queue: SpoolQueue
    daemon_id: str
    token: int
    lease_s: float = LEASE_DEFAULT_S
    on_first_chunk: object = None
    on_chunk: object = None
    deadline_m: float | None = None
    now_fn: object = None


def fenced_renew(queue: SpoolQueue, job_id: str, daemon_id: str,
                 token: int, lease_s: float,
                 progress: dict | None = None) -> None:
    """THE fenced-renewal guard, shared by every stage that commits
    under a lease (the per-chunk commit guard here, the service's
    split/merge stages): one flock'd transaction — renew_lease verifies
    the token first (raising JobFenced through both ladders on a
    mismatch) and pushes the lease deadline out in the same journal
    write. The two nested retry ladders keep the fence check and the
    renewal persist individually targetable by chaos schedules
    (serve.fence / serve.renew) while transient faults at either site
    are absorbed. One definition on purpose: two copies of a
    fencing-critical idiom is how the chaos coverage and the behavior
    drift apart."""
    from duplexumiconsensusreads_torch.runtime.stream import _io_retry

    _io_retry(
        "serve.fence",
        lambda: _io_retry(
            "serve.renew",
            lambda: queue.renew_lease(
                job_id, daemon_id, token, lease_s, progress=progress
            ),
            f"job {job_id} lease renewal",
        ),
        f"job {job_id} fence check",
    )


def verdict_key(spec) -> str:
    """Verdict-store key for a job spec: input identity x compile
    signature. A shard sub-job folds its range into the key — it
    profiles ITS range's group-size mix, which can legitimately differ
    per region, so sibling shards (and the whole-file job) must not
    collide on one verdict; a collision would pin a ladder tuned for a
    different region and break the store's same-key-same-value
    contract."""
    from duplexumiconsensusreads_torch import tuning

    sig = spec_signature(spec)
    if spec.shard is not None:
        sig += (
            f"|shard={spec.shard.get('chunk_base')}"
            f":{spec.shard.get('key_lo')}"
            f":{spec.shard.get('key_hi')}"
        )
    return tuning.profile_key(spec.input, sig)


def _ckpt_done_count(out_path: str) -> int:
    """Chunks already durably committed for this output (the auto
    checkpoint's ``done`` map — a gap-free prefix by the frontier
    contract). 0 when there is no usable manifest; the count only
    separates resumed commits from fresh ones for budget accounting, so
    a discarded-at-run-time manifest costing a slightly early yield is
    harmless."""
    try:
        with open(out_path + ".ckpt") as f:
            manifest = json.load(f)
        done = manifest.get("done")
        return len(done) if isinstance(done, dict) else 0
    except (OSError, ValueError):
        return 0


class WarmWorker:
    """Executes slices; owns the warm-compile bookkeeping."""

    def __init__(self, n_devices: int | None = None, device="cuda", devices=None):
        self.n_devices = n_devices
        # where this worker's slices run: the daemon's --device, and its
        # --devices index subset of that pool (None = one lane unless a
        # subset is named: parallel/mesh.py:run_mesh)
        self.device = device
        self.devices = list(devices) if devices else None
        self._lock = threading.Lock()
        self._warm_specs: set[str] = set()
        self._job_plans: dict[str, faults.FaultPlan] = {}
        self.n_spec_hits = 0
        self.n_spec_misses = 0
        self.n_slices = 0
        # tuner verdict traffic (tuning/store.py): auto-ladder slices
        # that reused a stored verdict vs fresh resolutions persisted.
        # The store rides a worker ATTRIBUTE (set by the service), not a
        # run_slice kwarg: tests and the bench wrap run_slice with
        # old-signature shims, and a new keyword would break every shim
        self.verdict_store = None
        # service-set ledger hook, callable(job_id, attrs): emits a
        # tuner_verdict event into the service capture whenever a slice
        # reuses or persists a verdict — the registry promises the
        # fleet's shape decisions are auditable from the capture. An
        # attribute for the same reason verdict_store is one.
        self.on_verdict = None
        self.n_verdict_hits = 0
        self.n_verdict_puts = 0

    def compile_hit_rate(self) -> float:
        """Share of jobs whose first slice started warm: its bucket-spec
        signature had already run to a chunk commit on this worker (the
        port's stand-in for the JAX package's jit-cache hit; see the
        module docstring)."""
        total = self.n_spec_hits + self.n_spec_misses
        return self.n_spec_hits / total if total else 0.0

    def note_job_start(self, spec: JobSpec, first_slice: bool) -> bool:
        """Record the job's bucket-spec identity; True = warm (an earlier
        slice of this daemon ran the same signature, so the kernel
        libraries are loaded and the allocator holds its classes)."""
        sig = spec_signature(spec)
        with self._lock:
            hit = sig in self._warm_specs
            if first_slice:
                if hit:
                    self.n_spec_hits += 1
                else:
                    self.n_spec_misses += 1
        return hit

    def _emit_verdict(self, job_id: str, attrs: dict) -> None:
        """Ledger a verdict decision through the service's hook (no-op
        for direct-worker callers like tests and the bench shims)."""
        hook = self.on_verdict
        if hook is not None:
            hook(job_id, attrs)

    def _note_verdict(
        self, verdicts, vkey, reused, ladder, rows_real, rows_pad,
        job_id: str = "",
    ) -> None:
        """Persist a fresh auto run's resolved ladder into the spool
        store (no-op on reuse — the stored verdict already matches by
        construction). Best-effort: a store write failure must never
        fail the job whose bytes are already durable."""
        if verdicts is None or vkey is None or reused or not ladder:
            return
        try:
            from duplexumiconsensusreads_torch import tuning

            rungs = tuning.validate_ladder(ladder)
        except ValueError:
            # a resolved single-rung "ladder" can be an off-ladder
            # capacity (non-pow2 / below MIN_RUNG) that validate_ladder
            # would refuse on reuse — persisting it would make every
            # later slice hit, fail validation, re-profile and re-put
            # the store forever; skip instead (re-profiling is cheap)
            return
        entry = {
            "ladder": [int(r) for r in rungs],
            "source": "run",
        }
        if rows_pad:
            entry["fill_factor"] = round(rows_real / rows_pad, 4)
        try:
            verdicts.put(vkey, entry)
        except OSError:
            return
        with self._lock:
            self.n_verdict_puts += 1
        self._emit_verdict(job_id, dict(entry))

    def _job_plan(self, spec: JobSpec) -> faults.FaultPlan | None:
        if not spec.chaos:
            return None
        with self._lock:
            plan = self._job_plans.get(spec.job_id)
            if plan is None:
                plan = faults.FaultPlan.parse(spec.chaos)
                self._job_plans[spec.job_id] = plan
        return plan

    def run_slice(
        self,
        spec: JobSpec,
        budget: int,
        should_yield,
        drain_event: threading.Event,
        lease: LeaseContext | None = None,
    ):
        """One slice of ``spec``. Returns ("done", report_dict) or
        ("preempted", chunks_done, reason, slice_bytes) where
        ``slice_bytes`` is {"h2d_bytes", "d2h_bytes", "reads"} as of
        the slice's last committed chunk — the byte ledger's
        serving-side view, TRAFFIC-attributed (chunks in flight at a
        preemption are re-transferred and re-counted by the resuming
        slice; see the comment at the snapshot below). The service
        accumulates it per job so metrics.json can answer
        bytes-per-read per job even across preemptions. Job errors
        propagate, and a lost lease surfaces as
        :class:`~..serve.queue.JobFenced` (a BaseException — nothing
        here may absorb it).

        ``budget`` bounds FRESH chunks this slice commits (0 = no
        bound); ``should_yield()`` is consulted before yielding so the
        budget only preempts when another job is actually waiting.
        ``lease`` (fleet mode) wires the fencing/renewal commit guard —
        see :class:`LeaseContext`."""
        from duplexumiconsensusreads_torch.runtime.stream import (
            stream_call_consensus,
        )

        gp, cp, kwargs = job_params(spec)
        # job-level mesh (config "mesh": device count, "auto" = None):
        # an explicit job mesh wins over the daemon's default count;
        # over-subscription (mesh 8 on a 2-device daemon) fails the job
        # in make_mesh's words when the slice starts. Mesh size never
        # changes job bytes, so serve_provenance excludes it.
        job_mesh = kwargs.pop("mesh", None)
        if spec.shard is not None:
            # shard sub-job (serve/shard/): run the planner's range on
            # the parent's whole-file chunk grid. The overrides ride
            # kwargs only — config (and so the @PG provenance header)
            # stays the parent's verbatim, which the merge's
            # header-identity invariant depends on.
            sh = spec.shard
            start = sh.get("start")
            kwargs["input_range"] = (
                tuple(start) if start is not None else None,
                sh.get("key_lo"), sh.get("key_hi"),
            )
            kwargs["chunk_base"] = int(sh.get("chunk_base", 0))
            kwargs["first_read"] = sh.get("first_read")
            # the planner resolved mate_aware against the parent's
            # first chunk; per-shard auto-resolution must not drift it
            kwargs["mate_aware"] = sh.get("mate_aware", kwargs["mate_aware"])
            # the merged output gets the one index; per-shard BAIs
            # would be thrown away
            kwargs["write_index"] = False
        # tuner verdict consult (self.verdict_store — tuning/store.py,
        # wired by the service): an "auto" bucket-ladder job takes the
        # spool's stored verdict for its input profile when one exists
        # (skipping the profile pass and pinning the fleet-wide shape);
        # a fresh auto resolution is persisted after the slice below.
        # Shape-only: output bytes are identical with or without a
        # verdict, which is why the override rides kwargs and never
        # touches spec.config (the @PG provenance header derives from
        # config and must not depend on tuner state).
        verdicts = self.verdict_store
        vkey = None
        verdict_reused = False
        if verdicts is not None and kwargs.get("bucket_ladder") == "auto":
            from duplexumiconsensusreads_torch import tuning

            vkey = verdict_key(spec)
            hit = verdicts.get(vkey)
            if hit and hit.get("ladder"):
                try:
                    rungs = tuning.validate_ladder(hit["ladder"])
                    if rungs[-1] != kwargs["capacity"]:
                        # a well-formed but wrong-capacity entry (hand
                        # edit, torn write that parses) would silently
                        # change the run's effective capacity — and the
                        # escape thresholds with it — while the @PG CL
                        # still claims the configured one
                        raise ValueError("verdict top rung != capacity")
                    kwargs["bucket_ladder"] = rungs
                    verdict_reused = True
                    with self._lock:
                        self.n_verdict_hits += 1
                    self._emit_verdict(spec.job_id, {
                        "ladder": [int(r) for r in kwargs["bucket_ladder"]],
                        "source": "store",
                    })
                except ValueError:
                    pass  # corrupt stored verdict: re-profile honestly
        # resolved-ladder snapshot for verdict persistence: a preempted
        # slice raises out of the executor, so the progress callback
        # mirrors the live report fields (same idiom as slice_bytes)
        ladder_seen: dict = {"ladder": None, "rows_real": 0, "rows_pad": 0}
        n_resumed = _ckpt_done_count(spec.output)
        commits = [0]
        # wire bytes this slice moved, as of its last committed chunk:
        # a preempted slice raises out of the executor, so the report
        # object is unreachable afterwards — the progress callback
        # snapshots its live counters instead. TRAFFIC-attributed, not
        # commit-attributed: at the snapshot the pipeline already
        # dispatched/fetched up to max-inflight later chunks whose
        # commits the preemption abandons, and the resuming slice
        # recomputes (re-transfers, re-counts) them — so job totals
        # measure bytes daemons actually moved for the job, counting a
        # re-transfer each time it crosses the wire, exactly like
        # retried dispatches in the run capture's byte ledger.
        # device_flops / device_s ride the same snapshot: per-job MFU
        # must survive preemption for the same traffic-attributed reason
        slice_bytes = {"h2d_bytes": 0, "d2h_bytes": 0, "reads": 0,
                       "device_flops": 0.0, "device_s": 0.0}
        # follow-mode observability: a follow job can run for hours
        # between slice boundaries, so its snapshot/emission counters
        # piggyback on the per-chunk fenced renewal instead of waiting
        # for a preemption requeue. The progress callback (post-commit,
        # chunk k) fills this; the commit guard (pre-commit, chunk k+1)
        # ships it — one chunk of lag, zero extra journal transactions
        live_progress: dict = {}
        live_run = bool(kwargs.get("follow") or kwargs.get("snapshot_chunks"))

        commit_guard = None
        if lease is not None:

            def commit_guard(_k):
                # pre-commit, on the executor main thread: the shared
                # fenced-renewal guard — one transaction per chunk
                fenced_renew(
                    lease.queue, spec.job_id, lease.daemon_id,
                    lease.token, lease.lease_s,
                    progress=dict(live_progress) if live_progress else None,
                )

        def progress(_k, _rep):
            # called on the executor's main thread inside _commit, after
            # chunk _k's checkpoint mark is durable — the one point where
            # yielding is free by the resume contract
            commits[0] += 1
            slice_bytes["h2d_bytes"] = _rep.bytes_h2d
            slice_bytes["d2h_bytes"] = _rep.bytes_d2h
            slice_bytes["reads"] = _rep.n_records
            slice_bytes["device_flops"] = _rep.device_flops
            slice_bytes["device_s"] = _rep.device_seconds
            ladder_seen["ladder"] = list(_rep.bucket_ladder)
            ladder_seen["rows_real"] = _rep.n_rows_real
            ladder_seen["rows_pad"] = _rep.n_rows_padded
            if live_run:
                live_progress["snapshot_seq"] = int(_rep.snapshot_seq)
                live_progress["reads_emitted"] = int(_rep.n_consensus)
            fresh = commits[0] - n_resumed
            if lease is not None and lease.on_chunk is not None:
                lease.on_chunk()
            if (
                fresh == 1
                and lease is not None
                and lease.on_first_chunk is not None
            ):
                lease.on_first_chunk()
            if lease is not None and lease.deadline_m is not None:
                # deadline abort rides the preemption contract: this
                # chunk's mark is already durable, nothing later is —
                # the strongest point to stop without wasting the
                # prefix or splicing a byte. "now" comes from the
                # lease's clock (the spool's stamp domain); bare
                # monotonic is only the single-host fallback
                now_fn = lease.now_fn or time.monotonic
                overdue = now_fn() - lease.deadline_m
                if overdue >= 0:
                    raise JobDeadlineExceeded(commits[0], overdue)
            if drain_event.is_set():
                raise JobPreempted(commits[0], "drain")
            if budget > 0 and fresh >= budget and should_yield():
                raise JobPreempted(commits[0], "budget")

        plan = self._job_plan(spec)
        prev_plan = faults.get_active()
        if plan is not None:
            # per-job fault-site scoping: the job's schedule is active
            # only while its slice runs; the service-level plan (chaos
            # tests, DUT_FAULTS) is restored afterwards
            faults.install(plan)
        try:
            with self._lock:
                self.n_slices += 1
            rep = stream_call_consensus(
                spec.input,
                spec.output,
                gp,
                cp,
                n_devices=job_mesh or self.n_devices,
                devices=self.devices,
                device=self.device,
                resume=True,
                progress=progress,
                commit_guard=commit_guard,
                trace_path=spec.trace,
                # canonical config-derived @PG CL: the job's bytes must
                # not depend on the daemon's argv or restart history
                provenance_cl=serve_provenance(spec.config),
                **kwargs,
            )
        except JobPreempted as p:
            # a preempted slice dispatched real work: its classes ran,
            # so later jobs of this signature start warm
            with self._lock:
                self._warm_specs.add(spec_signature(spec))
            self._note_verdict(
                verdicts, vkey, verdict_reused, ladder_seen["ladder"],
                ladder_seen["rows_real"], ladder_seen["rows_pad"],
                job_id=spec.job_id,
            )
            return ("preempted", p.chunks_done, p.reason, dict(slice_bytes))
        except JobDeadlineExceeded:
            # same warm logic: the slice ran real chunks before the
            # deadline abort; the service owns the terminal transition
            with self._lock:
                self._warm_specs.add(spec_signature(spec))
            raise
        finally:
            if plan is not None:
                faults.install(prev_plan)
        # success only: a slice that failed before dispatch (bad input
        # path, not-a-BAM) warmed nothing, and marking its signature
        # warm would inflate the compile-hit metric the bench reports
        with self._lock:
            self._warm_specs.add(spec_signature(spec))
        self._note_verdict(
            verdicts, vkey, verdict_reused, list(rep.bucket_ladder),
            rep.n_rows_real, rep.n_rows_padded,
            job_id=spec.job_id,
        )
        result = json.loads(rep.to_json())
        result["output"] = os.path.abspath(spec.output)
        return ("done", result)
