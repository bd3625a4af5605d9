"""Deterministic fault injection for the streaming executor.

The recovery machinery in ``stream_call_consensus`` — bounded
exponential-backoff retries, bucket-by-bucket poisoned-class isolation,
stale-manifest clearing, checkpoint resume — exists because device
flakes, transient I/O errors, ENOSPC, and mid-run kills are NORMAL
operating conditions for a long checkpointed run over a 200M-read BAM.
None of it is trustworthy unless it can be exercised on demand. This
module is the switchboard: named fault SITES threaded through the hot
path raise scheduled exceptions at exact, reproducible points.

Sites (see KNOWN_SITES): each names one step of the write/recover
spine. A site is hit by calling :func:`fault_point` with its name; with
no plan installed that is a single global load + None check — zero
hot-path cost.

Schedules are comma-separated ``site:nth:kind`` entries — the Nth hit
of ``site`` (1-based, counted per run) raises the exception ``kind``
maps to:

  ``oserror`` / ``io``   InjectedFault (an OSError, errno EIO): the
                         transient-failure shape every bounded-retry
                         path in the executor must absorb
  ``enospc``             InjectedFault with errno ENOSPC
  ``kill``               InjectedKill — a BaseException that models a
                         hard process kill: it must sail through every
                         ``except Exception``/``except OSError`` ladder
                         so on-disk state is exactly what a real
                         SIGKILL would leave behind

``seed:<seed>:<n>`` expands to ``n`` pseudo-random transient entries
drawn from ``random.Random(seed)`` — the same seed always produces the
same schedule, so every chaos run is replayable bit-for-bit.

Activation: ``FaultPlan.parse``/``FaultPlan.seeded`` + :func:`install`
programmatically (tests), the ``DUT_FAULTS`` env var (picked up by
``stream_call_consensus`` via :func:`install_from_env`, with fresh hit
counters per run), or the CLI's ``call --chaos SPEC`` flag.
"""

from __future__ import annotations

import errno
import os
import random
import threading

# One site per step of the streaming write/recover spine. Keep names in
# sync with the instrumentation in runtime/stream.py + runtime/executor.py
# and the "Failure model & recovery" section of ARCHITECTURE.md.
KNOWN_SITES = (
    "ingest.read",  # file read feeding the rolling BGZF buffer
    "bgzf.inflate",  # block-batch decompression (native or Python)
    "ingest.queue",  # producer->consumer handoff of a prepped chunk
    # (overlap mode's bounded queue put, on the dut-ingest thread):
    # transients ride the standard bounded-retry ladder on the producer;
    # kills forward to the main loop through the queue's error sentinel
    # and surface exactly like a main-thread InjectedKill
    "dispatch.device_put",  # stack/pack/device dispatch (xfer worker)
    "dispatch.pack",  # host-side wire packing of the stacked chunk
    "fetch.result",  # device->host materialisation of outputs
    "fetch.unpack",  # host-side unpack of packed d2h fetch (drain worker)
    "drain.scatter",  # scatter-back of device outputs (drain worker)
    "shard.write",  # per-chunk shard serialize+deflate+durable rename
    "ckpt.save",  # checkpoint manifest persist
    "finalise.write",  # incremental finalise appends + terminal EOF/rename
    # serving layer (serve/): the admission/journal/preempt spine of the
    # multi-job service — same bounded-retry ladder, same chaos coverage
    "serve.accept",  # reading + validating a spooled job submission
    "serve.journal",  # durable admission-queue journal persist
    "serve.preempt",  # journaling a chunk-boundary preemption/requeue
    # fleet spine (N daemons on one spool): the lease state machine's
    # four durable steps — claim, renewal, expiry takeover, fence check
    "serve.lease",  # durable lease claim (queued -> running + token)
    "serve.renew",  # lease renewal (heartbeat + per-chunk commit)
    "serve.expire",  # expired/dead-owner lease reclaim (takeover)
    "serve.fence",  # fencing-token check before a durable commit
    # cross-host fleet (serve/store.py sharedfs backend): the durable
    # liveness-document write and the reclaim sweep's document scan —
    # the two I/O steps pid-free takeover stands on (both sites also
    # fire on the local backend as no-op probes, so one chaos blanket
    # covers both stores)
    "serve.hb",  # durable per-daemon heartbeat document write
    "serve.store",  # lease-store liveness scan feeding reclaim verdicts
    # defensive-serving spine: the deadline sweep/expiry commit and the
    # stuck-run watchdog's stall reclaim — both durable journal moves,
    # both chaos-targetable like every other lease-state transition
    "serve.deadline",  # deadline sweep + terminal `expired` commit
    "serve.watchdog",  # no-progress stall scan + abort-requeue commit
    # scatter-gather sharding (serve/shard/): the two durable moves of
    # the parent-job state machine — registering the planned sub-jobs
    # (splitting -> fanned) and the merge path (parent advance sweep,
    # shard splice commits, merged-output publish)
    "serve.split",  # shard-plan journal txn: children registered + fanned
    "serve.merge",  # parent advance sweep + shard splice/publish commits
    # live follow-mode ingest (live/): the tailing producer's poll cycle
    # (stat + incremental read of the growing input) and the indexed
    # partial-snapshot publish at checkpoint marks — the two I/O steps a
    # follower adds on top of the batch spine
    "live.poll",  # tail poll: stat/read of the growing input
    "live.snapshot",  # partial-snapshot publish (BAM prefix + BAI)
)

_EXC_ERRNO = {
    "oserror": errno.EIO,
    "io": errno.EIO,
    "enospc": errno.ENOSPC,
}
KNOWN_KINDS = (*_EXC_ERRNO, "kill")


class InjectedFault(OSError):
    """A scheduled transient failure — shaped as the OSError the
    production retry ladders already handle, so chaos schedules
    exercise exactly the real recovery paths."""


class InjectedKill(BaseException):
    """A scheduled hard kill. BaseException on purpose: no retry or
    isolation ladder may absorb it — the run dies with whatever disk
    state it had, exactly like SIGKILL, and only checkpoint resume may
    bring the output back."""


class FaultPlan:
    """A parsed, counter-carrying fault schedule for one run."""

    def __init__(self, entries, spec: str = ""):
        self.spec = spec
        self.schedule: dict[str, dict[int, str]] = {}
        for site, nth, kind in entries:
            if site not in KNOWN_SITES:
                raise ValueError(
                    f"unknown fault site {site!r} (known: {', '.join(KNOWN_SITES)})"
                )
            if kind not in KNOWN_KINDS:
                raise ValueError(
                    f"unknown fault kind {kind!r} (known: {', '.join(KNOWN_KINDS)})"
                )
            if nth < 1:
                raise ValueError(f"fault nth must be >= 1 (got {nth})")
            self.schedule.setdefault(site, {})[nth] = kind
        self._hits = dict.fromkeys(KNOWN_SITES, 0)
        self.n_fired = 0
        self._lock = threading.Lock()

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        """``site:nth:kind[,...]``; ``seed:<seed>:<n>`` entries expand
        to seeded pseudo-random transient faults."""
        entries = []
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            fields = part.split(":")
            if len(fields) != 3:
                raise ValueError(
                    f"bad fault entry {part!r} (want site:nth:kind or "
                    f"seed:<seed>:<n>)"
                )
            if fields[0] == "seed":
                entries.extend(cls._seed_entries(int(fields[1]), int(fields[2])))
            else:
                entries.append((fields[0], int(fields[1]), fields[2]))
        return cls(entries, spec=spec)

    @staticmethod
    def _seed_entries(seed: int, n: int, sites=KNOWN_SITES, max_nth: int = 2):
        rng = random.Random(seed)
        return [
            (rng.choice(sites), rng.randint(1, max_nth),
             rng.choice(("oserror", "enospc")))
            for _ in range(n)
        ]

    @classmethod
    def seeded(
        cls, seed: int, n_faults: int = 1, sites=KNOWN_SITES, max_nth: int = 2
    ) -> "FaultPlan":
        """Deterministic schedule from a seed — same seed, same faults."""
        return cls(
            cls._seed_entries(seed, n_faults, sites=sites, max_nth=max_nth),
            spec=f"seed:{seed}:{n_faults}",
        )

    def hit(self, site: str) -> None:
        """Count one hit of ``site``; raise if the schedule says so."""
        with self._lock:
            if site not in self._hits:
                raise ValueError(f"unknown fault site {site!r}")
            self._hits[site] += 1
            n = self._hits[site]
            # pop: each scheduled fault fires exactly once, so a retry
            # of the same step sees a clean site and can succeed
            kind = self.schedule.get(site, {}).pop(n, None)
            if kind is None:
                return
            self.n_fired += 1
        # a chaos trigger is a first-class trace event: a capture of a
        # chaos run must show the injected fault AND the retry ladder
        # it exercised as distinct records (lazy import: faults is on
        # the hot path and telemetry must stay optional)
        from duplexumiconsensusreads_torch.telemetry.trace import emit_event

        emit_event("fault_injected", site=site, hit=n, kind=kind)
        if kind == "kill":
            raise InjectedKill(f"injected kill at {site} (hit {n})")
        raise InjectedFault(
            _EXC_ERRNO[kind], f"injected {kind} at {site} (hit {n})"
        )

    def hits(self, site: str) -> int:
        with self._lock:
            return self._hits[site]


_active: FaultPlan | None = None


def install(plan: FaultPlan | None) -> None:
    global _active
    _active = plan


def uninstall() -> None:
    install(None)


def get_active() -> FaultPlan | None:
    return _active


def install_from_env() -> FaultPlan | None:
    """Install a FRESH plan from ``DUT_FAULTS`` if set (fresh counters
    per executor run, so a schedule means the same thing every run). An
    explicitly installed plan with a DIFFERENT spec (e.g. ``call
    --chaos``) wins over a stale env export; one with the SAME spec is
    refreshed. With no env var, any programmatic plan is left alone."""
    spec = os.environ.get("DUT_FAULTS")
    if spec and (_active is None or _active.spec == spec):
        try:
            install(FaultPlan.parse(spec))
        except ValueError as e:
            # name the env var: the parse error would otherwise surface
            # as a bare traceback deep inside the executor
            raise ValueError(f"DUT_FAULTS: {e}") from None
    return _active


def fault_point(site: str) -> None:
    """Hot-path hook: no-op unless a plan is installed."""
    p = _active
    if p is not None:
        p.hit(site)
