"""``serve.daemon`` — the long-running consensus daemon.

    python -m duplexumiconsensusreads_torch.serve.daemon SPOOL_DIR
        [--device cuda|cpu] [--devices I,] [--build-dir DIR]
        [--chunk-budget N] [--max-queue N] [--workers N] [--lease S]
        [--class-depth SPEC] [--heartbeat S] [--deadline S]
        [--watchdog S] [--max-crashes N] [--min-free-mb MB]
        [--no-trace] [--once] ...

Port note (the JAX package's ``dut-serve``, copied; what the card
changed): ``--device`` (cuda, the default, or cpu) is where every job
runs, and without a card the daemon raises at start rather than fall
back to the CPU. ``--devices`` keeps the JAX syntax and meaning: an
index list (``'0,1'``; one device is the one-element list ``'2,'``)
or a count (``'4'`` = the first four) picks this daemon's lanes, and
every job's slices run on a mesh over them (parallel/mesh.py; a job's
own ``mesh`` config narrows the count). With ``--device cpu`` the
lanes are logical lanes of the CPU. Daemons on a host with several
cards each own a disjoint set; a count past the pool or an index
outside it is refused at start in the mesh's words. ``--build-dir``
is the compile cache's counterpart: every job's kernel libraries are
built there once and loaded after (utils/compile_cache.py). SIGTERM drains as in the JAX package: each
running slice yields at its next chunk boundary, where the stream's
drain waits on its own fetches' CUDA events (never a device-wide
synchronize), so no CUDA stream holds the exit; a wedged slice is
bounded by the watchdog. After a SIGKILL the CUDA context and pinned
staging buffers die with the process, and the next daemon takes the
job over from the journal and the checkpoint alone.

Runs a :class:`~duplexumiconsensusreads_torch.serve.service.ConsensusService`
over SPOOL_DIR until SIGTERM/SIGINT, which trigger graceful drain:
every running job yields at its next chunk boundary and is re-journaled
as queued, the admission queue is already durable, and the process
exits 0. Restarting the daemon on the same spool resumes the queue and
every interrupted job (checkpoint resume skips their committed chunks).

FLEET MODE is just more daemons: start ``dut-serve SPOOL_DIR`` N times
(same host under the default ``local`` lease store; N *hosts* sharing
the spool over a shared filesystem with ``--store sharedfs``) and they
coordinate through the journal's lease/claim protocol — each job runs
under exactly one daemon's lease, a SIGKILLed daemon's jobs are taken
over (``local``: immediately when its pid is provably dead, within
``--lease`` seconds otherwise; ``sharedfs``: by translated lease
expiry or a restarted/stale heartbeat document, never by pid) and
resumed from their last durable checkpoint mark, and a zombie daemon
is fenced off by its stale token before it can splice a byte.

Submit work with ``duplexumi call IN -o OUT --submit --spool SPOOL_DIR``
and follow it with ``call --status/--wait`` (or read
``SPOOL_DIR/metrics.json`` for the live service snapshot, including
per-priority-class queue-wait / time-to-first-chunk percentiles).
"""

from __future__ import annotations

import argparse
import os
import signal
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m duplexumiconsensusreads_torch.serve.daemon",
        description="multi-job consensus service over a spool directory",
    )
    p.add_argument("spool", help="spool directory (created if missing)")
    p.add_argument(
        "--chunk-budget", type=int, default=8,
        help="fresh chunks a job may commit before yielding the device "
        "to a waiting job (0 = run each job to completion; default 8). "
        "Preemption happens at chunk boundaries, where checkpoint/resume "
        "makes the yield free",
    )
    p.add_argument(
        "--max-queue", type=int, default=64,
        help="bounded admission: open (queued+running) jobs beyond this "
        "are rejected with a journaled reason (default 64)",
    )
    p.add_argument(
        "--workers", type=int, default=1,
        help="warm worker threads draining the queue (default 1: one "
        "device, one job at a time — the scheduler owns arbitration)",
    )
    p.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="where every job of this daemon runs (default cuda; no card "
        "raises, nothing falls back to the CPU; cpu runs every kernel's "
        "plain version)",
    )
    p.add_argument(
        "--devices", default=None,
        help="this daemon's devices: a local-device INDEX list ('0,1'; a "
        "single device is the one-element list '2,') or a COUNT ('4' = the "
        "first 4 local devices). Slices of every job shard over them (a "
        "job's own 'mesh' config narrows the count), so daemons on a host "
        "with several cards each own a disjoint set. With --device cpu "
        "the devices are logical lanes of the CPU. Default: one lane "
        "(the JAX daemon takes all local devices)",
    )
    p.add_argument(
        "--build-dir", default=None, metavar="DIR",
        help="kernel build directory shared by this daemon's jobs (and by "
        "other daemons pointed at it): the first job builds the kernel "
        "libraries, later ones load them (default: $DUT_BUILD_DIR, else "
        "the package's _build/)",
    )
    p.add_argument(
        "--lease", type=float, default=None, metavar="SECONDS",
        help="job lease length for fleet coordination (default 30). "
        "Healthy daemons renew every chunk commit and every heartbeat; "
        "a daemon silent this long forfeits its running jobs to the "
        "other daemons on the spool",
    )
    p.add_argument(
        "--class-depth", default=None, metavar="SPEC",
        help="per-priority-class admission bounds as CLASS=DEPTH pairs "
        "(e.g. '0=8,1=4'): submissions over their class's queued depth "
        "are shed with a journaled reason instead of queued (classes "
        "not listed are bounded only by --max-queue)",
    )
    p.add_argument(
        "--daemon-id", default=None,
        help="fleet identity for lease ownership (default: a unique "
        "pid-derived id; override only for debugging)",
    )
    p.add_argument(
        "--store", default=None, choices=("local", "sharedfs"),
        help="lease-store backend for the spool: 'local' (flock + "
        "pid-liveness + machine monotonic clock — one host per spool) "
        "or 'sharedfs' (filesystem-calibrated shared clock + durable "
        "heartbeat documents — N hosts may share the spool; takeover "
        "by translated lease expiry, never by pid). Default: inherit "
        "the spool's store.json pin, 'local' on a fresh spool. The "
        "first daemon durably pins the choice; a later conflicting "
        "--store fails loudly",
    )
    p.add_argument(
        "--deadline", type=float, default=0.0, metavar="SECONDS",
        help="default job deadline from admission (0 = none; a job's "
        "own deadline_s wins). Overdue queued jobs journal terminal "
        "'expired'; a running job aborts at its next checkpoint "
        "boundary with the committed prefix preserved for resume",
    )
    p.add_argument(
        "--watchdog", type=float, default=None, metavar="SECONDS",
        help="stuck-run watchdog: abort-requeue a running job whose "
        "current chunk made no durable progress for this long (0 "
        "disables; default: derived from the observed chunk-commit "
        "p95 once enough chunks have been seen)",
    )
    p.add_argument(
        "--max-crashes", type=int, default=3, metavar="N",
        help="quarantine bound: a job whose runs abort uncleanly "
        "(daemon death takeover, watchdog) this many times is "
        "journaled terminal 'quarantined' with a diagnosis bundle "
        "instead of re-entering the queue (default 3)",
    )
    p.add_argument(
        "--min-free-mb", type=int, default=64, metavar="MB",
        help="disk low-water mark: shed new submissions when the spool "
        "filesystem has less than this free, after a grace GC of "
        "terminal jobs' shard/checkpoint litter (0 disables; "
        "default 64)",
    )
    p.add_argument(
        "--poll", type=float, default=0.25, metavar="SECONDS",
        help="inbox poll interval when idle (default 0.25)",
    )
    p.add_argument(
        "--heartbeat", type=float, default=10.0, metavar="SECONDS",
        help="service heartbeat period: stderr line + capture event + "
        "metrics.json snapshot (0 disables; default 10)",
    )
    p.add_argument(
        "--trace", default=None, metavar="TRACE_JSONL",
        help="service capture path (default: "
        "SPOOL/service.<daemon_id>.trace.jsonl — per-daemon on purpose: "
        "fleet members must not rotate each other's live captures, and "
        "tools/fleet_report.py stitches all of a spool's captures)",
    )
    p.add_argument(
        "--no-trace", action="store_true",
        help="disable the service capture entirely",
    )
    p.add_argument(
        "--once", action="store_true",
        help="drain until the queue, inbox and workers are idle, then "
        "exit (batch mode; the default is to serve until SIGTERM)",
    )
    return p


def parse_devices(value: str | None) -> tuple[int | None, list[int] | None]:
    """``--devices`` → (n_devices, device_indices): a bare integer
    keeps the legacy COUNT meaning; anything with a comma is an INDEX
    subset (duplicates/negatives refused), so a single-chip pin is the
    one-element list ``'2,'`` — a bare '2' cannot be both, and the
    count reading wins for compatibility (the --help text and the
    count error below both name the trailing-comma form so a mis-typed
    single index is discoverable). One helper so the CLI and tests
    cannot drift on the syntax."""
    if value is None:
        return None, None
    parts = [p.strip() for p in str(value).split(",")]
    try:
        nums = [int(p) for p in parts if p != ""]
    except ValueError:
        raise ValueError(
            f"--devices must be a count or a comma-separated index "
            f"list (got {value!r})"
        )
    if not nums:
        raise ValueError("--devices got an empty list")
    if len(parts) == 1:
        if nums[0] < 1:
            raise ValueError(
                f"--devices count must be >= 1 (got {nums[0]}; to PIN "
                f"a single device by index, use the one-element list "
                f"form '{nums[0]},')"
            )
        return nums[0], None
    if any(n < 0 for n in nums) or len(set(nums)) != len(nums):
        raise ValueError(
            f"--devices index list must be unique non-negative indices "
            f"(got {value!r})"
        )
    return None, nums


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.chunk_budget < 0:
        raise SystemExit(f"--chunk-budget must be >= 0 (got {args.chunk_budget})")
    if args.workers < 1:
        raise SystemExit(f"--workers must be >= 1 (got {args.workers})")
    if args.lease is not None and args.lease <= 0:
        raise SystemExit(f"--lease must be > 0 (got {args.lease})")
    if args.deadline < 0:
        raise SystemExit(f"--deadline must be >= 0 (got {args.deadline})")
    if args.watchdog is not None and args.watchdog < 0:
        raise SystemExit(f"--watchdog must be >= 0 (got {args.watchdog})")
    if args.max_crashes < 1:
        raise SystemExit(f"--max-crashes must be >= 1 (got {args.max_crashes})")
    if args.min_free_mb < 0:
        raise SystemExit(f"--min-free-mb must be >= 0 (got {args.min_free_mb})")
    class_depths = None
    if args.class_depth:
        from duplexumiconsensusreads_torch.serve.scheduler import (
            parse_class_depths,
        )

        try:
            class_depths = parse_class_depths(args.class_depth)
        except ValueError as e:
            raise SystemExit(f"--class-depth: {e}")
    from duplexumiconsensusreads_torch.serve.queue import LEASE_DEFAULT_S
    from duplexumiconsensusreads_torch.serve.service import ConsensusService

    try:
        n_devices, device_indices = parse_devices(args.devices)
    except ValueError as e:
        raise SystemExit(str(e))
    device = args.device
    os.makedirs(args.spool, exist_ok=True)
    try:
        service = ConsensusService(
            args.spool,
            chunk_budget=args.chunk_budget,
            max_queue=args.max_queue,
            workers=args.workers,
            poll_s=args.poll,
            heartbeat_s=args.heartbeat,
            trace_path=None if args.no_trace else args.trace,
            n_devices=n_devices,
            device=device,
            device_indices=device_indices,
            build_dir=args.build_dir,
            lease_s=(
                args.lease if args.lease is not None else LEASE_DEFAULT_S
            ),
            class_depths=class_depths,
            daemon_id=args.daemon_id,
            default_deadline_s=args.deadline,
            watchdog_s=args.watchdog,
            max_crashes=args.max_crashes,
            min_free_bytes=args.min_free_mb << 20,
            store=args.store,
        )
    except ValueError as e:
        # e.g. --store conflicting with the spool's store.json pin
        raise SystemExit(str(e))
    if service.trace_path is None and not args.no_trace:
        # the default capture path is PER-DAEMON (it needs the resolved
        # daemon id, which the service generates): a shared default
        # would have every new fleet member rotate the previous one's
        # LIVE capture to .prev — with three daemons, the rotation
        # destroys a capture. The fleet stitcher discovers every
        # service*.trace.jsonl on the spool.
        service.trace_path = os.path.join(
            args.spool, f"service.{service.daemon_id}.trace.jsonl"
        )

    def _drain(signum, _frame):
        print(
            f"[serve.daemon] signal {signum}: graceful drain — finishing "
            f"in-flight chunks, journaling the queue",
            file=sys.stderr,
            flush=True,
        )
        service.request_drain()

    signal.signal(signal.SIGTERM, _drain)
    signal.signal(signal.SIGINT, _drain)
    print(
        f"[serve.daemon] serving {os.path.abspath(args.spool)} "
        f"(device={service.device}, "
        f"workers={args.workers}, chunk_budget={args.chunk_budget}, "
        f"max_queue={args.max_queue}, lease_s={service.lease_s}, "
        f"store={service.store.kind}, "
        f"daemon_id={service.daemon_id}, pid={os.getpid()})",
        file=sys.stderr,
        flush=True,
    )
    snap = service.run(once=args.once)
    print(f"[serve.daemon] drained: {snap}", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
