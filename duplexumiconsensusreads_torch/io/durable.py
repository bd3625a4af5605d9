"""Crash-safe write primitives shared by every persistent writer.

``os.replace`` makes a rename ATOMIC but not DURABLE: after a power cut
the directory entry may still be the old one unless the file's bytes
AND the containing directory were fsynced. Every writer whose output a
later run trusts by existence (checkpoint manifests, chunk shards, the
finalised BAM, index files) must therefore write

    tmp -> fsync(tmp) -> os.replace(tmp, dst) -> fsync(dirname(dst))

or a crash can leave a file that LOOKS complete but holds truncated or
stale bytes — exactly the failure mode the chaos suite's kill tests
pin down.

Incremental assembly (the streaming executor's pipelined finalise)
stays inside this protocol: appends go to the ``.tmp`` staging file
only, each append is made idempotent with :func:`rewrite_from` (seek +
truncate + write, so a bounded retry after a torn append cannot
duplicate bytes), and the ``os.replace`` publish still happens exactly
once, at the very end.
"""

from __future__ import annotations

import os
import threading
import time

# observability hook only (stdlib-only module, no import cycle): every
# completed durable publish is a trace event when a recorder is
# installed — fsync stalls on shared pod storage are a classic hidden
# wall cost, and the capture should name them
from duplexumiconsensusreads_torch.telemetry.trace import get_active as _trace_active


def fsync_file(f) -> None:
    """Flush + fsync an open file object (raises on real I/O failure —
    callers wrap in their bounded-retry ladders)."""
    f.flush()
    os.fsync(f.fileno())


def fsync_dir(path: str) -> None:
    """Best-effort directory fsync: makes a preceding rename durable.

    Some filesystems refuse O_RDONLY directory fsync (and on those the
    rename durability is the mount's problem) — never fail the run
    over it.
    """
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def unique_tmp(dst: str) -> str:
    """A staging name no other writer of ``dst`` can collide with.

    The default ``dst + ".tmp"`` staging name assumes ONE writer per
    destination. Fleet-shared files (checkpoint manifests, chunk
    shards, the queue journal, spool results/metrics) can be written by
    several daemons — and, inside one daemon, by several worker
    threads — at once: two writers interleaving bytes into one shared
    tmp would publish a torn file under a clean atomic rename. A
    (pid, thread) suffix keeps every in-flight staging write private;
    the rename still serializes publication (last writer wins with a
    complete file, never a spliced one)."""
    return f"{dst}.tmp.{os.getpid()}.{threading.get_ident()}"


def free_bytes(path: str) -> int | None:
    """Free disk space (bytes available to this process) on the
    filesystem holding ``path``, or None when it cannot be probed.

    The durable spool/checkpoint design leans on the disk everywhere —
    journal rewrites, shard writes, incremental finalise — so the
    serving layer's disk-pressure degradation (admission shedding below
    a low-water mark, terminal-litter GC) needs one honest probe rather
    than waiting for the first ENOSPC to land mid-commit. ``f_bavail``
    (not ``f_bfree``): what an unprivileged writer can actually use."""
    try:
        st = os.statvfs(path)
    except OSError:
        return None
    return int(st.f_bavail) * int(st.f_frsize)


def rewrite_from(f, offset: int, payload: bytes) -> None:
    """Idempotent append to a staging file: truncate back to ``offset``
    and write ``payload`` there. A transient failure mid-write can be
    retried with the same arguments without duplicating or interleaving
    bytes — the append-side twin of the tmp-write protocol."""
    f.seek(offset)
    f.truncate(offset)
    f.write(payload)


def replace_durable(tmp: str, dst: str) -> None:
    """Atomic rename + directory fsync — the publish step of the
    tmp-write protocol."""
    os.replace(tmp, dst)
    fsync_dir(os.path.dirname(os.path.abspath(dst)))


def write_durable(dst: str, payload: bytes, tmp: str | None = None) -> str:
    """The whole tmp-write protocol in one call, so no writer can
    half-apply it. ``tmp`` overrides the staging name (e.g. a
    pid-suffixed tmp when uncoordinated hosts may write the same
    path)."""
    tr = _trace_active()
    t0 = time.monotonic() if tr is not None else 0.0
    tmp = tmp or dst + ".tmp"
    with open(tmp, "wb") as f:
        f.write(payload)
        fsync_file(f)
    replace_durable(tmp, dst)
    if tr is not None:
        tr.event(
            "durable_write", path=dst, bytes=len(payload),
            dur=round(time.monotonic() - t0, 6),
        )
    return dst
