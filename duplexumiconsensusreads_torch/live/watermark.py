"""The durable admission watermark: a follow run's pinned identity.

The JAX package's live/watermark.py, copied; only the imports name
the port (the mark's JSON is the JAX package's, key for key).

The checkpoint fingerprint keys the input's ``(size, mtime)`` so a
resume refuses to splice shards computed over a different file. A
growing input changes both every poll — under the batch rule a
follower killed mid-tail could never accept its own checkpoint. The
watermark (``<out>.livemark``, the tmp-write protocol like every other
durable artifact) pins a ``stat_sig`` token at follow-run start; the
fingerprint substitutes it for the size/mtime pair, so kill/resume
mid-tail converges exactly once while two *different* follow runs
still get distinct fingerprints (the token is random per creation).

Same-input evidence on resume is the head CRC: the first 64 KiB of a
coordinate-sorted BAM (header + first reads) is already on disk when
the watermark is created and never changes as the file grows. A
mismatch means the path was reused for a different run — the mark is
discarded, the fingerprint changes, and the stale checkpoint is
rejected exactly as the batch rule would have done. FIFOs have no
re-readable head (and no re-readable anything): resuming a follow run
over a pipe is refused outright.

The mark also carries ``snapshot_seq`` so a resumed follower continues
the published-snapshot series instead of restarting it, and
``admitted_bytes`` as a progress breadcrumb for operators.

Persistence discipline: only the executor's main loop writes the mark
(watermark saves are durable moves, and the ``live-tail`` role's grant
set is empty — see THREAD_ROLES).
"""

from __future__ import annotations

import json
import os
import stat
import zlib

# head-signature window: comfortably covers the BAM header plus the
# first records for any realistic reference set, tiny to hash
_HEAD_BYTES = 64 << 10


def mark_path(out_path: str) -> str:
    return out_path + ".livemark"


def _head_crc(in_path: str) -> int:
    with open(in_path, "rb") as f:
        return zlib.crc32(f.read(_HEAD_BYTES)) & 0xFFFFFFFF


def load(out_path: str):
    """The persisted mark, or None when absent/unreadable (an
    unreadable mark is treated as no mark: the run re-pins and the
    fingerprint change invalidates any stale checkpoint)."""
    try:
        with open(mark_path(out_path), encoding="utf-8") as f:
            mark = json.load(f)
    except (OSError, ValueError):
        return None
    return mark if isinstance(mark, dict) else None


def load_or_create(out_path: str, in_path: str, resume: bool = True) -> dict:
    """The follow-run identity for this (output, input) pair.

    ``resume=True`` reuses an existing mark when it names the same
    input with the same head signature; anything else — no mark, a
    different input, a rewritten head, ``resume=False`` — pins a fresh
    ``stat_sig`` and persists it before any chunk is read.
    """
    st = os.stat(in_path)
    fifo = stat.S_ISFIFO(st.st_mode)
    head = None if fifo else _head_crc(in_path)
    abspath = os.path.abspath(in_path)
    if resume:
        mark = load(out_path)
        if mark is not None and mark.get("input") == abspath:
            if fifo:
                raise ValueError(
                    f"{in_path}: cannot resume a follow run over a FIFO "
                    f"— the consumed bytes are gone; restart with a "
                    f"fresh output path"
                )
            if mark.get("head_crc") == head:
                return mark
    mark = {
        "input": abspath,
        "head_crc": head,
        "stat_sig": os.urandom(8).hex(),
        "snapshot_seq": 0,
        "admitted_bytes": 0,
    }
    save(out_path, mark)
    return mark


def save(out_path: str, mark: dict) -> None:
    from duplexumiconsensusreads_torch.io.durable import write_durable

    write_durable(
        mark_path(out_path),
        (json.dumps(mark, sort_keys=True) + "\n").encode(),
    )


def clear(out_path: str) -> None:
    """Remove the mark (terminal finalise: the follow run is now just
    a finished output and must resume like one)."""
    try:
        os.remove(mark_path(out_path))
    except OSError:
        pass
