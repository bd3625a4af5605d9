"""Shard merger: splice K per-shard BAMs into one indexed output.

The JAX package's serve/shard/merge.py, copied with the imports
rewritten: the splice is host I/O, and the merged .bai/.csi comes
from the port's io/bai.py and io/csi.py.

A finalised streaming output is exactly three byte regions, each a run
of whole BGZF members:

    [ header shell ][ per-chunk record members ... ][ BGZF EOF block ]

The incremental finalise writes the header shell as its own member(s)
(``compress_fast(serialize_bam(hdr, []), eof=False)``) and appends each
chunk's deflated record stream verbatim, so the boundary between header
and records always falls on a BGZF block boundary — which is what makes
the merge a pure compressed-byte splice: take shard 0's header shell,
append every shard's record region verbatim in shard order, terminate
with the standard EOF block. No inflate, no re-deflate, no record
parse; the merged bytes are the unsharded run's bytes because each
shard's record members ARE the unsharded run's members for its chunks
(the planner's chunk-grid alignment contract, serve/shard/plan.py).

Safety: every shard's header region must be byte-identical to shard
0's — a mismatch means config/provenance drift between sub-jobs and
the merge refuses loudly rather than publish a frankenstein output.
The splice assembles in a private staging file via the idempotent
``rewrite_from`` protocol and publishes with the one atomic
fsync+rename, so a retried (or re-claimed) merge converges; commits
ride fault site ``serve.merge`` through the executor's bounded retry
ladder, and the caller's fence hook runs between shards so a zombie
merger aborts before publishing.
"""

from __future__ import annotations

import os
import time

_COPY_BLOCK = 4 << 20

# how often the splice loop re-runs the caller's fence hook while
# copying ONE shard: the hook is a flock'd journal txn + fsync, so
# per-copy-block would hammer the spool, but a multi-GB shard copy with
# no stamp at all is exactly the uninstrumented stretch the stuck-run
# watchdog would abort-requeue (and eventually quarantine) a healthy
# merge over
_FENCE_INTERVAL_S = 5.0


def member_spans(path: str) -> tuple[int, int]:
    """(header_end, eof_start): compressed byte offsets splitting a
    finalised output into its header shell / record members / EOF
    block. Raises ValueError (path-bearing) when ``path`` is not a
    well-formed finalised output — truncated, EOF-less, or with a
    header not ending on a block boundary. Reads O(header) bytes, not
    the file: the block walk stops at the first boundary at/past the
    decompressed header length, so merging never scans a shard's
    record bytes twice."""
    from duplexumiconsensusreads_torch.io import bgzf
    from duplexumiconsensusreads_torch.io.bgzf import BGZF_EOF
    from duplexumiconsensusreads_torch.runtime.stream import BamStreamReader

    size = os.path.getsize(path)
    if size < len(BGZF_EOF):
        raise ValueError(f"{path}: too small to be a finalised BAM")
    with open(path, "rb") as f:
        f.seek(size - len(BGZF_EOF))
        if not bgzf.has_eof_block(f.read(len(BGZF_EOF))):
            raise ValueError(
                f"{path}: missing the BGZF EOF block — not a finalised "
                f"output (torn or still being written?)"
            )
    r = BamStreamReader(path)
    try:
        hlen = r._consumed  # decompressed header bytes, by the parser
    finally:
        r.close()
    # header-only block walk: accumulate per-block decompressed sizes
    # (the ISIZE trailer) until the running total reaches hlen — that
    # boundary's compressed offset is where the record members begin
    header_end = None
    c_pos = 0
    u_pos = 0
    with open(path, "rb") as f:
        while u_pos < hlen and c_pos + 28 <= size:
            f.seek(c_pos)
            head = f.read(18)
            if len(head) < 18:
                break
            bsize = bgzf.read_block_size(head, 0)
            if c_pos + bsize > size:
                break
            f.seek(c_pos + bsize - 4)
            isize = int.from_bytes(f.read(4), "little")
            c_pos += bsize
            u_pos += isize
    if u_pos == hlen:
        header_end = c_pos
    if header_end is None:
        raise ValueError(
            f"{path}: header does not end on a BGZF block boundary — "
            f"not a shard output of the incremental finalise"
        )
    return header_end, size - len(BGZF_EOF)


def splice_shards(
    out_path: str,
    shard_paths: list[str],
    fence=None,
    write_index: bool = False,
) -> dict:
    """Splice ``shard_paths`` (shard order) into ``out_path``.

    ``fence`` (optional callable) runs before each shard's copy AND
    before the publish — the serving layer passes its fenced lease
    renewal so a merger whose lease was reclaimed aborts mid-splice.
    ``write_index=True`` rebuilds the standard BAI (or CSI when a
    contig exceeds BAI's coordinate space) over the merged output,
    exactly as the unsharded run's finalise would.

    Returns {"output_bytes", "n_shards", "shard_bytes": [...]}. Pure
    function of the shard files: safe to re-run after any kill.
    """
    from duplexumiconsensusreads_torch.io.bgzf import BGZF_EOF
    from duplexumiconsensusreads_torch.io.durable import (
        fsync_file,
        replace_durable,
        rewrite_from,
        unique_tmp,
    )
    from duplexumiconsensusreads_torch.runtime.stream import _io_retry

    if not shard_paths:
        raise ValueError("splice_shards needs at least one shard output")
    spans = [
        _io_retry("serve.merge", lambda p=p: member_spans(p),
                  f"shard span scan {p}")
        for p in shard_paths
    ]
    with open(shard_paths[0], "rb") as f:
        header = f.read(spans[0][0])
    # header-identity invariant: sub-jobs share (input, config), so
    # their derived headers must agree byte-for-byte; drift means the
    # merged output could not equal the unsharded run's and the merge
    # must refuse rather than splice
    for p, (h_end, _) in zip(shard_paths[1:], spans[1:]):
        with open(p, "rb") as f:
            other = f.read(h_end)
        if other != header:
            raise ValueError(
                f"shard header mismatch: {p} does not reproduce "
                f"{shard_paths[0]}'s header — config/provenance drift "
                f"between sub-jobs; refusing to merge"
            )

    tmp = unique_tmp(out_path)
    shard_bytes = []
    published = False
    try:
        with open(tmp, "wb") as f:
            _io_retry(
                "serve.merge", lambda: rewrite_from(f, 0, header),
                "merge header write",
            )
            last_fence = [time.monotonic()]

            def _tick_fence():
                # rate-limited mid-copy fence: keeps the watchdog's
                # durable-progress clock running through a long single
                # shard without a journal txn per copy block
                if fence is None:
                    return
                now = time.monotonic()
                if now - last_fence[0] >= _FENCE_INTERVAL_S:
                    last_fence[0] = now
                    fence()

            for p, (h_end, eof_start) in zip(shard_paths, spans):
                if fence is not None:
                    fence()
                    last_fence[0] = time.monotonic()
                off = f.tell()

                def _copy(p=p, h_end=h_end, eof_start=eof_start, off=off):
                    # idempotent per-shard append: a transient failure
                    # mid-copy truncates back and re-copies this shard
                    # only
                    f.seek(off)
                    f.truncate(off)
                    with open(p, "rb") as src:
                        src.seek(h_end)
                        left = eof_start - h_end
                        while left > 0:
                            block = src.read(min(_COPY_BLOCK, left))
                            if not block:
                                raise ValueError(
                                    f"{p}: truncated while merging "
                                    f"(shard output changed underneath?)"
                                )
                            f.write(block)
                            left -= len(block)
                            _tick_fence()

                _io_retry("serve.merge", _copy, f"merge splice {p}")
                shard_bytes.append(eof_start - h_end)
            end = f.tell()

            def _seal():
                rewrite_from(f, end, BGZF_EOF)
                fsync_file(f)

            _io_retry("serve.merge", _seal, "merge EOF seal")
        if fence is not None:
            fence()
        _io_retry(
            "serve.merge", lambda: replace_durable(tmp, out_path),
            "merge publish",
        )
        published = True
    finally:
        if not published:
            # an aborted merge (failure, fence, modelled kill) must not
            # leak an output-sized staging file: the pid/tid-unique tmp
            # is never reused, so nothing but this cleanup (or the
            # terminal-litter GC's pattern sweep, for a real SIGKILL)
            # would ever reclaim it
            try:
                os.remove(tmp)
            except OSError:
                pass
    out_bytes = os.path.getsize(out_path)
    if write_index:
        if fence is not None:
            # the index rebuild is one long uninstrumented scan: reset
            # the watchdog's durable-progress clock going in (the build
            # itself is bounded by one watchdog interval — see
            # ARCHITECTURE "Job sharding")
            fence()
        _io_retry(
            "serve.merge", lambda: _build_merged_index(out_path),
            "merged index build",
        )
    return {
        "output_bytes": out_bytes,
        "n_shards": len(shard_paths),
        "shard_bytes": shard_bytes,
    }


def _build_merged_index(out_path: str) -> None:
    """The unsharded finalise's index choice, rebuilt over the merged
    output: BAI unless a header contig exceeds its 2^29 coordinate
    space, then CSI with depth sized to the contig."""
    from duplexumiconsensusreads_torch.runtime.stream import BamStreamReader

    r = BamStreamReader(out_path)
    try:
        max_len = max(r.header.ref_lengths, default=0)
    finally:
        r.close()
    if max_len > (1 << 29):
        from duplexumiconsensusreads_torch.io.csi import build_csi

        build_csi(out_path)
    else:
        from duplexumiconsensusreads_torch.io.bai import build_bai

        build_bai(out_path)
