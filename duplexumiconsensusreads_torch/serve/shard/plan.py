"""Shard planner: split one streaming job into K range sub-jobs whose
outputs splice back byte-identical to the unsharded run.

The JAX package's serve/shard/plan.py, copied with the imports
rewritten: planning is host I/O on the port's reader and chunk rule,
so a plan is the JAX package's range for range.

The unsharded executor's chunk boundaries are a pure function of two
things: the sequence of raw-read END positions (record counts on the
stream — ``chunk_reads`` per read, fewer at EOF) and the pos_keys of
the records (the hold-back rule in ``_resolve_chunk_boundary``). The
consensus record NAMES embed the chunk index, so byte identity requires
a shard to reproduce the whole-file chunk grid exactly, not just cover
the right records. The planner therefore:

  1. replays the chunker's boundary rule over one sequential scan of
     the input, recording for every chunk its first record's global
     index, pos_key, decompressed offset, and the stream position its
     first raw-read buffer ends at;
  2. picks K-1 shard boundaries at eligible chunk starts (mapped keys
     only — a boundary inside the unmapped sentinel tail would make
     the key range degenerate), balanced by DECOMPRESSED input offset
     (compressed offsets quantize to ~64KB BGZF blocks, which
     degenerates the balance on small inputs);
  3. emits per shard: ``input_range`` (BGZF seek voffset + half-open
     pos_key range), ``chunk_base`` (the shard's first global chunk
     index — record names and checkpoint keys stay on the parent
     grid), and ``first_read`` (records in the shard's first raw read,
     realigning the read grid so every later boundary lands where the
     whole-file stream's would).

Because shard ranges are half-open pos_key intervals at chunk starts
and families never span pos_keys, every record — mate/overlap edge
reads included — lands in exactly one shard; the tiling is exact by
the same family-integrity argument the multihost partition uses.

``mate_aware="auto"`` resolves against the FIRST chunk of a run, which
for a shard would be the shard's own first chunk — so the planner
resolves it once against the parent's first chunk and PINS the
resolution into every sub-job, keeping grouping (and bytes) identical
to the unsharded run whatever each shard's local pairedness looks like.

Planning costs one sequential decode pass (pos_keys only — no device,
no consensus) plus one header-only BGZF block walk (``_scan_blocks``
re-reads the compressed bytes without inflating, to map the K-1
boundary offsets to seekable voffsets — BGZF has no block index, so
the walk cannot be skipped; threading the block table out of the
decode pass itself is a known follow-up). The scan reuses the
streaming reader, the block table and the chunk-boundary rule
verbatim, so planner and executor cannot drift.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from duplexumiconsensusreads_torch.io.convert import UNMAPPED_POS_KEY


# fan-out ceiling when the caller supplies no bound of its own: a
# --shard-bytes request over a jumbo input must not register thousands
# of sub-jobs in one journal txn (every journal save rewrites every
# entry, and the fleet's admission bound is phrased over open jobs)
MAX_SHARDS_DEFAULT = 256


def child_job_id(parent_id: str, idx: int) -> str:
    """Deterministic sub-job id: re-planning after a kill derives the
    same ids, so journal dedupe makes registration idempotent."""
    return f"{parent_id}.s{idx:03d}"


def shard_output_path(parent_output: str, idx: int) -> str:
    """Per-shard output path, derived (not journaled) so the planner
    and the merger agree without coordination."""
    return f"{parent_output}.shard{idx:03d}.bam"


@dataclasses.dataclass(frozen=True)
class ShardRange:
    """One sub-job's share of the parent's chunk grid."""

    idx: int
    chunk_base: int  # global index of the shard's first chunk
    n_chunks: int
    start: tuple[int, int] | None  # BGZF (coffset, uoffset) seek, or None
    key_lo: int | None  # half-open pos_key range [key_lo, key_hi)
    key_hi: int | None
    first_read: int | None  # records in the first raw read (grid realign)
    n_records: int
    approx_cbytes: int  # compressed input bytes this shard spans


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    input: str
    chunk_reads: int
    n_chunks: int
    n_records: int
    mate_aware: str  # pinned resolution: "on" | "off"
    ranges: tuple


def _chunk_grid(path: str, chunk_reads: int,
                progress=None) -> tuple[list[dict], int]:
    """Replay the streaming chunk-boundary rule: one sequential scan
    yielding, per chunk, {start (global record idx), uoff (global
    decompressed offset of its first record), key (first record's
    pos_key), first_read (records the chunk's first raw-read buffer
    holds from its start — the shard realignment count), n (records)}.
    Returns (chunks, total_records).

    ``progress`` (optional callable) fires once per raw read: the
    serving layer wires a rate-limited fenced lease renewal here so a
    long planner scan keeps stamping durable progress — without it the
    stuck-run watchdog would see a silent ``splitting`` parent and
    abort-requeue (eventually quarantine) a perfectly healthy job.
    """
    from duplexumiconsensusreads_torch.io.index import _record_offsets
    from duplexumiconsensusreads_torch.io.native_reader import region_pos_keys
    from duplexumiconsensusreads_torch.runtime.stream import (
        BamStreamReader,
        _resolve_chunk_boundary,
    )

    reader = BamStreamReader(path)
    chunks: list[dict] = []
    buf_keys = np.zeros(0, np.int64)
    buf_uoffs = np.zeros(0, np.int64)
    buf_start = 0  # global record index of buffer[0]
    recs_read = 0  # stream records consumed so far
    first_buf_end = None  # recs_read after the current buffer's 1st read
    prev_last = None
    try:
        while True:
            raw = reader.read_raw_records(chunk_reads)
            if progress is not None:
                progress()
            if raw is None:
                if len(buf_keys):
                    # EOF flush: the held-back tail (one pos_key group
                    # by the cut rule) becomes the final chunk
                    chunks.append({
                        "start": buf_start,
                        "uoff": int(buf_uoffs[0]),
                        "key": int(buf_keys[0]),
                        "first_read": (
                            (first_buf_end if first_buf_end is not None
                             else recs_read + chunk_reads) - buf_start
                        ),
                        "n": len(buf_keys),
                    })
                break
            offs = _record_offsets(raw)
            base = reader._consumed - len(raw)
            keys = region_pos_keys(np.frombuffer(raw, np.uint8), offs)
            recs_read += len(offs)
            if first_buf_end is None:
                first_buf_end = recs_read
            buf_keys = np.concatenate([buf_keys, keys])
            buf_uoffs = np.concatenate([buf_uoffs, base + offs])
            cut, prev_last = _resolve_chunk_boundary(buf_keys, prev_last)
            if cut == 0:
                continue  # whole buffer one group: keep growing
            chunks.append({
                "start": buf_start,
                "uoff": int(buf_uoffs[0]),
                "key": int(buf_keys[0]),
                "first_read": first_buf_end - buf_start,
                "n": int(cut),
            })
            buf_start += int(cut)
            buf_keys = buf_keys[cut:]
            buf_uoffs = buf_uoffs[cut:]
            first_buf_end = None
    finally:
        reader.close()
    return chunks, recs_read


def _pin_mate_aware(path: str, chunk_reads: int, duplex: bool,
                    setting: str) -> str:
    """Resolve the parent's mate_aware setting the way the unsharded
    run would — against the whole file's FIRST chunk — and pin it.
    The resolution goes through the executor's own resolver, not a
    local copy of its rule: this pin exists so shard grouping matches
    the unsharded run byte-for-byte, and a drifted duplicate of the
    auto policy would be exactly the silent divergence it prevents."""
    if setting in ("on", "off"):
        return setting
    from duplexumiconsensusreads_torch.runtime.executor import (
        resolve_mate_aware,
    )
    from duplexumiconsensusreads_torch.runtime.stream import iter_batch_chunks
    from duplexumiconsensusreads_torch.types import GroupingParams

    it = iter_batch_chunks(path, chunk_reads, duplex, warn_mixed=False)
    first = next(it, None)
    it.close()
    info = first[2] if first is not None else {}
    resolved = resolve_mate_aware(GroupingParams(), info, setting)
    return "on" if resolved.mate_aware else "off"


def plan_shards(
    path: str,
    chunk_reads: int,
    duplex: bool,
    n_shards: int | None = None,
    shard_bytes: int | None = None,
    mate_aware: str = "auto",
    progress=None,
    max_shards: int | None = None,
) -> ShardPlan:
    """Plan K range sub-jobs over ``path``'s whole-file chunk grid.

    ``n_shards`` asks for K directly; ``shard_bytes`` derives K from
    the compressed input size. Either way K is clamped to what the
    grid can legally support (eligible boundaries are chunk starts
    with mapped keys — never inside the unmapped sentinel tail — and
    there are only n_chunks of those) AND to ``max_shards`` (default
    :data:`MAX_SHARDS_DEFAULT`; the serving layer passes its own
    open-jobs bound so one parent cannot swamp the fleet's admission
    control). K=1 degenerates to one sub-job with no range at all:
    literally the unsharded invocation.
    """
    import os

    from duplexumiconsensusreads_torch.io.index import _scan_blocks

    if (n_shards is None) == (shard_bytes is None):
        raise ValueError("plan_shards needs exactly one of n_shards / "
                         "shard_bytes")
    chunks, n_records = _chunk_grid(path, chunk_reads, progress=progress)
    total_cbytes = os.path.getsize(path)
    if not chunks:
        # record-less input: one degenerate sub-job runs the plain
        # path and emits the header-only BAM; merge of 1 reassembles it
        return ShardPlan(
            input=path, chunk_reads=chunk_reads, n_chunks=0, n_records=0,
            mate_aware=_pin_mate_aware(path, chunk_reads, duplex, mate_aware),
            ranges=(ShardRange(
                idx=0, chunk_base=0, n_chunks=0, start=None, key_lo=None,
                key_hi=None, first_read=None, n_records=0,
                approx_cbytes=total_cbytes,
            ),),
        )
    if shard_bytes is not None:
        n_shards = max(-(-total_cbytes // max(shard_bytes, 1)), 1)
    # eligible interior boundaries: chunk c (c >= 1) whose start key is
    # mapped — a sentinel-key boundary would give key_lo == key_hi ==
    # UNMAPPED_POS_KEY (the whole tail shares the sentinel), an empty
    # range that loses the tail
    eligible = [
        c for c in range(1, len(chunks))
        if chunks[c]["key"] != int(UNMAPPED_POS_KEY)
    ]
    cap = max_shards if max_shards is not None else MAX_SHARDS_DEFAULT
    k = max(min(int(n_shards), len(eligible) + 1, max(cap, 1)), 1)

    # voffset mapping for the boundary chunks' first records; the walk
    # re-reads every compressed block, so it stamps progress like the
    # decode pass (the watchdog must never see a silent full-file scan)
    c_off, cum_u = _scan_blocks(path, progress=progress)

    def _voffset(uoff: int) -> tuple[int, int]:
        bi = min(
            int(np.searchsorted(cum_u, uoff, side="right")) - 1,
            len(c_off) - 1,
        )
        return int(c_off[bi]), int(uoff - cum_u[bi])

    # boundary choice balanced by DECOMPRESSED input offset: pick, for
    # each target i*total/k, the eligible boundary nearest it (strictly
    # after the previous pick). Decompressed — not compressed — offsets,
    # because BGZF blocks quantize compressed offsets to ~64KB, which
    # collapses every boundary of a small input onto one block and
    # degenerates the balance
    total_u = int(cum_u[-1])
    bounds: list[int] = []
    if k > 1:
        per = total_u / k
        prev = 0
        for i in range(1, k):
            target = i * per
            cands = [c for c in eligible if c > prev]
            if not cands:
                break
            best = min(cands, key=lambda c: abs(chunks[c]["uoff"] - target))
            bounds.append(best)
            prev = best
    starts = [0, *bounds, len(chunks)]

    ranges = []
    for i in range(len(starts) - 1):
        b, e = starts[i], starts[i + 1]
        first = chunks[b]
        co = _voffset(first["uoff"])[0] if b > 0 else 0
        co_end = (
            _voffset(chunks[e]["uoff"])[0] if e < len(chunks)
            else total_cbytes
        )
        ranges.append(ShardRange(
            idx=i,
            chunk_base=b,
            n_chunks=e - b,
            # shard 0 runs the plain no-seek path: its grid is already
            # the whole-file grid, so no realignment either
            start=_voffset(first["uoff"]) if b > 0 else None,
            key_lo=first["key"] if b > 0 else None,
            key_hi=chunks[e]["key"] if e < len(chunks) else None,
            first_read=first["first_read"] if b > 0 else None,
            n_records=sum(c["n"] for c in chunks[b:e]),
            approx_cbytes=co_end - co,
        ))
    pinned = _pin_mate_aware(path, chunk_reads, duplex, mate_aware)
    return ShardPlan(
        input=path,
        chunk_reads=chunk_reads,
        n_chunks=len(chunks),
        n_records=n_records,
        mate_aware=pinned,
        ranges=tuple(ranges),
    )


def child_spec_dicts(parent_spec, plan: ShardPlan) -> list[dict]:
    """The K sub-job spec dicts for one parent: same config (the @PG
    provenance line — and therefore the header bytes — must match the
    unsharded run's), mate_aware pinned, range/grid fields under
    ``shard``. Deterministic: a re-plan after a kill emits the same
    dicts, and journal dedupe on the derived ids does the rest."""
    out = []
    for r in plan.ranges:
        d = {
            "job_id": child_job_id(parent_spec.job_id, r.idx),
            "input": parent_spec.input,
            "output": shard_output_path(parent_spec.output, r.idx),
            "priority": parent_spec.priority,
            # the config is the PARENT's verbatim: the @PG provenance
            # line derives from it, and the shard headers must be the
            # unsharded run's header byte-for-byte. Run-time overrides
            # (pinned mate_aware, range, grid, no per-shard index) ride
            # the shard metadata, which provenance never sees.
            "config": dict(parent_spec.config),
            "shard": {
                "parent": parent_spec.job_id,
                "idx": r.idx,
                "k": len(plan.ranges),
                "chunk_base": r.chunk_base,
                "n_chunks": r.n_chunks,
                "start": list(r.start) if r.start is not None else None,
                "key_lo": r.key_lo,
                "key_hi": r.key_hi,
                "first_read": r.first_read,
                # the planner's resolution of the parent's mate_aware
                # setting against the WHOLE FILE's first chunk — pinned
                # so a shard's own first chunk can never drift grouping
                "mate_aware": plan.mate_aware,
            },
        }
        if parent_spec.deadline_s is not None:
            d["deadline_s"] = parent_spec.deadline_s
        if parent_spec.chaos is not None:
            # each sub-job is a job: the schedule installs per child
            # with its own hit counters (a poison schedule poisons
            # every shard — and the quarantine/diagnosis machinery
            # names the shard that kept dying)
            d["chaos"] = parent_spec.chaos
        if parent_spec.trace is not None:
            # per-shard capture paths: K recorders on one file would
            # interleave into garbage
            d["trace"] = f"{parent_spec.trace}.s{r.idx:03d}"
        out.append(d)
    return out
