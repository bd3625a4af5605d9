"""Whole-file orchestration: BAM in -> grouped/consensus-called -> BAM out.

The host runtime around the device pipeline, the counterpart of the JAX
package's runtime/executor.py (call_batch_tpu / call_consensus_file):

  native BAM parse (io.load_input) -> build_buckets ->
  partition_buckets (byte-rung packed H2D) -> stack_buckets -> ONE
  batched fused_pipeline call per dispatch class -> non-blocking D2H
  into pinned host buffers -> a wait on the event recorded after them
  -> scatter_bucket_outputs -> sort_consensus_outputs ->
  consensus_to_records -> write_bam (native deflate) [-> .bai/.csi].

Also the pieces the streaming executor (runtime/stream.py) shares: the
packed-D2H return path (compaction on the device, exact unpack on the
host), the per-class rung decisions and the busy-time table.

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``; with no GPU they raise instead of falling back.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np
import torch

from duplexumiconsensusreads_torch.constants import NO_FAMILY
from duplexumiconsensusreads_torch.runtime.faults import fault_point
from duplexumiconsensusreads_torch.types import (
    ConsensusParams,
    GroupingParams,
    ReadBatch,
)
from duplexumiconsensusreads_torch.utils.phred import pack_umi_words64, umi_sort_keys


@dataclasses.dataclass
class RunReport:
    """Counters + timings for one run (the CLI's --report writes this)."""

    n_records: int = 0
    n_valid_reads: int = 0
    n_dropped: int = 0
    n_buckets: int = 0
    n_families: int = 0
    n_molecules: int = 0
    n_consensus: int = 0
    n_devices: int = 1
    n_chunks: int = 0  # streaming only
    n_chunks_skipped: int = 0  # streaming resume: chunks served from shards
    n_size_classes: int = 0
    n_pipeline_compiles: int = 0  # streaming: distinct dispatch specs
    n_retries: int = 0  # streaming: re-dispatches after a failure
    n_drain_workers: int = 0  # streaming: drain worker pool size
    n_mixed_mate_families: int = 0  # see io.convert.warn_mixed_mates
    n_consensus_pairs: int = 0  # mate-aware: consensus R1+R2 pairs emitted
    # result-changing bucketing fallbacks (bucketing.FALLBACK_COUNTERS)
    n_precluster_fallback_groups: int = 0
    n_precluster_fallback_reads: int = 0
    n_jumbo_hardcut_families: int = 0
    n_jumbo_hardcut_splits: int = 0
    n_downsampled_reads: int = 0  # max_reads: io.convert.downsample_families
    # CIGAR input policy (io.convert): rescued vs dropped per strand
    n_rescued_cigar: int = 0
    n_dropped_cigar_ab: int = 0
    n_dropped_cigar_ba: int = 0
    # ref_projected: reads realigned onto reference columns vs groups
    # (and their reads) that kept the cycle layout + modal-CIGAR policy
    n_projected_reads: int = 0
    n_projection_fallback_reads: int = 0
    n_projection_fallback_groups: int = 0
    # reads whose CIGAR consumes no reference (soft-clip+insertion
    # only): projected rows stay PAD, contributing no evidence
    n_projection_unanchored_reads: int = 0
    # umi_whitelist (CorrectUmis analogue): reads whose UMI was snapped
    # to a whitelist entry / invalidated (too far or ambiguous)
    n_umi_corrected: int = 0
    n_dropped_whitelist: int = 0
    mate_aware: bool = False  # resolved mate-aware mode of this run
    # streaming: True when ingest ran as the bounded background
    # producer (scheduling only: never changes output bytes)
    ingest_overlap: bool = False
    backend: str = ""
    device: str = ""
    # bytes of device-input tensors sent and device-output tensors
    # fetched (the packed wire form where packing applies)
    bytes_h2d: int = 0
    bytes_d2h: int = 0
    # streaming device ledger: analytic FLOPs of every dispatch
    # (ops.pipeline.analytic_flops x padded bucket count; retries
    # re-count) and the device wait+fetch busy seconds they ran in
    device_flops: float = 0.0
    device_seconds: float = 0.0
    # streaming padding: real read rows dispatched vs padded row-slots
    n_rows_real: int = 0
    n_rows_padded: int = 0
    # empty buckets appended to round a class to a device multiple
    # (always 0 on one device; kept so the counters read as the JAX
    # package's)
    n_mesh_pad_buckets: int = 0
    # resolved bucket ladder of the run ([] = single-capacity): explicit
    # rungs verbatim, or the tuner verdict an auto run settled on
    bucket_ladder: list = dataclasses.field(default_factory=list)
    seconds: dict = dataclasses.field(default_factory=dict)

    def to_json(self) -> str:
        """Stable key order, seconds rounded to milliseconds."""
        d = dataclasses.asdict(self)
        d["seconds"] = {k: round(float(v), 3) for k, v in self.seconds.items()}
        d["device_flops"] = round(float(self.device_flops), 3)
        d["device_seconds"] = round(float(self.device_seconds), 3)
        return json.dumps(d, indent=2, sort_keys=True)


def write_report(rep: RunReport, path: str) -> None:
    """Write a RunReport JSON to ``path``; ``-`` means stdout."""
    text = rep.to_json() + "\n"
    if path == "-":
        import sys

        sys.stdout.write(text)
        sys.stdout.flush()
    else:
        with open(path, "w") as f:
            f.write(text)


# Transfer-pool size of the streaming executor: each transfer worker
# runs one dispatch class at a time on a CUDA stream of its own, so up
# to this many class pipelines overlap on the card.
XFER_WORKERS = 4
DRAIN_PHASES = ("device_wait_fetch", "scatter", "deflate", "shard_write")
# rep.seconds entries that are not per-stage busy seconds (main-thread
# blocked wall and the ingest producer's back-pressure)
_NON_STAGE_KEYS = (
    "total", "drain_utilization", "main_loop_stall", "prefetch_stall",
    "ingest_stall", "ingest_backpressure",
)


def _is_num(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def busy_wall_table(
    seconds: dict, drain_workers: int = 1
) -> tuple[list[str], list[str]]:
    """Render ``RunReport.seconds`` as overlapped busy-time vs wall rows.

    Streaming phases are per-stage BUSY seconds accrued on whichever
    thread runs the stage, so they overlap and do not sum to the wall.
    A stage can exceed the wall only up to its worker-pool size; busy
    beyond wall x pool is impossible with honest clocks, so such stages
    are returned as accounting-bug canaries (second element) and
    flagged BUSY>WALL in the rows.
    """

    def _num(v):
        return v if _is_num(v) else None

    wall = float(_num(seconds.get("total")) or 0.0)
    lines = [
        f"{'stage':<18} {'busy_s':>9} {'wall_s':>9} {'busy/wall':>9}  note"
    ]
    bugs: list[str] = []
    for k, v in seconds.items():
        if k in _NON_STAGE_KEYS:
            continue
        if _num(v) is None:
            lines.append(f"{k:<18} {'-':>9} {wall:9.3f} {'-':>9}  (non-numeric)")
            continue
        if k == "dispatch":
            # dispatch runs on the transfer pool, and the retry path
            # re-dispatches on drain workers too
            pool = XFER_WORKERS + drain_workers
        else:
            pool = drain_workers if k in DRAIN_PHASES else 1
        frac = (v / wall) if wall else 0.0
        if wall and v > wall * pool + 0.05:
            note = "BUSY>WALL (accounting bug)"
            bugs.append(k)
        elif pool > 1:
            note = f"pool x{pool}"
        else:
            note = ""
        lines.append(f"{k:<18} {v:9.3f} {wall:9.3f} {frac:9.2f}  {note}")
    du = _num(seconds.get("drain_utilization"))
    if du is not None:
        lines.append(f"drain_utilization  {du:.3f}")
    for key, what in (
        ("main_loop_stall", "main loop stalled on drain back-pressure"),
        ("prefetch_stall", "main loop stalled on the H2D prefetch window"),
        ("ingest_stall", "main loop stalled on the ingest producer"),
        ("ingest_backpressure", "ingest producer blocked on the full handoff queue"),
    ):
        v = _num(seconds.get(key))
        if v is not None and wall:
            lines.append(f"{what} {v / wall:.0%} of the wall")
    return lines, bugs


def resolve_device(device=None) -> torch.device:
    """``None``/"cuda" -> the GPU (raises when there is none: no silent
    CPU fallback); "cpu" runs every kernel's plain version."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run on the CPU"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev} (cuda or cpu)")
    return dev


def representative_per_family(
    fam_id: np.ndarray,  # (N,) dense ids, NO_FAMILY for unassigned
    valid: np.ndarray,  # (N,)
    pos_key: np.ndarray,  # (N,) i64
    umi: np.ndarray,  # (N, U) u8
    n_fam: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Per dense family id: its pos_key and consensus-reported UMI (the
    family's modal UMI, ties to the smallest packed code)."""
    fam_pos = np.zeros(n_fam, np.int64)
    fam_umi = np.zeros((n_fam, umi.shape[1]), np.uint8)
    sel = valid & (fam_id != NO_FAMILY)
    idx = np.nonzero(sel)[0]
    if not len(idx):
        return fam_pos, fam_umi
    f = fam_id[idx]
    words = pack_umi_words64(umi[idx])
    key = np.column_stack([f.astype(np.int64), words])
    uniq, inv, cnt = np.unique(key, axis=0, return_inverse=True, return_counts=True)
    first_read = np.full(len(uniq), -1, np.int64)
    order_reads = np.argsort(inv, kind="stable")
    pair_sorted = inv[order_reads]
    pair_first = np.nonzero(np.r_[True, pair_sorted[1:] != pair_sorted[:-1]])[0]
    first_read[pair_sorted[pair_first]] = order_reads[pair_first]
    # order unique pairs by (family, -count, umi words); first per family wins
    w = uniq.shape[1] - 1
    order = np.lexsort(
        (*[uniq[:, 1 + i] for i in range(w - 1, -1, -1)], -cnt, uniq[:, 0])
    )
    fam_sorted = uniq[order, 0]
    first = np.nonzero(np.r_[True, fam_sorted[1:] != fam_sorted[:-1]])[0]
    win_rows = order[first]
    fams_present = uniq[win_rows, 0].astype(np.int64)
    rep_reads = idx[first_read[win_rows]]
    fam_pos[fams_present] = pos_key[rep_reads]
    fam_umi[fams_present] = umi[rep_reads]
    return fam_pos, fam_umi


def scatter_bucket_outputs(
    out: dict,  # stacked host outputs as numpy, (B, ...)
    buckets,
    batch: ReadBatch,
    duplex: bool,
    pair_base: int = 0,  # global bucket index of buckets[0]
    want_depth: bool = False,  # also return per-base depth AND err rows
):
    """Map per-bucket outputs back to source-batch coordinates.

    Returns (cons_base, cons_qual, cons_dstats, fam_pos, fam_umi,
    cons_mate, cons_pair, cons_end) concatenated over buckets, holding
    only valid consensus rows below each bucket's real output count,
    plus the (n, L) cons_depth and cons_err rows with ``want_depth``
    (which needs them in ``out``: a per_base_counts spec, fetched with
    ``start_fetch(extra=PER_BASE_KEYS)``). cons_pair is globally unique
    across buckets (bucket-offset int64).
    """
    src_pos = np.asarray(batch.pos_key)
    src_umi = np.asarray(batch.umi)
    nb = len(buckets)
    f = out["cons_valid"].shape[1]
    ids = (out["molecule_id"] if duplex else out["family_id"])[:nb]
    n_out = (out["n_molecules"] if duplex else out["n_families"])[:nb]
    cv = out["cons_valid"][:nb].astype(bool)
    keep = (np.arange(f)[None, :] < np.asarray(n_out)[:, None]) & cv  # (nb, F)

    # ONE representative_per_family call over all buckets: bucket-local
    # dense ids are offset into disjoint [bi*F, bi*F+F) blocks
    ridx = np.stack([bk.read_index for bk in buckets])  # (nb, R)
    bvalid = np.stack([bk.valid for bk in buckets])
    in_src = ridx >= 0
    offset_ids = np.where(
        in_src & (ids >= 0),
        ids + (np.arange(nb, dtype=np.int64)[:, None] * f),
        NO_FAMILY,
    )
    src = np.maximum(ridx, 0)
    fam_pos, fam_umi = representative_per_family(
        offset_ids.ravel(),
        (bvalid & in_src).ravel(),
        np.where(in_src, src_pos[src], 0).ravel(),
        src_umi[src.ravel()],
        n_fam=nb * f,
    )
    fam_pos = fam_pos.reshape(nb, f)
    fam_umi = fam_umi.reshape(nb, f, -1)
    pair_local = out["cons_pair"][:nb].astype(np.int64)
    pair_glob = np.where(
        pair_local >= 0,
        pair_local + ((pair_base + np.arange(nb, dtype=np.int64))[:, None] << 33),
        -1,
    )
    res = (
        out["cons_base"][:nb][keep],
        out["cons_qual"][:nb][keep],
        np.stack(
            [out["depth_max"][:nb][keep], out["depth_min_pos"][:nb][keep]],
            axis=1,
        ),
        fam_pos[keep],
        fam_umi[keep],
        out["cons_mate"][:nb][keep],
        pair_glob[keep],
        out["cons_end"][:nb][keep],
    )
    if want_depth:
        res = res + (out["cons_depth"][:nb][keep], out["cons_err"][:nb][keep])
    return res


# Device outputs the executor consumes; cons_depth and cons_err (the
# padded (F, L) matrices) stay on the device unless per-base tags ask
# for them (PER_BASE_KEYS, fetched as extras), and n_overflow always
# does.
FETCH_KEYS = (
    "family_id",
    "molecule_id",
    "n_families",
    "n_molecules",
    "cons_valid",
    "cons_base",
    "cons_qual",
    "depth_max",
    "depth_min_pos",
    "cons_mate",
    "cons_pair",
    "cons_end",
)
PER_BASE_KEYS = ("cons_depth", "cons_err")


class Fetch(dict):
    """One dispatch's selected outputs on their way to the host: pinned
    host tensors that queued device->host copies are filling (CUDA), or
    the CPU tensors themselves. ``event`` is recorded on the copying
    stream after the last copy (None on the CPU); ``staging`` keeps the
    pinned H2D source buffers of the same dispatch referenced until
    that event has fired."""

    event = None
    staging = ()


def start_fetch(out: dict, keys: tuple = FETCH_KEYS, staging=(), extra: tuple = ()) -> Fetch:
    """Select ``keys`` (+ ``extra``, e.g. PER_BASE_KEYS for per-base
    tags) and start their device->host copies NOW into
    pinned host buffers (non-blocking, on the current stream), so every
    copy is queued before any is awaited; then record the event the
    waiter blocks on. CPU tensors pass through."""
    sel = Fetch()
    stream = None
    for k in (*keys, *extra):
        v = out[k]
        if v.is_cuda:
            h = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            h.copy_(v, non_blocking=True)
            stream = torch.cuda.current_stream(v.device)
            v = h
        sel[k] = v
    if stream is not None:
        sel.event = torch.cuda.Event()
        sel.event.record(stream)
        sel.staging = staging
    return sel


def fetch_outputs(sel: Fetch) -> dict:
    """Wait for THIS fetch's copies (its event, never a device-wide
    synchronize: other dispatches stay in flight) and hand back the
    host arrays as numpy."""
    # chaos site: a scheduled fault here lands in the streaming
    # executor's retry/isolation ladder
    fault_point("fetch.result")
    if sel.event is not None:
        sel.event.synchronize()
    return {k: v.numpy() for k, v in sel.items()}


# ------------------------------------------------------- packed D2H rung
#
# The return path's wire diet: a device-side epilogue that (1) COMPACTS
# the (B, F)-padded consensus-row tensors to the valid prefix rows
# j < n_out[b] by a prefix sum + searchsorted gather into k_pad rows —
# k_pad is a HOST-side bound from the grouping invariant that sizes
# f_max (adjacency can only MERGE exact families, so output units per
# bucket <= mult * n_unique) — and (2) packs base|qual using the
# kernels' output coupling (cons_base == BASE_N iff cons_qual ==
# NO_CALL_QUAL, and called quals are clipped >= 2): the qual byte
# carries 0 as the N marker and bases ride 2-bit, four per byte. Depth
# stats and the read->id map ride u16 (gated on capacity < 2**16), and
# only the id array the scatter consumes is fetched. The host unpack
# reconstructs the exact unpacked FETCH_KEYS arrays at every position
# the scatter reads, so output bytes are identical with the rung on or
# off. The wire layout is the JAX package's byte for byte (one shard:
# this executor runs one device).

PACKED_FETCH_KEYS = (
    "n_families",
    "n_molecules",
    "ids16",
    "cons_q",
    "cons_b2",
    "cons_flags",
    "cons_dstats",
    "cons_pair",
)


class D2hCompactionOverflow(RuntimeError):
    """The packed-D2H row bound was violated: the device produced more
    output units than the grouping invariant allows. Deterministic — a
    retry re-derives the identical overflow — so the streaming
    executor's retry/isolation ladder re-raises it at once."""


def _pack_d2h(out: dict, duplex: bool, k_pad: int) -> dict:
    """The compaction, batched over the bucket axis as one set of
    tensor ops: a prefix sum of the per-bucket row counts, a
    searchsorted of the k_pad wire rows into it, and gathers. Lanes are
    computed in i32 and cast to their wire dtype at the end."""
    from duplexumiconsensusreads_torch.constants import N_REAL_BASES
    from duplexumiconsensusreads_torch.kernels.encoding import pack_2bit

    valid = out["cons_valid"]
    n_b, f = valid.shape
    dev = valid.device
    n_out = out["n_molecules" if duplex else "n_families"].clamp(0, f).long()
    offs = torch.cumsum(n_out, 0)
    starts = offs - n_out
    k = torch.arange(k_pad, dtype=torch.int64, device=dev)
    b = torch.searchsorted(offs, k, right=True).clamp(max=n_b - 1)
    j = (k - starts[b]).clamp(0, f - 1)
    live = k < offs[-1]

    def g(a):
        v = a[b, j].to(torch.int32)
        mask = live.reshape((-1,) + (1,) * (v.dim() - 1))
        return torch.where(mask, v, 0)

    base = g(out["cons_base"])  # (K, L)
    qual = g(out["cons_qual"])
    # the N marker: called quals are >= 2 by the kernels' clip, so 0 is
    # free — and BASE_N rows always carry NO_CALL_QUAL
    qb = torch.where(base >= N_REAL_BASES, 0, qual)
    flags = g(valid) | (g(out["cons_mate"]) << 1) | (g(out["cons_end"]) << 2)
    ids = out["molecule_id" if duplex else "family_id"]
    return {
        "n_families": out["n_families"],
        "n_molecules": out["n_molecules"],
        # F <= capacity < 2**16, so the u16 id-lane convention applies
        "ids16": ids_to_u16(ids),
        "cons_q": qb.to(torch.uint8),
        "cons_b2": pack_2bit((base & 3).to(torch.uint8)),
        "cons_flags": flags.to(torch.uint8),
        "cons_dstats": torch.stack(
            [g(out["depth_max"]), g(out["depth_min_pos"])], dim=1
        ).to(torch.uint16),
        "cons_pair": g(out["cons_pair"]),
    }


def d2h_pack_ok(capacity: int, per_base_tags: bool) -> bool:
    """Gate for the packed return path: ids/depths must fit u16
    (capacity bounds both), and per-base-tag runs fetch the full
    (F, L) depth/err matrices the compact layout does not carry."""
    return capacity < (1 << 16) and not per_base_tags


# ------------------------------------------------- ids-lane u16 rung
#
# When the FULL compaction is gated off by per-base tags, the scatter
# still consumes only ONE id array (molecule_id in duplex, else
# family_id), and dense ids biased by one fit u16: this partial rung
# fetches that one array, u16, instead of both i32 arrays.

IDS16_FETCH_KEYS = tuple(
    k for k in FETCH_KEYS if k not in ("family_id", "molecule_id")
) + ("ids16",)

# THE u16 id-lane convention, one pack/unpack pair: dense ids live in
# [-1, capacity), so +IDS16_BIAS fits them into u16 under the capacity
# gate. Both d2h rungs and both host reconstructions go through these.
IDS16_BIAS = 1


def ids_to_u16(ids: torch.Tensor) -> torch.Tensor:
    """Device-side half of the u16 id-lane convention."""
    return (ids.to(torch.int32) + IDS16_BIAS).to(torch.uint16)


def ids_from_u16(a) -> np.ndarray:
    """Host-side inverse: exact i32 reconstruction of the id array."""
    return np.asarray(a).astype(np.int32) - IDS16_BIAS


def ids16_ok(capacity: int) -> bool:
    """Gate for the ids-lane u16 rung: biased dense ids (<= capacity)
    must fit u16 — the same bound as the full rung's ids16 lane."""
    return capacity < (1 << 16)


def d2h_rung_for_class(
    d2h_on: bool, ids16_want: bool, capacity: int, per_base_tags: bool
) -> tuple[str, str | None]:
    """THE per-class return-path rung decision. Returns (rung,
    fallback_reason):

      "packed"  full consensus-only compaction (d2h_pack_ok holds)
      "ids16"   partial rung — full compaction gated off but the
                consumed id array still packs u16
      "off"     fully unpacked; fallback_reason names the ledgered
                packed_fallback when a wanted rung was refused, None
                when the caller asked for off
    """
    if d2h_on:
        if d2h_pack_ok(capacity, per_base_tags):
            return "packed", None
        # the class capacity defeated the full rung; the same u16 bound
        # defeats the ids lane
        return "off", "jumbo-class-capacity-overflows-u16"
    if ids16_want:
        if ids16_ok(capacity):
            return "ids16", None
        return "off", "ids-lane-overflows-u16"
    return "off", None


def pack_ids_u16(out: dict, duplex: bool) -> dict:
    """Replace the pipeline output's two id arrays with the ONE the
    scatter consumes, biased into u16 on the device."""
    ids = out["molecule_id" if duplex else "family_id"]
    d = {k: v for k, v in out.items() if k not in ("family_id", "molecule_id")}
    d["ids16"] = ids_to_u16(ids)
    return d


def d2h_unit_bound(spec) -> tuple[int, int]:
    """(mult, f) of the per-bucket output-unit bound ``min(mult *
    n_unique, f)`` — the grouping invariant both the k_pad sizing and
    the host unpack's overflow check rest on."""
    g, duplex = spec.grouping, spec.consensus.mode == "duplex"
    if duplex:
        mult = 2 if (g.mate_aware and g.paired) else 1
        f = spec.m_max or 0
    else:
        mult = (2 if g.paired else 1) * (2 if g.mate_aware else 1)
        f = spec.f_max or 0
    return mult, f


def d2h_k_pad(cbuckets, spec, n_shards: int = 1) -> int:
    """Static per-shard row bound of the compacted consensus transfer:
    per bucket, output units are bounded by mult * n_unique, summed over
    each shard's contiguous bucket block and rounded to a power of two
    (capped at per * f). The host unpack re-checks the fetched counts
    against it and fails loudly on violation."""
    from duplexumiconsensusreads_torch.ops.pipeline import _pow2

    mult, f = d2h_unit_bound(spec)
    f = f or cbuckets[0].capacity
    n_stacked = len(cbuckets) + (-len(cbuckets)) % max(n_shards, 1)
    per = max(n_stacked // max(n_shards, 1), 1)
    bound = 0
    for s in range(max(n_shards, 1)):
        bound = max(
            bound,
            sum(
                min(mult * bk.n_unique_umi, f)
                for bk in cbuckets[s * per : (s + 1) * per]
            ),
        )
    return min(_pow2(max(bound, 1)), per * f)


def pack_fetch_outputs(out: dict, spec, k_pad: int) -> dict:
    """Apply the packed-D2H epilogue to a pipeline output dict (on the
    device the outputs live on); returns the compact dict
    (PACKED_FETCH_KEYS)."""
    return _pack_d2h(out, spec.consensus.mode == "duplex", k_pad)


def _unpack_2bit_np(packed: np.ndarray, l: int) -> np.ndarray:
    """Host mirror of kernels.encoding.pack_2bit."""
    shifts = np.arange(4, dtype=np.uint8) * 2
    codes = (packed[..., None] >> shifts) & 3
    return codes.reshape(*packed.shape[:-1], -1)[..., :l].astype(np.uint8)


def unpack_fetch_outputs(fetched: dict, cbuckets, spec, n_shards: int = 1) -> dict:
    """Host-side reconstruction of the exact unpacked FETCH_KEYS arrays
    from a packed-D2H fetch (dtypes included). Rows past each bucket's
    n_out reconstruct as zeros/invalid; the scatter's keep mask never
    reads them. A dict without the packed marker key passes through
    (an ids16 fetch gets its one id array back). ``n_shards`` must
    match the pack side's: the wire rows arrive as S per-shard k_pad
    blocks."""
    from duplexumiconsensusreads_torch.constants import BASE_N, NO_CALL_QUAL

    duplex = spec.consensus.mode == "duplex"
    if "cons_q" not in fetched:
        if "ids16" in fetched:
            out = {k: v for k, v in fetched.items() if k != "ids16"}
            out["molecule_id" if duplex else "family_id"] = ids_from_u16(
                fetched["ids16"]
            )
            return out
        return fetched
    f = (spec.m_max if duplex else spec.f_max) or cbuckets[0].capacity
    nf = np.asarray(fetched["n_families"])
    nm = np.asarray(fetched["n_molecules"])
    n_b = nf.shape[0]
    rows_wire, l = fetched["cons_q"].shape
    if n_b % max(n_shards, 1) or rows_wire % max(n_shards, 1):
        raise D2hCompactionOverflow(
            f"packed d2h shard mismatch: {n_b} buckets / {rows_wire} "
            f"wire rows not divisible by n_shards={n_shards}"
        )
    per = n_b // n_shards
    k_pad = rows_wire // n_shards
    n_out = np.clip(nm if duplex else nf, 0, f)
    shard_totals = n_out.reshape(n_shards, per).sum(axis=1)
    if (shard_totals > k_pad).any():
        # the grouping invariant the bound rests on was violated — rows
        # were dropped on the device; this must never be silent
        s_bad = int(np.argmax(shard_totals > k_pad))
        raise D2hCompactionOverflow(
            f"packed d2h compaction overflow: shard {s_bad} produced "
            f"{int(shard_totals[s_bad])} output rows > bound {k_pad} "
            f"(grouping invariant violated)"
        )
    offs = np.concatenate([[0], np.cumsum(n_out)])
    total = int(offs[-1])
    b_of = np.repeat(np.arange(n_b), n_out)
    j_of = np.arange(total) - offs[b_of]
    # wire source row of each live output row: its shard's k_pad block
    # base plus the bucket-run offset within the shard
    shard_of = b_of // per
    src = shard_of * k_pad + np.arange(total) - offs[shard_of * per]

    q = np.asarray(fetched["cons_q"])[src]
    b2 = _unpack_2bit_np(np.asarray(fetched["cons_b2"])[src], l)
    none = q == 0
    base_rows = np.where(none, np.uint8(BASE_N), b2)
    qual_rows = np.where(none, np.uint8(NO_CALL_QUAL), q)
    flags = np.asarray(fetched["cons_flags"])[src]
    dstats = np.asarray(fetched["cons_dstats"])[src].astype(np.int32)
    pair_rows = np.asarray(fetched["cons_pair"])[src]
    cons_base = np.zeros((n_b, f, l), np.uint8)
    cons_qual = np.zeros((n_b, f, l), np.uint8)
    cons_valid = np.zeros((n_b, f), bool)
    depth_max = np.zeros((n_b, f), np.int32)
    depth_min_pos = np.zeros((n_b, f), np.int32)
    cons_mate = np.zeros((n_b, f), np.uint8)
    cons_end = np.zeros((n_b, f), np.uint8)
    cons_pair = np.zeros((n_b, f), np.int32)
    cons_base[b_of, j_of] = base_rows
    cons_qual[b_of, j_of] = qual_rows
    cons_valid[b_of, j_of] = (flags & 1).astype(bool)
    cons_mate[b_of, j_of] = (flags >> 1) & 1
    cons_end[b_of, j_of] = (flags >> 2) & 1
    depth_max[b_of, j_of] = dstats[:, 0]
    depth_min_pos[b_of, j_of] = dstats[:, 1]
    cons_pair[b_of, j_of] = pair_rows
    return {
        "n_families": nf,
        "n_molecules": nm,
        ("molecule_id" if duplex else "family_id"): ids_from_u16(
            fetched["ids16"]
        ),
        "cons_valid": cons_valid,
        "cons_base": cons_base,
        "cons_qual": cons_qual,
        "depth_max": depth_max,
        "depth_min_pos": depth_min_pos,
        "cons_mate": cons_mate,
        "cons_pair": cons_pair,
        "cons_end": cons_end,
    }


def d2h_logical_nbytes(fetched: dict, cbuckets, spec) -> int:
    """Bytes the UNPACKED fetch of the same class would have moved —
    the d2h ledger records' ``logical`` side: both (B, R) i32 id arrays,
    two (B,) i32 counts and the (B, F[, L]) consensus-row tensors."""
    if "cons_q" not in fetched:
        wire = sum(v.nbytes for v in fetched.values() if hasattr(v, "nbytes"))
        if "ids16" in fetched:
            ids = fetched["ids16"]
            return wire - ids.nbytes + 2 * int(np.prod(ids.shape)) * 4
        return wire
    duplex = spec.consensus.mode == "duplex"
    f = (spec.m_max if duplex else spec.f_max) or cbuckets[0].capacity
    n_b = np.asarray(fetched["n_families"]).shape[0]
    r = np.asarray(fetched["ids16"]).shape[1]
    # family_id + molecule_id (i32) + n_families + n_molecules (i32) +
    # cons_valid (bool) + cons_base/cons_qual (u8) + depth_max/
    # depth_min_pos (i32) + cons_mate/cons_end (u8) + cons_pair (i32)
    _, l = fetched["cons_q"].shape
    return 2 * n_b * r * 4 + 2 * n_b * 4 + n_b * f * (1 + 2 * l + 8 + 2 + 4)


def packed_io_ok(consensus: ConsensusParams) -> bool:
    """Packed base|qual transfer is lossless iff the input-qual cap
    fits the 6-bit payload (ops.pipeline.PACKED_QUAL_MAX)."""
    from duplexumiconsensusreads_torch.ops.pipeline import PACKED_QUAL_MAX

    return (
        consensus.max_input_qual <= PACKED_QUAL_MAX
        and consensus.min_input_qual <= PACKED_QUAL_MAX
    )


# The ssc reduction each device runs by default (default_ssc_method;
# partition_buckets resolves it on the run's device when no method is
# asked for). On the card the hand-written segment_gemm kernel won the
# fused-pipeline race against matmul, blockseg and runsum (PERF.md §5).
# DEFAULT_SSC_METHOD_CPU is the fastest method on a host CPU: on the
# 8-core host of an NVIDIA H100 80GB HBM3 (700.00 W), ``tools.tune_ssc
# --device cpu --molecules 3800 --reps 3`` (29,395 reads, the bench's
# vec-CPU leg's size) measured blockseg 49,771 reads/s at T=256 and
# 49,495 at T=128, matmul 45,083, runsum 40,159 and segment_gemm's
# plain version 29,739 (PERF.md §5).
DEFAULT_SSC_METHOD = "segment_gemm"
DEFAULT_SSC_METHOD_CPU = "blockseg"


def default_ssc_method(device=None) -> str:
    """The default ssc method of the device a run resolves to
    (``resolve_device``: the card unless "cpu" is asked for)."""
    dev = resolve_device(device)
    return DEFAULT_SSC_METHOD_CPU if dev.type == "cpu" else DEFAULT_SSC_METHOD


def partition_buckets(
    buckets,
    grouping: GroupingParams,
    consensus: ConsensusParams,
    ssc_method: str | None = None,
    packed_io: bool = False,
    per_base_counts: bool = False,
    qual_alphabet: tuple | None = None,
    blockseg_t: int | None = None,
    device=None,
):
    """Split buckets into dispatch classes of identical geometry+strategy.

    Returns [(class_buckets, PipelineSpec)], keyed by (capacity,
    preclustered, pow2(unique-count)) exactly as the JAX package keys
    them. Preclustered buckets run with EXACT grouping (their UMIs are
    already relabeled to the directional seed by the host).

    ``packed_io=True`` requests the H2D wire packing; the rung is a
    per-class decision made here:

      sub-byte  ``qual_alphabet`` given and it fits a dictionary
                (ops.pipeline.subbyte_qbits_for): 5 or 7 bits/cycle,
                lossless at any qual cap
      byte      alphabet absent/overflowing but the 6-bit payload is
                lossless (packed_io_ok)
      off       bucket-local pos ids would overflow the u16 lane
                (capacity > 2**16), or no lossless rung exists — with a
                ``packed_fallback`` trace event

    ``blockseg_t`` sets every class spec's blockseg tile height (None:
    the spec default). ``ssc_method`` None takes the default of the
    device the classes will run on (``default_ssc_method(device)``).
    """
    from duplexumiconsensusreads_torch.kernels.consensus import BLOCKSEG_T
    from duplexumiconsensusreads_torch.ops.pipeline import (
        spec_for_buckets,
        subbyte_qbits_for,
    )
    from duplexumiconsensusreads_torch.telemetry.trace import emit_event

    if ssc_method is None:
        ssc_method = default_ssc_method(device)

    classes: dict[tuple, list] = {}
    for bk in buckets:
        ucls = 1 << max(bk.n_unique_umi - 1, 0).bit_length()
        classes.setdefault((bk.capacity, bk.preclustered, ucls), []).append(bk)
    byte_ok = packed_io_ok(consensus)
    out = []
    for key in sorted(classes):
        cbuckets = classes[key]
        g = dataclasses.replace(grouping, strategy="exact") if key[1] else grouping
        packed, qbits, lut = packed_io, None, None
        if packed_io:
            if key[0] > (1 << 16):
                packed = False
                emit_event(
                    "packed_fallback", scope="h2d",
                    reason="pos-ids-overflow-u16", capacity=key[0],
                )
            elif qual_alphabet is not None and subbyte_qbits_for(len(qual_alphabet)):
                qbits = subbyte_qbits_for(len(qual_alphabet))
                lut = tuple(qual_alphabet)
            elif not byte_ok:
                packed = False
                emit_event(
                    "packed_fallback", scope="h2d",
                    reason="input-qual-cap-overflows-6-bit",
                    max_input_qual=consensus.max_input_qual,
                )
        out.append(
            (
                cbuckets,
                spec_for_buckets(
                    cbuckets, g, consensus, ssc_method, packed_io=packed,
                    per_base_counts=per_base_counts,
                    packed_qbits=qbits, qual_lut=lut,
                    blockseg_t=BLOCKSEG_T if blockseg_t is None else blockseg_t,
                ),
            )
        )
    return out


def sort_consensus_outputs(cb, cq, cd, fp, fu, mate, pair, *extra):
    """Order consensus rows by (pos_key, UMI) so the output BAM stays
    coordinate-sorted (class-wise dispatch visits buckets out of
    genomic order). Extra row-aligned arrays ride along."""
    order = np.lexsort((*reversed(umi_sort_keys(fu)), fp))
    return (
        cb[order], cq[order], cd[order], fp[order], fu[order],
        mate[order], pair[order],
        *(x[order] for x in extra),
    )


def _add(rep: RunReport, key: str, dt: float) -> None:
    rep.seconds[key] = rep.seconds.get(key, 0.0) + dt


def call_batch(
    batch: ReadBatch,
    grouping: GroupingParams,
    consensus: ConsensusParams,
    capacity: int = 2048,
    report: RunReport | None = None,
    device="cuda",
    per_base_tags: bool = False,
):
    """Run one host ReadBatch through the bucketed pipeline on one device.

    Returns (cons_base, cons_qual, cons_dstats, cons_valid, fam_pos,
    fam_umi, cons_mate, cons_pair, cons_end) over all buckets, sorted
    by (pos_key, UMI) — the counterpart of the JAX call_batch_tpu.
    per_base_tags=True appends TWO elements, the (n, L) per-base depth
    and disagreement-count matrices (the pipeline's full ssc pass then
    reduces the err columns too, and both matrices cross the wire).
    """
    from duplexumiconsensusreads_torch.bucketing import build_buckets, stack_buckets
    from duplexumiconsensusreads_torch.interop import ARRAY_KEYS, stacked_from_numpy
    from duplexumiconsensusreads_torch.ops.pipeline import fused_pipeline, pack_stacked

    dev = resolve_device(device)
    rep = report or RunReport()
    rep.device = str(dev)
    duplex = consensus.mode == "duplex"

    t0 = time.monotonic()
    fb: dict = {}
    buckets = build_buckets(batch, capacity=capacity, grouping=grouping, counters=fb)
    for k, v in fb.items():
        setattr(rep, k, getattr(rep, k) + v)
    rep.n_buckets = len(buckets)
    _add(rep, "bucketing", time.monotonic() - t0)
    if not buckets:
        l, u = batch.read_len, batch.umi_len
        z = np.zeros
        empty = (
            z((0, l), np.uint8), z((0, l), np.uint8), z((0, 2), np.int32),
            z((0,), bool), z((0,), np.int64), z((0, u), np.uint8),
            z((0,), np.uint8), z((0,), np.int64), z((0,), np.uint8),
        )
        return empty + ((z((0, l), np.int32),) * 2 if per_base_tags else ())

    part = partition_buckets(
        buckets, grouping, consensus, packed_io=packed_io_ok(consensus),
        per_base_counts=per_base_tags, device=dev,
    )
    rep.n_size_classes = len(part)
    pending = []
    for cbuckets, cspec in part:
        t0 = time.monotonic()
        stacked = stack_buckets(cbuckets)
        if cspec.packed_io:
            pack_stacked(stacked)
        rep.bytes_h2d += sum(int(stacked[k].nbytes) for k in ARRAY_KEYS)
        t1 = time.monotonic()
        _add(rep, "stack_pack", t1 - t0)
        staging = []
        args = stacked_from_numpy(stacked, dev, pin=True, keep=staging)
        out = fused_pipeline(*(args[k] for k in ARRAY_KEYS), cspec)
        del args
        sel = start_fetch(out, staging=staging,
                          extra=PER_BASE_KEYS if per_base_tags else ())
        del out
        rep.bytes_d2h += sum(int(v.nbytes) for v in sel.values())
        pending.append((cbuckets, sel))
        _add(rep, "device_dispatch", time.monotonic() - t1)

    parts = []
    pair_base = 0
    for cbuckets, sel in pending:
        t0 = time.monotonic()
        out = fetch_outputs(sel)
        t1 = time.monotonic()
        _add(rep, "device_wait_fetch", t1 - t0)
        n_real = len(cbuckets)
        rep.n_families += int(out["n_families"][:n_real].sum())
        rep.n_molecules += int(out["n_molecules"][:n_real].sum())
        parts.append(scatter_bucket_outputs(out, cbuckets, batch, duplex, pair_base,
                                            want_depth=per_base_tags))
        pair_base += n_real
        _add(rep, "scatter", time.monotonic() - t1)

    t0 = time.monotonic()
    cols = sort_consensus_outputs(*(np.concatenate(x) for x in zip(*parts)))
    _add(rep, "scatter", time.monotonic() - t0)
    return (*cols[:3], np.ones(len(cols[0]), bool), *cols[3:])


def call_batch_cpu(
    batch: ReadBatch,
    grouping: GroupingParams,
    consensus: ConsensusParams,
    report: RunReport | None = None,
    per_base_tags: bool = False,
):
    """The NumPy oracle over the whole batch (no device): the operators'
    cpu backends, then the host twin of the pipeline's per-row mate/pair
    epilogue. Returns what :func:`call_batch` returns, in family-id
    order, which is (pos_key, UMI) order."""
    from duplexumiconsensusreads_torch.io.convert import depth_stats
    from duplexumiconsensusreads_torch.ops import ConsensusCaller, UmiGrouper

    rep = report or RunReport()
    t0 = time.monotonic()
    fams = UmiGrouper(grouping, backend="cpu")(batch)
    cons = ConsensusCaller(consensus, backend="cpu")(batch, fams)
    rep.seconds["cpu_pipeline"] = time.monotonic() - t0
    rep.n_families = int(fams.n_families)
    rep.n_molecules = int(fams.n_molecules)

    duplex = consensus.mode == "duplex"
    ids = np.asarray(fams.molecule_id if duplex else fams.family_id)
    n_out = int(fams.n_molecules if duplex else fams.n_families)
    fam_pos, fam_umi = representative_per_family(
        ids,
        np.asarray(batch.valid, bool),
        np.asarray(batch.pos_key),
        np.asarray(batch.umi),
        n_fam=n_out,
    )
    cv = np.asarray(cons.valid, bool)
    # per-output-row mate/pair metadata (constant within a row's reads)
    e2 = np.asarray(batch.frag_end, bool)
    s = np.asarray(batch.strand_ab, bool)
    pid = np.asarray(fams.pair_id).astype(np.int64)
    if duplex:
        mate_read = e2.astype(np.int64)
        pair_read = pid
    elif grouping.paired:
        mate_read = (e2 ^ ~s).astype(np.int64)
        pair_read = pid * 2 + (~s).astype(np.int64)
    else:
        # unpaired ss families (molecule, end) can mix strands: label
        # rows by fragment end, as the device pipeline does
        mate_read = e2.astype(np.int64)
        pair_read = pid
    sel = np.asarray(batch.valid, bool) & (ids >= 0)
    big = np.iinfo(np.int64).max
    mate = np.full(n_out, big, np.int64)
    pair = np.full(n_out, big, np.int64)
    np.minimum.at(mate, ids[sel], mate_read[sel])
    np.minimum.at(pair, ids[sel], pair_read[sel])
    mate = np.where(cv, np.minimum(mate, 1), 0).astype(np.uint8)
    pair = np.where(cv & (pair < big), pair, -1)
    endv = np.full(n_out, big, np.int64)
    np.minimum.at(endv, ids[sel], e2[sel].astype(np.int64))
    endv = np.where(cv, np.minimum(endv, 1), 0).astype(np.uint8)

    res = (
        np.asarray(cons.bases)[cv],
        np.asarray(cons.quals)[cv],
        depth_stats(np.asarray(cons.depth))[cv],
        np.ones(int(cv.sum()), bool),
        fam_pos[cv],
        fam_umi[cv],
        mate[cv],
        pair[cv],
        endv[cv],
    )
    if per_base_tags:
        res = res + (np.asarray(cons.depth)[cv], np.asarray(cons.err)[cv])
    return res


def resolve_mate_aware(
    grouping: GroupingParams, info: dict, setting: str = "auto"
) -> GroupingParams:
    """Resolve the --mate-aware setting against the loaded input: auto =
    mate-aware exactly when the input's valid paired reads span both
    read numbers (``info["mixed_mates"]``)."""
    if setting not in ("auto", "on", "off"):
        raise ValueError(f"mate_aware must be auto/on/off, got {setting!r}")
    on = bool(info.get("mixed_mates")) if setting == "auto" else setting == "on"
    if on == grouping.mate_aware:
        return grouping
    return dataclasses.replace(grouping, mate_aware=on)


def count_consensus_pairs(recs) -> int:
    """Complete consensus R1+R2 pairs."""
    from duplexumiconsensusreads_torch.io.bam import (
        FLAG_PAIRED,
        FLAG_PROPER_PAIR,
        FLAG_READ1,
    )

    fl = np.asarray(recs.flags)
    want = FLAG_PAIRED | FLAG_PROPER_PAIR | FLAG_READ1
    return int(((fl & want) == want).sum())


def call_consensus_file(
    in_path: str,
    out_path: str,
    grouping: GroupingParams,
    consensus: ConsensusParams,
    capacity: int = 2048,
    report_path: str | None = None,
    mate_aware: str = "auto",
    max_reads: int = 0,
    per_base_tags: bool = False,
    read_group: str = "A",
    write_index: bool = False,
    ref_projected: bool = False,
    umi_whitelist=None,  # (W, U) u8 codes (io.convert.load_umi_whitelist)
    umi_max_mismatches: int = 1,
    device="cuda",
    backend: str = "cuda",
    profile_dir: str | None = None,
) -> RunReport:
    """End-to-end: read BAM/npz -> consensus -> write consensus BAM.

    The counterpart of the JAX package's whole-file call_consensus_file
    (``chunk_reads`` 0). ``backend="cuda"`` runs the bucketed device
    pipeline on ``device``; ``backend="cpu"`` runs the NumPy oracle
    (:func:`call_batch_cpu`) and touches no device. Output is
    coordinate-sorted by construction and the header says so;
    write_index=True also writes the standard .bai beside it (.csi when
    a contig exceeds BAI's 2^29 coordinate space). ``profile_dir``
    writes a ``torch.profiler`` trace of the consensus stage there
    (``trace.json``).
    """
    from duplexumiconsensusreads_torch.io import (
        consensus_to_records,
        load_input,
        write_bam,
    )
    from duplexumiconsensusreads_torch.io.bam import (
        derive_output_header,
        reorder_records,
        unique_read_group_id,
    )

    if backend not in ("cuda", "cpu"):
        raise ValueError(f"unknown backend {backend!r} (cuda or cpu)")
    dev = resolve_device(device) if backend == "cuda" else torch.device("cpu")
    rep = RunReport(device=str(dev), backend=backend)
    duplex = consensus.mode == "duplex"

    t0 = time.monotonic()
    # the mixed-mate warning only applies when mate-aware stays off
    header, batch, info = load_input(
        in_path, duplex=duplex, warn_mixed=(mate_aware == "off"),
        ref_projected=ref_projected, mate_aware=mate_aware,
        umi_whitelist=umi_whitelist, umi_max_mismatches=umi_max_mismatches,
    )
    grouping = resolve_mate_aware(grouping, info, mate_aware)
    proj = info.get("ref_projection")
    if proj is not None and proj.mate_split != grouping.mate_aware:
        # both sides derive the decision from the same mixed-mates
        # signal; a divergence would mis-key every emission lookup
        raise RuntimeError(
            "ref-projection mate split diverged from resolved grouping"
        )
    rep.mate_aware = grouping.mate_aware
    rep.n_records = info["n_records"]
    rep.n_dropped = (
        info.get("n_dropped_no_umi", 0)
        + info.get("n_dropped_umi_len", 0)
        + info.get("n_dropped_flag", 0)
        + info.get("n_dropped_cigar", 0)
    )
    for key in ("n_mixed_mate_families", "n_rescued_cigar", "n_dropped_cigar_ab",
                "n_dropped_cigar_ba", "n_projected_reads", "n_projection_fallback_reads",
                "n_projection_fallback_groups", "n_projection_unanchored_reads",
                "n_umi_corrected", "n_dropped_whitelist"):
        setattr(rep, key, info.get(key, 0))
    rep.n_valid_reads = int(np.asarray(batch.valid).sum())
    if max_reads > 0:
        from duplexumiconsensusreads_torch.io.convert import downsample_families

        rep.n_downsampled_reads = downsample_families(batch, max_reads)
    rep.seconds["read_input"] = time.monotonic() - t0

    prof = None
    if profile_dir:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        prof = profile(activities=acts)
        prof.start()
    try:
        if backend == "cuda":
            cb, cq, cd, cv, fp, fu, mate, pair, end, *rest = call_batch(
                batch, grouping, consensus, capacity, rep, dev, per_base_tags=per_base_tags,
            )
        else:
            cb, cq, cd, cv, fp, fu, mate, pair, end, *rest = call_batch_cpu(
                batch, grouping, consensus, rep, per_base_tags=per_base_tags,
            )
    finally:
        if prof is not None:
            prof.stop()
            os.makedirs(profile_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))

    t0 = time.monotonic()
    # collision-free id FIRST: the RG:Z tags must match the header @RG
    read_group = unique_read_group_id(header.text, read_group)
    out_recs = consensus_to_records(
        cb, cq, cd, cv, fp, fu, duplex=duplex,
        cons_mate=mate, cons_pair=pair, paired_out=grouping.mate_aware,
        cons_pdepth=rest[0] if rest else None,
        cons_perr=rest[1] if rest else None,
        read_group=read_group, proj=proj, cons_end=end,
    )
    if proj is not None:
        # projected POS moves to the first called reference column, so
        # family-id emission order is no longer coordinate order —
        # restore it (stable: equal positions keep UMI order)
        out_recs = reorder_records(
            out_recs,
            np.lexsort((np.asarray(out_recs.pos), np.asarray(out_recs.ref_id))),
        )
    header_out = derive_output_header(header, sort_order="coordinate", rg_id=read_group)
    write_bam(out_path, header_out, out_recs)
    if write_index:
        write_bam_index(out_path, header_out.ref_lengths)
    rep.n_consensus = len(out_recs)
    rep.n_consensus_pairs = count_consensus_pairs(out_recs)
    rep.seconds["write_output"] = time.monotonic() - t0

    if report_path:
        write_report(rep, report_path)
    return rep


def write_bam_index(path: str, ref_lengths) -> str:
    """The standard index of a coordinate-sorted BAM: .bai, unless a
    contig exceeds BAI's 2^29 coordinate space, then the CSI
    generalization (depth sized to the contig). Returns its path."""
    if max(ref_lengths, default=0) > (1 << 29):
        from duplexumiconsensusreads_torch.io.csi import build_csi

        return build_csi(path)
    from duplexumiconsensusreads_torch.io.bai import build_bai

    return build_bai(path)
