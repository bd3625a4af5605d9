"""Whole-file orchestration: BAM in -> grouped/consensus-called -> BAM out.

The host runtime around the device pipeline, the counterpart of the JAX
package's runtime/executor.py (call_batch_tpu / call_consensus_file):

  portable BAM parse -> build_buckets -> partition_buckets (byte-rung
  packed H2D) -> stack_buckets -> ONE batched fused_pipeline call per
  dispatch class -> non-blocking D2H into pinned host buffers -> one
  synchronize -> scatter_bucket_outputs -> sort_consensus_outputs ->
  consensus_to_records -> write_bam.

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``; with no GPU they raise instead of falling back.
"""

from __future__ import annotations

import dataclasses
import json
import time

import numpy as np
import torch

from duplexumiconsensusreads_torch.constants import NO_FAMILY
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
    n_size_classes: int = 0
    n_mixed_mate_families: int = 0  # see io.convert.warn_mixed_mates
    n_consensus_pairs: int = 0  # mate-aware: consensus R1+R2 pairs emitted
    # result-changing bucketing fallbacks (bucketing.FALLBACK_COUNTERS)
    n_precluster_fallback_groups: int = 0
    n_precluster_fallback_reads: int = 0
    n_jumbo_hardcut_families: int = 0
    n_jumbo_hardcut_splits: int = 0
    # CIGAR input policy (io.convert): rescued vs dropped per strand
    n_rescued_cigar: int = 0
    n_dropped_cigar_ab: int = 0
    n_dropped_cigar_ba: int = 0
    mate_aware: bool = False  # resolved mate-aware mode of this run
    device: str = ""
    # bytes of device-input tensors sent and device-output tensors
    # fetched (the packed wire form where packing applies)
    bytes_h2d: int = 0
    bytes_d2h: int = 0
    seconds: dict = dataclasses.field(default_factory=dict)

    def to_json(self) -> str:
        """Stable key order, seconds rounded to milliseconds."""
        d = dataclasses.asdict(self)
        d["seconds"] = {k: round(float(v), 3) for k, v in self.seconds.items()}
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
):
    """Map per-bucket outputs back to source-batch coordinates.

    Returns (cons_base, cons_qual, cons_dstats, fam_pos, fam_umi,
    cons_mate, cons_pair, cons_end) concatenated over buckets, holding
    only valid consensus rows below each bucket's real output count.
    cons_pair is globally unique across buckets (bucket-offset int64).
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
    return (
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


# Device outputs the executor consumes; cons_depth (the padded (F, L)
# matrix) and n_overflow stay on the device.
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


def start_fetch(out: dict, keys: tuple = FETCH_KEYS) -> dict:
    """Select ``keys`` and start their device->host copies NOW into
    pinned host buffers (non-blocking, on the current stream), so every
    copy is queued before any is awaited. CPU tensors pass through."""
    sel = {}
    for k in keys:
        v = out[k]
        if v.is_cuda:
            h = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            h.copy_(v, non_blocking=True)
            v = h
        sel[k] = v
    return sel


def fetch_outputs(sel: dict, device) -> dict:
    """Wait for the queued copies (one synchronize) and hand back the
    host arrays as numpy."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return {k: v.numpy() for k, v in sel.items()}


def packed_io_ok(consensus: ConsensusParams) -> bool:
    """Packed base|qual transfer is lossless iff the input-qual cap
    fits the 6-bit payload (ops.pipeline.PACKED_QUAL_MAX)."""
    from duplexumiconsensusreads_torch.ops.pipeline import PACKED_QUAL_MAX

    return (
        consensus.max_input_qual <= PACKED_QUAL_MAX
        and consensus.min_input_qual <= PACKED_QUAL_MAX
    )


def partition_buckets(
    buckets,
    grouping: GroupingParams,
    consensus: ConsensusParams,
    ssc_method: str = "segment_gemm",
    packed_io: bool = False,
):
    """Split buckets into dispatch classes of identical geometry+strategy.

    Returns [(class_buckets, PipelineSpec)], keyed by (capacity,
    preclustered, pow2(unique-count)) exactly as the JAX package keys
    them. Preclustered buckets run with EXACT grouping (their UMIs are
    already relabeled to the directional seed by the host). packed_io
    requests the byte-rung H2D packing; a class whose bucket-local pos
    ids cannot fit u16 (capacity > 2**16) runs unpacked.
    """
    from duplexumiconsensusreads_torch.ops.pipeline import spec_for_buckets

    classes: dict[tuple, list] = {}
    for bk in buckets:
        ucls = 1 << max(bk.n_unique_umi - 1, 0).bit_length()
        classes.setdefault((bk.capacity, bk.preclustered, ucls), []).append(bk)
    out = []
    for key in sorted(classes):
        cbuckets = classes[key]
        g = dataclasses.replace(grouping, strategy="exact") if key[1] else grouping
        packed = packed_io and key[0] <= (1 << 16)
        out.append(
            (cbuckets, spec_for_buckets(cbuckets, g, consensus, ssc_method, packed_io=packed))
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
):
    """Run one host ReadBatch through the bucketed pipeline on one device.

    Returns (cons_base, cons_qual, cons_dstats, cons_valid, fam_pos,
    fam_umi, cons_mate, cons_pair, cons_end) over all buckets, sorted
    by (pos_key, UMI) — the counterpart of the JAX call_batch_tpu.
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
        return (
            z((0, l), np.uint8), z((0, l), np.uint8), z((0, 2), np.int32),
            z((0,), bool), z((0,), np.int64), z((0, u), np.uint8),
            z((0,), np.uint8), z((0,), np.int64), z((0,), np.uint8),
        )

    part = partition_buckets(
        buckets, grouping, consensus, packed_io=packed_io_ok(consensus)
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
        args = stacked_from_numpy(stacked, dev, pin=True)
        out = fused_pipeline(*(args[k] for k in ARRAY_KEYS), cspec)
        del args
        sel = start_fetch(out)
        del out
        rep.bytes_d2h += sum(int(v.nbytes) for v in sel.values())
        pending.append((cbuckets, sel))
        _add(rep, "device_dispatch", time.monotonic() - t1)

    parts = []
    pair_base = 0
    for cbuckets, sel in pending:
        t0 = time.monotonic()
        out = fetch_outputs(sel, dev)
        t1 = time.monotonic()
        _add(rep, "device_wait_fetch", t1 - t0)
        n_real = len(cbuckets)
        rep.n_families += int(out["n_families"][:n_real].sum())
        rep.n_molecules += int(out["n_molecules"][:n_real].sum())
        parts.append(scatter_bucket_outputs(out, cbuckets, batch, duplex, pair_base))
        pair_base += n_real
        _add(rep, "scatter", time.monotonic() - t1)

    t0 = time.monotonic()
    cols = sort_consensus_outputs(*(np.concatenate(x) for x in zip(*parts)))
    _add(rep, "scatter", time.monotonic() - t0)
    return (*cols[:3], np.ones(len(cols[0]), bool), *cols[3:])


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
    read_group: str = "A",
    device="cuda",
) -> RunReport:
    """End-to-end: read BAM/npz -> consensus -> write consensus BAM.

    Output is coordinate-sorted by construction and the header says so.
    The counterpart of the JAX package's whole-file call_consensus_file
    (``chunk_reads`` 0); streaming, ref projection, UMI whitelists,
    downsampling, per-base tags and BAI/CSI indexes are not ported.
    """
    from duplexumiconsensusreads_torch.io import (
        consensus_to_records,
        load_input,
        write_bam,
    )
    from duplexumiconsensusreads_torch.io.bam import (
        derive_output_header,
        unique_read_group_id,
    )

    dev = resolve_device(device)
    rep = RunReport(device=str(dev))
    duplex = consensus.mode == "duplex"

    t0 = time.monotonic()
    header, batch, info = load_input(
        in_path, duplex=duplex, warn_mixed=(mate_aware == "off"), mate_aware=mate_aware,
    )
    grouping = resolve_mate_aware(grouping, info, mate_aware)
    rep.mate_aware = grouping.mate_aware
    rep.n_records = info["n_records"]
    rep.n_dropped = (
        info.get("n_dropped_no_umi", 0)
        + info.get("n_dropped_umi_len", 0)
        + info.get("n_dropped_flag", 0)
        + info.get("n_dropped_cigar", 0)
    )
    rep.n_mixed_mate_families = info.get("n_mixed_mate_families", 0)
    rep.n_rescued_cigar = info.get("n_rescued_cigar", 0)
    rep.n_dropped_cigar_ab = info.get("n_dropped_cigar_ab", 0)
    rep.n_dropped_cigar_ba = info.get("n_dropped_cigar_ba", 0)
    rep.n_valid_reads = int(np.asarray(batch.valid).sum())
    rep.seconds["read_input"] = time.monotonic() - t0

    cb, cq, cd, cv, fp, fu, mate, pair, end = call_batch(
        batch, grouping, consensus, capacity, rep, dev
    )

    t0 = time.monotonic()
    read_group = unique_read_group_id(header.text, read_group)
    out_recs = consensus_to_records(
        cb, cq, cd, cv, fp, fu, duplex=duplex,
        cons_mate=mate, cons_pair=pair, paired_out=grouping.mate_aware,
        read_group=read_group, cons_end=end,
    )
    header_out = derive_output_header(header, sort_order="coordinate", rg_id=read_group)
    write_bam(out_path, header_out, out_recs)
    rep.n_consensus = len(out_recs)
    rep.n_consensus_pairs = count_consensus_pairs(out_recs)
    rep.seconds["write_output"] = time.monotonic() - t0

    if report_path:
        write_report(rep, report_path)
    return rep
