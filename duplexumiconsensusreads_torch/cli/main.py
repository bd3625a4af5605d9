"""Command line: ``python -m duplexumiconsensusreads_torch call IN -o OUT
--config configN [--capacity N] [--report r.json] [--device cuda|cpu]
[--per-base-tags] [--write-index] [--max-reads N] [--chunk-reads N ...]``,
``index BAM [--bai | --csi]`` and ``view BAM REGION``.

The ``call``, ``index`` and ``view`` of the JAX package's CLI, with its
preset table: the whole-file call (with ref projection and UMI
whitelists), or with ``--chunk-reads N`` (N > 0) the streaming executor
and its flags under the JAX CLI's names. Flags of the JAX CLI that this
package does not implement (follow mode, serving, ...) are refused by
name, and every refusal the JAX CLI makes is made in its words.
"""

from __future__ import annotations

import argparse
import sys

CONFIG_PRESETS = {
    # 1. single-strand consensus, exact grouping (small amplicon)
    "config1": dict(grouping="exact", mode="ss", error_model="none"),
    # 2. directional adjacency grouping, Hamming<=1 (hybrid-capture panel)
    "config2": dict(grouping="adjacency", mode="ss", error_model="none"),
    # 3. duplex consensus, top+bottom merge (ctDNA panel)
    "config3": dict(grouping="adjacency", mode="duplex", error_model="none"),
    # 4. whole-exome duplex, family-size-bucketed shards across the mesh
    "config4": dict(grouping="adjacency", mode="duplex", error_model="none", capacity=4096),
    # 5. per-cycle error-model / quality-recalibrated duplex
    "config5": dict(grouping="adjacency", mode="duplex", error_model="cycle"),
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m duplexumiconsensusreads_torch",
        description="duplex UMI consensus calling on PyTorch / CUDA",
    )
    sub = p.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("call", help="group UMIs and call consensus reads")
    c.add_argument("input", help="input BAM (or .npz ReadBatch)")
    c.add_argument("-o", "--output", required=True, help="output consensus BAM")
    c.add_argument("--config", choices=sorted(CONFIG_PRESETS), required=True)
    c.add_argument("--capacity", type=int, default=None, help="bucket read capacity")
    c.add_argument("--report", default=None, help="RunReport JSON path ('-' = stdout)")
    c.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    c.add_argument("--mate-aware", choices=["auto", "on", "off"], default="auto",
                   help="split families by fragment end (auto: when mates mix)")
    c.add_argument("--read-group-id", default="A", help="consensus @RG id")
    c.add_argument("--per-base-tags", action="store_true",
                   help="emit per-base depth (cd:B,I) and disagreeing-read-count "
                   "(ce:B,I) arrays on every consensus record")
    c.add_argument("--write-index", action="store_true",
                   help="also write the standard .bai (.csi past 2^29) beside the output")
    c.add_argument("--max-reads", type=int, default=0,
                   help="cap each exact sub-family at this many reads (0 = off)")
    w = c.add_argument_group("whole-file only")
    w.add_argument("--ref-projected", action="store_true",
                   help="project reads onto per-position reference columns")
    w.add_argument("--umi-whitelist", default=None,
                   help="expected-UMI list (one ACGT string per line): UMIs snap to "
                   "their unique nearest entry within --umi-max-mismatches")
    w.add_argument("--umi-max-mismatches", type=int, default=1,
                   help="whitelist correction distance bound")
    s = c.add_argument_group("streaming (with --chunk-reads N > 0)")
    s.add_argument("--chunk-reads", type=int, default=0,
                   help="stream the input in chunks of this many records "
                   "(0 = whole file in memory); needs coordinate-sorted input")
    s.add_argument("--checkpoint", default=None, help="chunk-progress manifest path")
    s.add_argument("--resume", action="store_true", help="skip chunks already in the manifest")
    s.add_argument("--max-inflight", type=int, default=4,
                   help="chunks in flight ahead of the ordered commit")
    s.add_argument("--drain-workers", type=int, default=2, help="drain worker threads")
    s.add_argument("--packed", choices=["auto", "byte", "off"], default="auto",
                   help="wire packing: auto = best lossless H2D rung per class, "
                   "byte caps at the byte rung; off also unpacks the return path")
    s.add_argument("--prefetch-depth", type=int, default=2,
                   help="chunks dispatched ahead of the drain")
    s.add_argument("--ingest-overlap", choices=["auto", "on", "off"], default="auto",
                   help="BGZF read + decode + bucketing on a background thread")
    s.add_argument("--trace", default=None, metavar="TRACE_JSONL",
                   help="per-chunk span/event capture (JSONL)")
    s.add_argument("--heartbeat", type=float, default=0.0, metavar="SECONDS",
                   help="liveness line to stderr every N seconds")
    s.add_argument("--profile", default=None, help="write a torch.profiler trace to this dir")

    x = sub.add_parser("index", help="index a coordinate-sorted BAM")
    x.add_argument("input", help="coordinate-sorted BAM")
    x.add_argument("-o", "--output", help="index path (default: input + .dlix/.bai/.csi)")
    x.add_argument("--every", type=int, default=100_000,
                   help="linear index: sampling stride in records")
    x.add_argument("--bai", action="store_true",
                   help="write the standard .bai binning index (SAM spec 5.2)")
    x.add_argument("--csi", action="store_true",
                   help="write the standard .csi index (needed past BAI's 2^29 limit)")

    vw = sub.add_parser("view", help="records overlapping a region, through the .bai/.csi "
                        "(built on demand)")
    vw.add_argument("input", help="coordinate-sorted BAM")
    vw.add_argument("region", help="REF[:BEG-END] (1-based inclusive); REF alone takes "
                    "the whole reference")
    vw.add_argument("-o", "--output", help="write matching records as BAM "
                    "(default: print a count summary)")
    vw.add_argument("--json", action="store_true", help="print the summary as JSON")
    return p


# flags that only the streaming executor implements here
_STREAM_ONLY = {
    "checkpoint": None, "resume": False, "max_inflight": 4, "drain_workers": 2,
    "packed": "auto", "prefetch_depth": 2, "ingest_overlap": "auto",
    "trace": None, "heartbeat": 0.0, "profile": None,
}


def params_for(config: str):
    """(GroupingParams, ConsensusParams, capacity) of a preset, with the
    JAX CLI's defaults for everything the preset leaves open."""
    from duplexumiconsensusreads_torch.types import ConsensusParams, GroupingParams

    pre = CONFIG_PRESETS[config]
    duplex = pre["mode"] == "duplex"
    gp = GroupingParams(strategy=pre["grouping"], paired=duplex)
    cp = ConsensusParams(
        mode="duplex" if duplex else "single_strand",
        error_model=None if pre["error_model"] == "none" else pre["error_model"],
    )
    return gp, cp, pre.get("capacity", 2048)


def _load_whitelist_or_exit(path: str):
    """Every whitelist problem is a clean CLI error, never a traceback."""
    from duplexumiconsensusreads_torch.io.convert import load_umi_whitelist

    try:
        return load_umi_whitelist(path)
    except (OSError, ValueError) as e:
        raise SystemExit(f"--umi-whitelist: {e}")


def main(argv=None) -> int:
    args, unknown = build_parser().parse_known_args(argv)
    if unknown:
        raise SystemExit(f"not supported by the torch port: {' '.join(unknown)}")
    if args.cmd == "index":
        return _cmd_index(args)
    if args.cmd == "view":
        return _cmd_view(args)
    return _cmd_call(args)


def _cmd_call(args) -> int:
    gp, cp, capacity = params_for(args.config)
    if args.capacity is not None:
        if args.capacity < 1:
            raise SystemExit(f"--capacity must be >= 1 (got {args.capacity})")
        capacity = args.capacity
    if args.chunk_reads < 0:
        raise SystemExit(f"--chunk-reads must be >= 0 (got {args.chunk_reads})")
    if args.max_reads < 0:
        raise SystemExit(f"--max-reads must be >= 0 (got {args.max_reads})")
    if args.write_index and not args.output.endswith(".bam"):
        raise SystemExit("--write-index requires a .bam output path")
    if args.ref_projected:
        if args.input.endswith(".npz"):
            raise SystemExit(
                "--ref-projected requires BAM input (the .npz "
                "interchange carries no CIGARs)"
            )
        if args.chunk_reads > 0:
            raise SystemExit(
                "--ref-projected runs on the whole-file executor "
                "(omit --chunk-reads / --n-hosts)"
            )
    umi_whitelist = None
    if args.umi_whitelist:
        if args.chunk_reads > 0:
            raise SystemExit(
                "--umi-whitelist runs on the whole-file executor "
                "(omit --chunk-reads / --n-hosts)"
            )
        umi_whitelist = _load_whitelist_or_exit(args.umi_whitelist)
    if args.chunk_reads > 0:
        from duplexumiconsensusreads_torch.runtime.stream import stream_call_consensus

        rep = stream_call_consensus(
            args.input, args.output, gp, cp,
            capacity=capacity, chunk_reads=args.chunk_reads,
            max_inflight=args.max_inflight, drain_workers=args.drain_workers,
            checkpoint_path=args.checkpoint, resume=args.resume,
            report_path=args.report, profile_dir=args.profile,
            mate_aware=args.mate_aware, max_reads=args.max_reads,
            per_base_tags=args.per_base_tags, read_group=args.read_group_id,
            write_index=args.write_index, packed=args.packed,
            prefetch_depth=args.prefetch_depth, ingest_overlap=args.ingest_overlap,
            trace_path=args.trace, heartbeat_s=args.heartbeat, device=args.device,
        )
    else:
        from duplexumiconsensusreads_torch.runtime.executor import call_consensus_file

        set_ = [k for k, v in _STREAM_ONLY.items() if getattr(args, k) != v]
        if set_:
            raise SystemExit(
                "not supported by the torch port's whole-file call (needs "
                f"--chunk-reads N): {', '.join('--' + k.replace('_', '-') for k in set_)}"
            )
        rep = call_consensus_file(
            args.input, args.output, gp, cp,
            capacity=capacity, report_path=args.report, mate_aware=args.mate_aware,
            max_reads=args.max_reads, per_base_tags=args.per_base_tags,
            read_group=args.read_group_id, write_index=args.write_index,
            ref_projected=args.ref_projected, umi_whitelist=umi_whitelist,
            umi_max_mismatches=args.umi_max_mismatches, device=args.device,
        )
    print(
        f"[duplexumi-torch] {rep.n_records} records -> {rep.n_consensus} "
        f"consensus on {rep.device}",
        file=sys.stderr,
    )
    return 0


def _cmd_index(args) -> int:
    if args.bai and args.csi:
        raise SystemExit("--bai and --csi are mutually exclusive")
    if args.csi:
        from duplexumiconsensusreads_torch.io.csi import build_csi

        out = build_csi(args.input, args.output)
        print(f"[duplexumi-torch] wrote standard CSI -> {out}", file=sys.stderr)
        return 0
    if args.bai:
        from duplexumiconsensusreads_torch.io.bai import build_bai

        out = build_bai(args.input, args.output)
        print(f"[duplexumi-torch] wrote standard BAI -> {out}", file=sys.stderr)
        return 0
    from duplexumiconsensusreads_torch.io.index import INDEX_SUFFIX, build_linear_index

    out = args.output or args.input + INDEX_SUFFIX
    idx = build_linear_index(args.input, every=args.every)
    idx.save(out)
    print(
        f"[duplexumi-torch] indexed {idx.n_records} records "
        f"({len(idx.pos_key)} entries, every {idx.every}) -> {out}",
        file=sys.stderr,
    )
    return 0


def parse_region(region: str, header) -> tuple[int, int, int, str]:
    """samtools-style REF[:BEG-END] (1-based inclusive) -> (ref_id, beg,
    end, ref_name) with a 0-based half-open [beg, end). Reference names
    may themselves contain ':' (GRCh38 HLA alt contigs): the whole
    string is tried as a name first."""
    import re

    ref_name, g_beg, g_end = None, None, None
    if region in header.ref_names:
        ref_name = region
    else:
        m = re.fullmatch(r"(.+):(\d+)-(\d+)", region)
        if m and m.group(1) in header.ref_names:
            ref_name, g_beg, g_end = m.group(1), m.group(2), m.group(3)
    if ref_name is None:
        raise SystemExit(
            f"unknown reference in region {region!r} (want REF or "
            f"REF:BEG-END with REF from the header)"
        )
    ref_id = header.ref_names.index(ref_name)
    beg = int(g_beg) - 1 if g_beg else 0
    end = int(g_end) if g_end else header.ref_lengths[ref_id]
    if beg < 0 or end <= beg:
        raise SystemExit(f"bad region bounds in {region!r}")
    return ref_id, beg, end, ref_name


def region_records(path: str, header, ref_id: int, beg: int, end: int) -> list:
    """Rows of the records overlapping [beg, end) on ref_id, through the
    file's .bai, else its .csi, else one built now (BAI, or CSI when a
    contig exceeds BAI's 2^29 coordinate space): one seek to the
    query's start virtual offset, then a forward scan that stops at the
    first record starting at or past ``end`` (the file is
    coordinate-sorted). Each row is a tuple of one record's fields."""
    import os

    from duplexumiconsensusreads_torch.io.bai import query_start_voffset, read_bai
    from duplexumiconsensusreads_torch.runtime.executor import write_bam_index
    from duplexumiconsensusreads_torch.runtime.stream import (
        BamStreamReader,
        _records_from_raw,
    )

    bai_path, csi_path = path + ".bai", path + ".csi"
    if not os.path.exists(bai_path) and not os.path.exists(csi_path):
        print(f"[duplexumi-torch] building the index of {path}", file=sys.stderr)
        write_bam_index(path, header.ref_lengths)
    if os.path.exists(bai_path):
        start_v = query_start_voffset(read_bai(bai_path), ref_id, beg, end)
    else:
        from duplexumiconsensusreads_torch.io.csi import query_start_voffset_csi, read_csi

        start_v = query_start_voffset_csi(read_csi(csi_path), ref_id, beg, end)
    kept = []
    if start_v is None:
        return kept
    rdr = BamStreamReader(path, start=(start_v >> 16, start_v & 0xFFFF))
    try:
        while True:
            raw = rdr.read_raw_records(4096)
            if raw is None:
                break
            recs = _records_from_raw(header, raw)
            for i in range(len(recs)):
                rid, pos = int(recs.ref_id[i]), int(recs.pos[i])
                if rid != ref_id or pos >= end:
                    # rid < 0 is the unmapped tail, which sorts last
                    if rid < 0 or rid > ref_id or (rid == ref_id and pos >= end):
                        return kept  # sorted: nothing further overlaps
                    continue  # an earlier ref, or before the chunk floor
                span = sum(n for n, op in recs.cigars[i] if op in "MDN=X") or 1
                if pos + span > beg:
                    # copy the row out: keeping (recs, i) would pin each
                    # parsed batch with a hit until output time
                    li = int(recs.lengths[i])
                    kept.append((
                        recs.names[i], int(recs.flags[i]), rid, pos,
                        int(recs.mapq[i]), int(recs.next_ref_id[i]),
                        int(recs.next_pos[i]), int(recs.tlen[i]), li,
                        recs.seq[i, :li].copy(), recs.qual[i, :li].copy(),
                        recs.cigars[i], recs.umi[i], recs.aux_raw[i],
                    ))
    finally:
        rdr.close()
    return kept


def rows_to_records(kept):
    """BamRecords of region_records' rows."""
    import numpy as np

    from duplexumiconsensusreads_torch.constants import BASE_PAD
    from duplexumiconsensusreads_torch.io.bam import BamRecords

    l_max = max((k[8] for k in kept), default=0)

    def _pad(row, fill):
        out = np.full(l_max, fill, np.uint8)
        out[: len(row)] = row
        return out

    return BamRecords(
        names=[k[0] for k in kept],
        flags=np.array([k[1] for k in kept], np.uint16),
        ref_id=np.array([k[2] for k in kept], np.int32),
        pos=np.array([k[3] for k in kept], np.int32),
        mapq=np.array([k[4] for k in kept], np.uint8),
        next_ref_id=np.array([k[5] for k in kept], np.int32),
        next_pos=np.array([k[6] for k in kept], np.int32),
        tlen=np.array([k[7] for k in kept], np.int32),
        lengths=np.array([k[8] for k in kept], np.int32),
        seq=(np.stack([_pad(k[9], BASE_PAD) for k in kept])
             if kept else np.zeros((0, 0), np.uint8)),
        qual=(np.stack([_pad(k[10], 0) for k in kept])
              if kept else np.zeros((0, 0), np.uint8)),
        cigars=[k[11] for k in kept],
        umi=[k[12] for k in kept],
        aux_raw=[k[13] for k in kept],
    )


def _cmd_view(args) -> int:
    """Region query through the standard .bai/.csi: the consuming side
    of ``index --bai`` / ``call --write-index`` (samtools-view analogue)."""
    import json

    from duplexumiconsensusreads_torch.io.bam import derive_output_header, write_bam
    from duplexumiconsensusreads_torch.runtime.stream import BamStreamReader

    rdr = BamStreamReader(args.input)
    header = rdr.header
    rdr.close()
    ref_id, beg, end, ref_name = parse_region(args.region, header)
    kept = region_records(args.input, header, ref_id, beg, end)
    if args.output:
        write_bam(args.output, derive_output_header(header, sort_order=None),
                  rows_to_records(kept))
    summary = {"region": f"{ref_name}:{beg + 1}-{end}", "n_records": len(kept)}
    if args.json:
        print(json.dumps(summary))
    else:
        print(
            f"[duplexumi-torch] {summary['n_records']} records overlap {summary['region']}"
            + (f" -> {args.output}" if args.output else ""),
            file=sys.stderr,
        )
    return 0
