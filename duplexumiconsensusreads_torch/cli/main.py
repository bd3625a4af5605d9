"""Command line: ``python -m duplexumiconsensusreads_torch call IN -o OUT
--config configN [--capacity N] [--report r.json] [--device cuda|cpu]
[--chunk-reads N ...]``.

The ``call`` of the JAX package's CLI, with its preset table: the
whole-file call, or with ``--chunk-reads N`` (N > 0) the streaming
executor and its flags under the JAX CLI's names. Flags of the JAX CLI
that this package does not implement (follow mode, ref projection,
whitelists, indexes, ...) are refused by name.
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
    s.add_argument("--max-reads", type=int, default=0,
                   help="cap each exact sub-family at this many reads (0 = off)")
    return p


# flags that only the streaming executor implements here
_STREAM_ONLY = {
    "checkpoint": None, "resume": False, "max_inflight": 4, "drain_workers": 2,
    "packed": "auto", "prefetch_depth": 2, "ingest_overlap": "auto",
    "trace": None, "heartbeat": 0.0, "profile": None, "max_reads": 0,
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


def main(argv=None) -> int:
    args, unknown = build_parser().parse_known_args(argv)
    if unknown:
        raise SystemExit(f"not supported by the torch port: {' '.join(unknown)}")
    gp, cp, capacity = params_for(args.config)
    if args.capacity is not None:
        if args.capacity < 1:
            raise SystemExit(f"--capacity must be >= 1 (got {args.capacity})")
        capacity = args.capacity
    if args.chunk_reads < 0:
        raise SystemExit(f"--chunk-reads must be >= 0 (got {args.chunk_reads})")
    if args.chunk_reads > 0:
        from duplexumiconsensusreads_torch.runtime.stream import stream_call_consensus

        rep = stream_call_consensus(
            args.input, args.output, gp, cp,
            capacity=capacity, chunk_reads=args.chunk_reads,
            max_inflight=args.max_inflight, drain_workers=args.drain_workers,
            checkpoint_path=args.checkpoint, resume=args.resume,
            report_path=args.report, profile_dir=args.profile,
            mate_aware=args.mate_aware, max_reads=args.max_reads,
            read_group=args.read_group_id, packed=args.packed,
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
            read_group=args.read_group_id, device=args.device,
        )
    print(
        f"[duplexumi-torch] {rep.n_records} records -> {rep.n_consensus} "
        f"consensus on {rep.device}",
        file=sys.stderr,
    )
    return 0
