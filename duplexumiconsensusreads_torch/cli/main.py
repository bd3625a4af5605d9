"""Command line: ``python -m duplexumiconsensusreads_torch call IN -o OUT
--config configN [--capacity N] [--report r.json] [--device cuda|cpu]``.

The whole-file ``call`` of the JAX package's CLI, with its preset table.
Flags of the JAX CLI that this package does not implement (streaming,
ref projection, whitelists, indexes, ...) are refused by name.
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
    return p


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
        raise SystemExit(
            f"not supported by the torch port (whole-file call only): {' '.join(unknown)}"
        )
    from duplexumiconsensusreads_torch.runtime.executor import call_consensus_file

    gp, cp, capacity = params_for(args.config)
    if args.capacity is not None:
        if args.capacity < 1:
            raise SystemExit(f"--capacity must be >= 1 (got {args.capacity})")
        capacity = args.capacity
    rep = call_consensus_file(
        args.input, args.output, gp, cp,
        capacity=capacity, report_path=args.report, device=args.device,
    )
    print(
        f"[duplexumi-torch] {rep.n_records} records -> {rep.n_consensus} "
        f"consensus on {rep.device}",
        file=sys.stderr,
    )
    return 0
