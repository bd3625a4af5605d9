"""Decompose the fused-pipeline step time on one device: time the bench
geometry under config variants that drop one stage each — exact
grouping (no Hamming/closure), no cycle error model (one ssc pass
instead of two) — to see which device stage owns the step.

    python -m duplexumiconsensusreads_torch.tools.profile_phases [--device cpu]
    python -m duplexumiconsensusreads_torch.tools.profile_phases --report report.json
      (render a ``call --report`` / streaming RunReport JSON as
       overlapped busy-time vs wall columns; any stage whose busy time
       exceeds wall x its pool size is flagged BUSY>WALL and exits 1 —
       an accounting-bug canary, since that is impossible with honest
       monotonic clocks)

The JAX package's tools/profile_phases.py on torch. The profile runs on
the card; ``--device cpu`` is the only way to the CPU. DUT_PROF_READS
(540000: the JAX tool's 60,000 molecules over 1,250 positions),
DUT_PROF_CAPACITY (2048) and DUT_PROF_REPS (8) resize it. Prints one
row per variant and the result as one JSON object on the LAST stdout
line. Measured rows live in PERF.md, each beside the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def report_busy_wall(path: str) -> int:
    """Print the overlapped busy-vs-wall table for a RunReport JSON
    (from ``call --report``). Exit status 1 when any stage's busy time
    exceeds wall x pool — the accounting-bug canary for CI.

    Tolerant of older report shapes: whole-file reports lack "total",
    early streaming reports main_loop_stall / drain_utilization /
    n_drain_workers; every absent field renders as its neutral default
    instead of a KeyError."""
    from duplexumiconsensusreads_torch.runtime.executor import busy_wall_table

    with open(path) as f:
        rep = json.load(f)
    if not isinstance(rep, dict) or not isinstance(rep.get("seconds", {}), dict):
        print(f"{path}: not a RunReport JSON (no seconds dict)", file=sys.stderr)
        return 1
    dw = rep.get("n_drain_workers", 1)
    if not isinstance(dw, int) or isinstance(dw, bool):
        dw = 1
    lines, bugs = busy_wall_table(rep.get("seconds", {}) or {}, drain_workers=max(dw, 1))
    for ln in lines:
        print(ln)
    if bugs:
        print(
            f"ACCOUNTING BUG: stage(s) {', '.join(bugs)} report more busy "
            f"time than wall x pool allows",
            file=sys.stderr,
        )
        return 1
    return 0


def variants() -> list:
    """[(name, GroupingParams, ConsensusParams)]: config5 and the
    variants that drop one stage each, as the JAX tool runs them."""
    from duplexumiconsensusreads_torch.types import ConsensusParams, GroupingParams

    adj = GroupingParams(strategy="adjacency", paired=True)
    exact = GroupingParams(strategy="exact", paired=True)
    cycle = ConsensusParams(mode="duplex", error_model="cycle", min_duplex_reads=1)
    plain = ConsensusParams(mode="duplex", error_model=None, min_duplex_reads=1)
    return [
        ("full config5 (adj+cycle)", adj, cycle),
        ("no error model (adj)", adj, plain),
        ("exact grouping + cycle", exact, cycle),
        ("exact, no error model", exact, plain),
    ]


def profile(device=None) -> dict:
    """Each variant's step time on ``device`` (the card unless "cpu" is
    asked for; no card raises): the batch bucketed per variant, every
    class stacked onto the device once, ``fused_pipeline`` over every
    class DUT_PROF_REPS times after one untimed call, one synchronize as
    the barrier."""
    import numpy as np
    import torch

    from duplexumiconsensusreads_torch.benchmark import bench_batch, device_classes, time_step
    from duplexumiconsensusreads_torch.bucketing import build_buckets
    from duplexumiconsensusreads_torch.ops.pipeline import fused_pipeline
    from duplexumiconsensusreads_torch.runtime.executor import resolve_device

    dev = resolve_device(device)
    n_target = int(os.environ.get("DUT_PROF_READS", 540_000))
    capacity = int(os.environ.get("DUT_PROF_CAPACITY", 2048))
    reps = int(os.environ.get("DUT_PROF_REPS", 8))
    _, _, batch, _, _ = bench_batch(n_target)
    n_reads = int(np.asarray(batch.valid).sum())
    rows = {}
    with torch.no_grad():
        for name, gp, cp in variants():
            buckets = build_buckets(batch, capacity=capacity, grouping=gp)
            classes = device_classes(buckets, gp, cp, None, dev)
            method = classes[0][1].ssc_method
            dt = time_step(lambda: [fused_pipeline(*a, s) for _, s, a in classes], dev, reps)
            del classes
            rows[name] = {"step_s": dt, "reads_per_sec": round(n_reads / dt, 1)}
            print(f"{name:28s} step={dt:.3f}s  {n_reads/dt/1e6:.3f}M reads/s")
    return {"tool": "profile_phases", "device": str(dev), "n_reads": n_reads,
            "capacity": capacity, "reps": reps, "ssc_method": method, "rows": rows}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m duplexumiconsensusreads_torch.tools.profile_phases",
        description="fused-pipeline stage variants on the bench geometry, or "
        "a RunReport's busy-vs-wall table (--report)",
    )
    ap.add_argument("--report", metavar="REPORT_JSON", default=None,
                    help="render this RunReport JSON instead of profiling")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the profile (default cuda; cpu only when asked)")
    args = ap.parse_args(argv)
    if args.report is not None:
        return report_busy_wall(args.report)
    print(json.dumps(profile(args.device)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
