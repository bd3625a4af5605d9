"""Profile one whole-file call on every card of the host with
``torch.profiler`` and say where each card's time went.

    python scripts/mesh_profile.py [--reads 600000] [--lanes N] [--json OUT]

The input is ``scripts/ab_checkouts.py``'s (config5, read_len 150,
family size 4, umi_error 0.01, seed 7, ``--reads`` reads). One untimed
whole-file call on the lanes comes first (no profiled call pays a
card's first use or a class's first sight), then the profiled one,
capacity 2048, ``--lanes`` lanes (default: every card). From the
profiler's trace of the consensus stage it prints one JSON line: the
call's wall, the stage's window (first to last device kernel), and for
each card its kernels, busy ms (the union of its kernel intervals) and
idle share of the window, and the longest gap between two of its
kernels; with the host's busiest operations (total ms of the CPU
operations of each name). Needs a card.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import tempfile
import time


def _busy(intervals: list) -> float:
    total, end = 0.0, None
    for t0, t1 in sorted(intervals):
        if end is None or t0 > end:
            total += t1 - t0
            end = t1
        elif t1 > end:
            total += t1 - end
            end = t1
    return total


def summarize(trace: dict) -> dict:
    """Per-card busy and idle time, and the host's busiest operations,
    from a chrome trace ``torch.profiler`` exported (times in us)."""
    kernels = collections.defaultdict(list)
    host = collections.Counter()
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        if ev.get("cat") == "kernel":
            kernels[int(ev["args"]["device"])].append((ev["ts"], ev["ts"] + ev["dur"]))
        elif ev.get("cat") == "cpu_op":
            host[ev["name"]] += ev["dur"]
    if not kernels:
        raise RuntimeError("the profile holds no device kernel")
    t0 = min(a for iv in kernels.values() for a, _ in iv)
    t1 = max(b for iv in kernels.values() for _, b in iv)
    window = t1 - t0
    cards = {}
    for dev, iv in sorted(kernels.items()):
        iv.sort()
        busy = _busy(iv)
        gaps = [b[0] - a[1] for a, b in zip(iv, iv[1:])]
        cards[f"cuda:{dev}"] = {"kernels": len(iv), "busy_ms": busy / 1e3,
                                "idle_share": 1 - busy / window,
                                "longest_gap_ms": max(gaps, default=0) / 1e3}
    return {"window_ms": window / 1e3, "cards": cards,
            "host_ops_ms": {k: v / 1e3 for k, v in host.most_common(12)}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reads", type=int, default=600_000)
    ap.add_argument("--lanes", type=int, help="lanes (default: every card)")
    ap.add_argument("--json", help="write the result here too")
    a = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("mesh_profile: no CUDA device", file=sys.stderr)
        return 2
    this = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path[:0] = [this, os.path.join(this, "scripts")]
    from ab_checkouts import simulate

    from duplexumiconsensusreads_torch.cli.main import params_for
    from duplexumiconsensusreads_torch.kernels import build
    from duplexumiconsensusreads_torch.runtime.executor import call_consensus_file

    build.build_all()
    lanes = a.lanes or torch.cuda.device_count()
    gp, cp, _ = params_for("config5")
    with tempfile.TemporaryDirectory(prefix="mesh_profile_") as td:
        in_bam = os.path.join(td, "in.bam")
        simulate(in_bam, a.reads)
        kw = dict(capacity=2048, device="cuda", n_devices=lanes)
        call_consensus_file(in_bam, os.path.join(td, "warm.bam"), gp, cp, **kw)
        prof = os.path.join(td, "prof")
        t0 = time.monotonic()
        call_consensus_file(in_bam, os.path.join(td, "out.bam"), gp, cp, profile_dir=prof, **kw)
        wall = time.monotonic() - t0
        with open(os.path.join(prof, "trace.json")) as f:
            res = summarize(json.load(f))
    res = {"reads": a.reads, "lanes": lanes, "wall_s": wall,
           "device": torch.cuda.get_device_name(0), **res}
    print(json.dumps(res), flush=True)
    if a.json:
        with open(a.json, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
