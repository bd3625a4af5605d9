"""Where grouping's directional_cluster kernel spends its time, phase by
phase, at the main path's slot table, on one card.

    python scripts/cluster_phases.py [--reads 600000] [--reps 20] [--json OUT]

The input is ``chip_smoke.py``'s whole-file one (config5, read_len 150,
family size 4, umi_error 0.01, duplex, seed 7, ``--reads`` reads,
``n_positions = n_molecules // 48``), called once through
``call_consensus_file`` at capacity 2048 on the card; the slot table of
its largest dispatch class (the one ``kernels/grouping.py`` hands
``directional_cluster``, (280, 512, W 1) at the default size) is kept.
Then:

- ``table``: the table's shape: valid slots, position groups and their
  sizes, in-group pairs and edges, per bucket (max, median, mean);
- ``occupancy``: the kernel's threads a block, shared memory, blocks an
  SM (CUDA's occupancy query) and the waves the class takes on the card;
- ``phases``: the kernel built from the same source with
  ``-DDUT_CLUSTER_PHASES`` (``cluster_fixpoint.directional_cluster_stamped``):
  thread 0 of every block stamps ``clock64()`` at the end of each phase.
  Per phase, the cycles of the median block and of the slowest blocks
  (by their whole span), the fixpoint's sweeps, the SMs the blocks ran
  on, the blocks each SM held, and the span of the launch by
  ``%globaltimer``;
- ``times``: the default (stamp-free) kernel's and the stamped kernel's
  device ms, CUDA events over ``--reps`` launches after a warm-up, the
  card first spinning until the host has queued them all; the default
  wrapper's ms back to back as a caller sees it (host work included);
  the outputs of both builds against the plain version at tolerance 0.

``ncu`` cannot read counters on the machine this runs on, so no
achieved occupancy or warp-stall reasons are reported. Prints one JSON
line per part and the card's ``nvidia-smi`` name and power limit; the
whole result goes to ``--json`` too. A card is required.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
I32_MAX = 2**31 - 1
# stamp row layout (csrc/cluster_fixpoint.cu)
SWEEPS, SMID, T_START, T_END, MODE, EDGES = 10, 11, 12, 13, 14, 15


def spread(values) -> dict:
    values = sorted(values)
    if not values:
        return {"n": 0}
    return {"n": len(values), "max": values[-1], "median": statistics.median(values),
            "mean": sum(values) / len(values), "min": values[0]}


def table_shape(u_words, u_pos, u_cnt, umi_len, max_hamming, count_ratio) -> dict:
    """The slot table's groups, pairs and edges (the plain edge build's
    grid, one bucket at a time)."""
    import torch

    from duplexumiconsensusreads_torch.kernels import cluster_fixpoint as cf

    n, u, w = u_words.shape
    sizes, pairs, edges, valid, groups = [], [], [], [], []
    for b in range(n):
        p = u_pos[b][u_pos[b] != I32_MAX]
        _, size = torch.unique_consecutive(p, return_counts=True)
        size = size.long().tolist()
        sizes += size
        groups.append(len(size))
        valid.append(int(p.numel()))
        pairs.append(sum(s * (s - 1) // 2 for s in size))
        edge, _ = cf.cluster_edges_plain(u_words[b:b + 1], u_pos[b:b + 1], u_cnt[b:b + 1],
                                         umi_len, max_hamming, count_ratio)
        edges.append(int(edge.sum()))
    return {"shape": [n, u, w], "group_size": spread(sizes), "groups_per_bucket": spread(groups),
            "valid_slots_per_bucket": spread(valid), "in_group_pairs_per_bucket": spread(pairs),
            "in_group_pairs": sum(pairs), "edges_per_bucket": spread(edges),
            "edges": sum(edges)}


def phase_split(stamps, names: list) -> dict:
    """Per-phase cycles from the stamp rows: the median block's, the
    slowest blocks' (by whole span), and each phase's share of the sum
    of all blocks' spans."""
    rows = stamps.cpu().tolist()
    k = len(names)
    per = [[r[i + 1] - r[i] for i in range(k)] for r in rows]
    span = [r[k] - r[0] for r in rows]
    order = sorted(range(len(rows)), key=lambda b: span[b])
    med = order[len(order) // 2]
    total = sum(span) or 1
    by_sm = {}
    for r in rows:
        by_sm[r[SMID]] = by_sm.get(r[SMID], 0) + 1
    t0 = min(r[T_START] for r in rows)
    return {
        "phases": names,
        "median_block": {"bucket": med, "cycles": dict(zip(names, per[med])),
                         "span_cycles": span[med], "sweeps": rows[med][SWEEPS]},
        "slowest_blocks": [{"bucket": b, "cycles": dict(zip(names, per[b])),
                            "span_cycles": span[b], "sweeps": rows[b][SWEEPS],
                            "edges": rows[b][EDGES], "fixpoint_mode": rows[b][MODE],
                            "start_ns": rows[b][T_START] - t0, "end_ns": rows[b][T_END] - t0}
                           for b in order[::-1][:5]],
        "share_of_all_spans": {n: sum(p[i] for p in per) / total for i, n in enumerate(names)},
        "span_cycles": spread(span),
        "sweeps": spread([r[SWEEPS] for r in rows]),
        # the fixpoint's mode a block: bit 0 the in-neighbour list was
        # used, bit 1 (the current kernel) the edge masks were kept, bit
        # 2 the list was written from them
        "fixpoint_modes": {str(m): sum(r[MODE] == m for r in rows)
                           for m in sorted({r[MODE] for r in rows})},
        "sms_used": len(by_sm), "blocks_per_sm": spread(list(by_sm.values())),
        "launch_span_ns": max(r[T_END] for r in rows) - t0,
        "latest_block_start_ns": max(r[T_START] for r in rows) - t0,
    }


def nvidia_smi() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def main_table(reads: int, td: str, device: str = "cuda"):
    """The largest class's slot table of the whole-file call on the
    smoke's input, as directional_cluster received it (cloned)."""
    import torch

    from duplexumiconsensusreads_torch.cli.main import params_for
    from duplexumiconsensusreads_torch.io import simulated_bam
    from duplexumiconsensusreads_torch.kernels import grouping
    from duplexumiconsensusreads_torch.runtime.executor import call_consensus_file
    from duplexumiconsensusreads_torch.simulate import SimConfig

    n_mol = reads // 9
    in_bam = os.path.join(td, "in.bam")
    simulated_bam(SimConfig(n_molecules=n_mol, read_len=150, n_positions=max(8, n_mol // 48),
                            mean_family_size=4, umi_error=0.01, duplex=True, seed=7),
                  path=in_bam, sort=True)
    gp, cp, _ = params_for("config5")
    kept = {}
    inner = grouping.directional_cluster

    def keep(*args):
        if args[0].numel() > kept.get("size", -1):
            kept.update(size=args[0].numel(),
                        args=[a.clone() if isinstance(a, torch.Tensor) else a for a in args])
        return inner(*args)

    grouping.directional_cluster = keep
    try:
        call_consensus_file(in_bam, os.path.join(td, "out.bam"), gp, cp, capacity=2048,
                            device=device)
    finally:
        grouping.directional_cluster = inner
    return kept["args"]


def cuda_ms(fn, reps: int, queue_ahead: bool) -> float:
    """Mean ms of ``fn`` over ``reps`` calls by CUDA events; with
    ``queue_ahead`` the card first spins until the host has queued every
    call (chip_smoke.cuda_ms), so the kernel's device time alone."""
    import time

    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if queue_ahead:
        t0 = time.perf_counter()
        fn()
        host_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        torch.cuda._sleep(int(10 * reps * host_s * 2e9))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reads", type=int, default=600_000)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("cluster_phases: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from duplexumiconsensusreads_torch.kernels import build
    from duplexumiconsensusreads_torch.kernels import cluster_fixpoint as cf

    smi = nvidia_smi()
    print(smi, flush=True)
    build.build_all()
    build.build_all(("cluster_fixpoint",), (cf.PHASES_MACRO,))
    result = {"nvidia_smi": smi, "device": torch.cuda.get_device_name(0)}
    with tempfile.TemporaryDirectory(prefix="cluster_phases_") as td:
        table = main_table(args.reads, td)
    n, u, w = table[0].shape
    result["table"] = table_shape(*table)
    print(json.dumps({"part": "table", **result["table"]}), flush=True)

    in_smem, scratch = cf.cluster_plan(u, w)
    per_sm = cf.cluster_blocks_per_sm(u, w)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    result["occupancy"] = {
        "shared_memory_bytes": cf.cluster_smem_bytes(u, w, in_smem, scratch),
        "table_in_smem": in_smem, "scratch_bytes": scratch, "blocks_per_sm": per_sm, "sms": sms,
        "blocks": n, "waves": -(-n // max(1, per_sm * sms))}
    print(json.dumps({"part": "occupancy", **result["occupancy"]}), flush=True)

    want = cf.directional_cluster_plain(*table)
    got = cf.directional_cluster(*table)
    (st_out, stamps, names) = cf.directional_cluster_stamped(*table)
    torch.cuda.synchronize()
    for name, out in (("kernel", got), ("stamped", st_out)):
        if not all(torch.equal(a, b) for a, b in zip(out, want)):
            raise AssertionError(f"the {name} directional_cluster differs from the plain version")
    result["phases"] = phase_split(stamps, names)
    print(json.dumps({"part": "phases", **result["phases"]}), flush=True)

    result["times"] = {
        "kernel_ms": cuda_ms(lambda: cf.directional_cluster(*table), args.reps, True),
        "stamped_ms": cuda_ms(lambda: cf.directional_cluster_stamped(*table), args.reps, True),
        "call_ms": cuda_ms(lambda: cf.directional_cluster(*table), args.reps, False),
        "reps": args.reps, "max_abs_err": 0, "tolerance": 0}
    print(json.dumps({"part": "times", **result["times"], "nvidia_smi": smi}), flush=True)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
