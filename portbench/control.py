#!/usr/bin/env python3
"""The control of a cell's check: the reference computed a precision
below the configuration's (bfloat16 for its float32) put in the
program's place, compared with the reference as the check compares
the program: on the cell's own inputs, its own sample of buckets,
seed by seed. Its numbers set the upper readings of the limits in
``limits/<cell>.json``; the program's runs set the lower ones.

    python3 portbench/control.py --workload <cell> --seeds 11,12,13 [--device cuda]

Prints one line a seed and, last, a JSON summary.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DTYPES = {"float32": "bfloat16", "float64": "float32"}


def control_numbers(bench: dict, name: str, seed: int, device: str = "cpu",
                    dtype: str | None = None) -> dict:
    import torch

    from portbench.gen.sim import simulate
    from portbench.lib import cell, compare
    from portbench.reference.consensus import expected_records
    from portbench.reference.partition import all_buckets

    wl, config, traffic = cell.cell_parts(bench, name)
    low = getattr(torch, dtype or DTYPES[config.get("precision", "float32")])
    ctx = cell.Ctx(name=name, workload=wl, config=config, traffic=traffic, seed=seed,
                   seconds=0.0, trace=False)
    ctx.reads = simulate(config["sim"], seed)
    buckets = all_buckets(ctx.reads.pos, ctx.reads.umi, int(traffic.get("chunk_reads", 0)),
                          int(config["capacity"]), config["grouping"]["strategy"] != "exact",
                          int(traffic.get("max_chunks", 0)))
    # the first bucket of each dispatch class joins the sample, as in a run
    driver = cell.load_module(os.path.join(cell.PKG, "drivers", traffic["driver"] + ".py"),
                              "portbench_driver_" + traffic["driver"])
    heads = ()
    if hasattr(driver, "form_classes"):
        ctx.device = torch.device(device)
        ctx.state["classes"] = driver.form_classes(ctx)[0]
        heads = driver.class_heads(ctx)
        ctx.state.clear()
    pick = [buckets[i][0] for i in cell.sample_buckets(ctx, buckets, heads)]
    ref = expected_records(ctx.reads, pick, config["grouping"], config["consensus"],
                           device=device)
    ctl = expected_records(ctx.reads, pick, config["grouping"], config["consensus"],
                           dtype=low, device=device)
    return compare.compare(ref, ctl)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    rows = {}
    for s in args.seeds.split(","):
        rows[s] = control_numbers(bench, args.workload, int(s), args.device)
        print(f"control {args.workload} seed {s}: {json.dumps(rows[s])}", flush=True)
    print(json.dumps({"workload": args.workload, "device": args.device, "seeds": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
