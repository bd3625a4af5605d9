"""Component-share profile of the fused pipeline on one device.

Times the bench compute workload (benchmark.py's compute leg: config5,
adjacency grouping, paired duplex, the cycle error model) under
ablations, each a spec variant of every dispatch class, so the device
work is ranked before it is attacked (ROADMAP queue 2 part B):

  full         grouping + ssc + error model (2nd ssc) + duplex (the bench path)
  no_errmodel  no error model: removes the fit-pass ssc + fit + capped re-ssc
  exact_group  exact grouping: no Hamming product, no closure (not
               semantically equivalent, purely a timer)
  ss_mode      single-strand mode: the duplex merge ablated

The JAX package's tools/profile_components.py on torch. Runs on the
card; ``--device cpu`` is the only way to the CPU (plain kernel
versions). DUT_PROF_READS (600000), DUT_PROF_CAPACITY (2048) and
DUT_PROF_REPS (10) resize it:

    python -m duplexumiconsensusreads_torch.tools.profile_components
    python -m duplexumiconsensusreads_torch.tools.profile_components --device cpu

Prints one row per ablation (ms per step, M reads/s), the shares
against ``full``, and the result as one JSON object on the LAST stdout
line. Measured rows live in PERF.md, each beside the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os


def ablations(spec) -> list:
    """[(label, spec)] of one dispatch class: the class spec and each
    ablation's variant of it. The JAX tool's "no_errmodel" passes
    error_model="none", which its pipeline reads as no model; the
    port's pipeline refuses an unknown model name, so the variant
    carries None (the same computation)."""
    rep = dataclasses.replace
    return [
        ("full", spec),
        ("no_errmodel", rep(spec, consensus=rep(spec.consensus, error_model=None))),
        ("exact_group", rep(spec, grouping=rep(spec.grouping, strategy="exact"))),
        ("ss_mode", rep(spec, consensus=rep(spec.consensus, mode="single_strand"))),
    ]


def profile(device=None) -> dict:
    """Every ablation's step time over the bench workload's dispatch
    classes on ``device`` (the card unless "cpu" is asked for; no card
    raises): each class stacked onto the device once, ``fused_pipeline``
    over every class DUT_PROF_REPS times after one untimed call, one
    synchronize as the barrier. Prints the JAX tool's rows."""
    import numpy as np
    import torch

    from duplexumiconsensusreads_torch.benchmark import bench_batch, device_classes, time_step
    from duplexumiconsensusreads_torch.bucketing import build_buckets
    from duplexumiconsensusreads_torch.ops.pipeline import fused_pipeline
    from duplexumiconsensusreads_torch.runtime.executor import resolve_device

    dev = resolve_device(device)
    n_target = int(os.environ.get("DUT_PROF_READS", 600_000))
    capacity = int(os.environ.get("DUT_PROF_CAPACITY", 2048))
    reps = int(os.environ.get("DUT_PROF_REPS", 10))

    gp, cp, batch, _, _ = bench_batch(n_target)
    n_reads = int(np.asarray(batch.valid).sum())
    buckets = build_buckets(batch, capacity=capacity, grouping=gp)
    # the JAX tool races the TPU default (matmul); the port's is the
    # device's own default method
    classes = device_classes(buckets, gp, cp, None, dev)
    method = classes[0][1].ssc_method
    class_rows = []
    for cbuckets, cspec, args in classes:
        class_rows.append({"n_buckets": args[0].shape[0], "capacity": cbuckets[0].capacity,
                           "u_max": cspec.u_max, "f_max": cspec.f_max,
                           "grouping": cspec.grouping.strategy})
        print(f"# class: n_buckets={args[0].shape[0]} capacity={cbuckets[0].capacity}"
              f" u_max={cspec.u_max} f_max={cspec.f_max} grouping={cspec.grouping.strategy}")

    variants = [ablations(cspec) for _, cspec, _ in classes]
    rows = {}
    with torch.no_grad():
        for i, (label, _) in enumerate(variants[0]):
            def run_all(i=i):
                return [fused_pipeline(*args, v[i][1]) for (_, _, args), v in zip(classes, variants)]

            dt = time_step(run_all, dev, reps)
            rows[label] = {"step_s": dt, "ms": round(dt * 1e3, 3),
                           "reads_per_sec": round(n_reads / dt, 1)}
            print(f"{label:14s} {dt*1e3:8.1f} ms  {n_reads/dt/1e6:6.3f} M reads/s")
    t_full = rows["full"]["step_s"]
    shares = {
        "errmodel_2nd_pass": round(100 * (t_full - rows["no_errmodel"]["step_s"]) / t_full, 1),
        "adjacency_machinery": round(100 * (t_full - rows["exact_group"]["step_s"]) / t_full, 1),
        "duplex_merge": round(100 * (t_full - rows["ss_mode"]["step_s"]) / t_full, 1),
    }
    print("# shares vs full: " + " ".join(f"{k}={v:.1f}%" for k, v in shares.items()))
    return {
        "tool": "profile_components", "device": str(dev), "n_reads": n_reads,
        "capacity": capacity, "reps": reps, "ssc_method": method, "classes": class_rows,
        "rows": rows, "shares_pct": shares,
    }


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m duplexumiconsensusreads_torch.tools.profile_components",
        description="stage ablations of the fused pipeline on the bench workload",
    )
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu only when asked)")
    args = ap.parse_args(argv)
    print(json.dumps(profile(args.device)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
