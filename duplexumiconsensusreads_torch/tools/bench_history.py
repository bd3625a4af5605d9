"""Bench trajectory report + regression gate over the port's recorded
bench rounds (``BENCH_torch_rNN.json``).

Run: python -m duplexumiconsensusreads_torch.tools.bench_history
       (default: every BENCH_torch_r[0-9]*.json in --dir, in round
        order — prints the canonical-metric trajectory table with the
        last-round delta; rounds whose parse failed are salvaged
        per-key)
     ... --check [--threshold 0.5]
       (the GATE: exit 1 when a gate metric's latest reading regresses
        beyond the threshold against the previous round that measured
        it — wired into the bench so a regression fails the run
        visibly)
     ... --candidate fresh.json
       (append a bench RESULT json — e.g. the bench's own
        <cache>/bench_full.json — as the newest round; with --check
        this gates a fresh run against the recorded trajectory)
     ... --json
       (the trajectory + gate verdict as one JSON object)
     ... BENCH_a.json BENCH_b.json
       (these files in this order instead of the default glob)

The JAX package's tools/bench_history.py with the same flags, output
and exit codes (2: no files, or one unreadable); only the default
trajectory differs (duplexumiconsensusreads_torch/benchhist.py holds
the analysis).
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m duplexumiconsensusreads_torch.tools.bench_history",
        description="canonical bench-metric trajectory over the port's "
        "BENCH_torch_rNN.json rounds, with a regression gate",
    )
    ap.add_argument(
        "paths", nargs="*",
        help="round files in round order (default: "
        "BENCH_torch_r[0-9]*.json in --dir)",
    )
    ap.add_argument("--dir", default=".", help="where to glob the "
                    "default trajectory files (default: cwd)")
    ap.add_argument(
        "--candidate", metavar="JSON", default=None,
        help="a bench result JSON to append as the newest round",
    )
    ap.add_argument("--json", action="store_true", help="machine-readable")
    ap.add_argument(
        "--check", action="store_true",
        help="exit 1 when a gate metric regressed beyond --threshold",
    )
    ap.add_argument(
        "--threshold", type=float, default=0.5,
        help="fractional regression bound for --check (default 0.5; "
        "loose on purpose — host-clock numbers spread between runs)",
    )
    ap.add_argument(
        "--metric", action="append", dest="metrics", metavar="KEY",
        help="gate this metric instead of the defaults (repeatable)",
    )
    args = ap.parse_args(argv)

    from duplexumiconsensusreads_torch import benchhist

    paths = args.paths or benchhist.default_paths(args.dir)
    if args.candidate:
        paths = list(paths) + [args.candidate]
    if not paths:
        print("bench_history: no BENCH_torch_rNN.json files found", file=sys.stderr)
        return 2
    rounds = []
    for p in paths:
        try:
            rounds.append(benchhist.load_round(p))
        except (OSError, ValueError) as e:
            print(f"bench_history: {p}: {e}", file=sys.stderr)
            return 2

    ok, problems = benchhist.check_regression(
        rounds, threshold=args.threshold, metrics=args.metrics
    )
    if args.json:
        print(json.dumps({
            "trajectory": benchhist.trajectory(rounds),
            "salvaged": [r["name"] for r in rounds if r["salvaged"]],
            "gate": {
                "checked": bool(args.check), "ok": ok,
                "threshold": args.threshold, "problems": problems,
            },
        }))
    else:
        for line in benchhist.render_table(rounds):
            print(line)
        if args.check:
            if ok:
                print(
                    f"gate: OK (no gate metric regressed more than "
                    f"{args.threshold * 100:.0f}% vs its previous reading)"
                )
            else:
                print("gate: FAIL")
                for p in problems:
                    print(f"  {p}")
    if args.check and not ok:
        print(
            "BENCH REGRESSION: canonical metrics fell beyond the "
            "threshold — see the trajectory above",
            file=sys.stderr,
        )
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
