"""Race of the ssc reduction methods on one device.

Times the FUSED pipeline (the only honest scope: a reduction method's
cost depends on what surrounds it in the pipeline) on one
representative dispatch-class geometry, sweeping ssc_method and the
blockseg tile height, through ``tuning.race_ssc_methods``. Runs on the
card by default:

    python -m duplexumiconsensusreads_torch.tools.tune_ssc
    python -m duplexumiconsensusreads_torch.tools.tune_ssc \\
        --methods segment_gemm,blockseg --blockseg-t 64,128,256
    python -m duplexumiconsensusreads_torch.tools.tune_ssc --device cpu

Prints one table row per method on stderr (step seconds, reads/s) and
the winner, and the result as one JSON object on the LAST stdout line
(``--json PATH`` also writes it to a file). No card raises: ``--device
cpu`` is the only way to the CPU. The measured tables live in PERF.md,
each beside the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import sys


def build_result(race: dict) -> dict:
    """The tool's JSON contract around a tuning.race_ssc_methods result:
    the per-method table verbatim plus the winner, stamped with the
    tool's schema version. Pure function — unit-testable without a
    device race."""
    return {
        "tool": "tune_ssc",
        "version": 2,
        "backend": race["backend"],
        "n_reads": race["n_reads"],
        "capacity": race["capacity"],
        "reps": race["reps"],
        "methods": race["methods"],
        # the method the executors could default to on THIS device for
        # this FLOP mix (the race always measures the live kernels)
        "winner": race["winner"],
        "winner_method": race["winner_method"],
    }


def main(argv: list[str] | None = None) -> int:
    from duplexumiconsensusreads_torch.tuning.tuner import RACE_METHODS

    ap = argparse.ArgumentParser(
        prog="python -m duplexumiconsensusreads_torch.tools.tune_ssc",
        description="offline ssc-method race (fused pipeline, live "
        "kernels) — prints a table and a final JSON line with the "
        "winner",
    )
    ap.add_argument(
        "--json", metavar="PATH", default=None,
        help="also write the result JSON here (stdout always carries "
        "it as the LAST line)",
    )
    ap.add_argument(
        "--reps", type=int, default=6,
        help="timed repetitions per method (default 6)",
    )
    ap.add_argument(
        "--molecules", type=int, default=22_000,
        help="simulated molecules for the race workload (default 22000)",
    )
    ap.add_argument(
        "--capacity", type=int, default=2048,
        help="bucket capacity of the race geometry (default 2048)",
    )
    ap.add_argument(
        "--methods", default=",".join(RACE_METHODS),
        help="comma-separated ssc methods to race ('segment', the "
        "kernel's plain version, only when named)",
    )
    ap.add_argument(
        "--blockseg-t", default="64,128,256,512",
        help="blockseg tile heights to sweep (comma-separated)",
    )
    ap.add_argument(
        "--device", default="cuda",
        help="torch device to race on (default cuda; cpu only when asked)",
    )
    args = ap.parse_args(argv)

    from duplexumiconsensusreads_torch.tuning import race_ssc_methods

    race = race_ssc_methods(
        methods=tuple(m for m in args.methods.split(",") if m),
        blockseg_ts=tuple(
            int(t) for t in args.blockseg_t.split(",") if t
        ),
        reps=args.reps,
        n_molecules=args.molecules,
        capacity=args.capacity,
        device=args.device,
    )
    for label, row in race["methods"].items():
        print(
            f"{label:16s} step={row['step_s']:.3f}s  "
            f"{row['reads_per_sec'] / 1e6:.3f}M reads/s",
            file=sys.stderr,
        )
    print(
        f"winner: {race['winner']} ({race['backend']} backend)",
        file=sys.stderr,
    )
    result = build_result(race)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
