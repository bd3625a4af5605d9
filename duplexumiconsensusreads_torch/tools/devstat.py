"""Device-ledger report for a streaming-executor trace capture.

Run: python -m duplexumiconsensusreads_torch.tools.devstat trace.jsonl
       (per-bucket-class table — dispatches, buckets, executed FLOPs,
        device seconds, honest MFU, arithmetic intensity and the
        measured roofline verdict per class — plus the jit-compile
        ledger and the dev sum-check: record intervals must reproduce
        the summary's device_wait_fetch / dispatch phase totals —
        exit 1 on drift, the FLOP analogue of wirestat.py's byte
        sum-check)
     python -m duplexumiconsensusreads_torch.tools.devstat trace.jsonl --json
       (the same analysis as one machine-readable JSON object)
     python -m duplexumiconsensusreads_torch.tools.devstat trace.jsonl --peak-tflops 51.2
       (score against another card's peak; default is the shared
        table in telemetry/device.py keyed on the local CUDA device
        (its named default entry when there is none), and the
        DUT_PEAK_TFLOPS env override wins)

The analysis lives in duplexumiconsensusreads_torch/telemetry/
devledger.py; this file is the CLI shell (same split as wirestat.py /
ledger.py).
"""

from __future__ import annotations

import argparse
import json
import sys

# cap the human table; --json is unabridged (class count is naturally
# small — capacity rungs x read lengths — but a sweep capture can grow)
_TABLE_ROWS = 40


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m duplexumiconsensusreads_torch.tools.devstat",
        description="per-class FLOP accounting / measured roofline for "
        "a `call --trace` capture",
    )
    ap.add_argument("trace", help="JSONL capture from call --trace")
    ap.add_argument(
        "--json", action="store_true",
        help="emit the analysis as one JSON object instead of text",
    )
    ap.add_argument(
        "--peak-tflops", type=float, default=None, metavar="T",
        help="peak TFLOP/s to score MFU against (default: the shared "
        "device table resolved for the local device; DUT_PEAK_TFLOPS "
        "env override wins over the table)",
    )
    args = ap.parse_args(argv)

    from duplexumiconsensusreads_torch.telemetry import devledger, report
    from duplexumiconsensusreads_torch.telemetry.device import device_peak_flops

    try:
        records = report.load_trace(args.trace)
    except (OSError, ValueError) as e:
        print(f"devstat: {e}", file=sys.stderr)
        return 1
    problems = report.validate_trace(records)
    if problems:
        for p in problems:
            print(f"devstat: invalid capture: {p}", file=sys.stderr)
        return 1

    if args.peak_tflops is not None:
        peak, peak_entry = args.peak_tflops * 1e12, "cli"
    else:
        peak, peak_entry = device_peak_flops()

    classes = devledger.class_stats(records, peak_flops=peak)
    totals = devledger.device_totals(records, peak_flops=peak)
    roof = devledger.roofline(records, peak_flops=peak)
    compiles = devledger.compile_stats(records)
    rows, sum_ok = devledger.sum_check_dev(records)

    if args.json:
        print(json.dumps({
            "peak_flops": peak,
            "peak_entry": peak_entry,
            "classes": classes,
            "totals": totals,
            "roofline": roof,
            "compiles": compiles,
            "sum_check": {"ok": sum_ok, "rows": rows},
        }))
    else:
        if not totals:
            # legal (tracing predates the device ledger, or a zero-chunk
            # run) but worth saying out loud: every check is vacuous
            print("capture holds no dev records (pre-devledger capture?)")
        print(f"peak: {peak / 1e12:.0f} TFLOP/s ({peak_entry})")
        if roof:
            print(
                f"roofline: wire bw {roof['wire_bw_b_s'] / 1e6:.1f} MB/s  "
                f"ridge {roof['critical_intensity']} FLOP/B  "
                f"attainable frac {roof['attainable_frac']}"
            )
        if classes:
            print(
                f"{'class':>20} {'disp':>5} {'buckets':>8} {'GFLOP':>10} "
                f"{'dev_s':>8} {'mfu':>8} {'FLOP/B':>8}  verdict"
            )
            verdicts = (roof or {}).get("classes", {})
            for i, (key, d) in enumerate(classes.items()):
                if i >= _TABLE_ROWS:
                    print(f"  ... {len(classes) - _TABLE_ROWS} more classes "
                          f"(--json for all)")
                    break
                v = verdicts.get(key, {}).get("verdict", "-")
                print(
                    f"{key:>20} {d['n']:>5} {d['buckets']:>8} "
                    f"{d['flops'] / 1e9:>10.3f} {d['busy_s']:>8.3f} "
                    f"{d['mfu']:>8.2g} {d['intensity']:>8.1f}  {v}"
                )
        if totals:
            print(
                f"total: {totals['n']} dispatches  "
                f"{totals['flops'] / 1e9:.3f} GFLOP  "
                f"busy {totals['busy_s']:.3f}s  mfu {totals['mfu']:.2g}  "
                f"intensity {totals['intensity']:.1f} FLOP/B"
            )
        if compiles:
            print(
                f"jit compiles: {compiles['n_compiles']} "
                f"({compiles['compile_s']:.3f}s first-call wall)"
            )
            for key, d in compiles["per_class"].items():
                print(f"  {key}: n={d['n']} compile_s={d['compile_s']:.3f}")
        print()
        if rows:
            verdict = "OK" if sum_ok else "FAIL"
            print(f"dev sum-check (records vs phase totals): {verdict}")
            for r in rows:
                flag = "" if r["ok"] else "  <-- drift"
                print(
                    f"  {r['stage']}: records {r['records_s']}s vs "
                    f"summary {r['summary_s']}s{flag}"
                )
        else:
            print("dev sum-check skipped (no dev records)")

    if not sum_ok:
        print(
            "DEVICE LEDGER DRIFT: dev records disagree with the summary's "
            "phase totals — instrumentation bug or file corruption",
            file=sys.stderr,
        )
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
