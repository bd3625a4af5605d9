"""Analyse a streaming-executor trace capture (`call --trace`).

Run: python -m duplexumiconsensusreads_torch.tools.trace_report trace.jsonl
       (human report: per-lane utilization, per-stage p50/p95/max,
        the per-chunk critical path, and the sum-check of span totals
        against the embedded RunReport.seconds busy totals — exit 1
        when the capture and the report disagree, the telemetry twin
        of profile_phases.py's busy>wall canary)
     python -m duplexumiconsensusreads_torch.tools.trace_report trace.jsonl --json
       (the same analysis as one machine-readable JSON object)
     python -m duplexumiconsensusreads_torch.tools.trace_report trace.jsonl --chrome out.json
       (also export Chrome trace events; open out.json in
        https://ui.perfetto.dev to see every lane as a track)

The analysis lives in duplexumiconsensusreads_torch/telemetry/report.py;
this file is the CLI shell.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m duplexumiconsensusreads_torch.tools.trace_report",
        description="critical path / utilization / percentile report "
        "for a `call --trace` capture",
    )
    ap.add_argument("trace", help="JSONL capture from call --trace")
    ap.add_argument(
        "--json", action="store_true",
        help="emit the analysis as one JSON object instead of text",
    )
    ap.add_argument(
        "--chrome", metavar="OUT_JSON",
        help="also export the capture as Chrome trace events (Perfetto)",
    )
    args = ap.parse_args(argv)

    from duplexumiconsensusreads_torch.telemetry import chrome, report

    try:
        records = report.load_trace(args.trace)
    except (OSError, ValueError) as e:
        print(f"trace_report: {e}", file=sys.stderr)
        return 1
    problems = report.validate_trace(records)
    if problems:
        for p in problems:
            print(f"trace_report: invalid capture: {p}", file=sys.stderr)
        return 1

    if args.chrome:
        n = chrome.write_chrome(records, args.chrome)
        print(f"[trace_report] wrote {n} Chrome trace events → {args.chrome}",
              file=sys.stderr)

    if args.json:
        # same guard as the text path: a summary-less capture (crashed
        # run — legal post-mortem evidence) has nothing to sum-check
        # against and must not exit 1 as if instrumentation rotted
        s = report.summary_record(records)
        if s is not None and s.get("seconds"):
            rows, ok = report.sum_check(records)
            sum_out = {"ok": ok, "rows": rows}
        else:
            ok = True
            sum_out = {"ok": True, "rows": [],
                       "skipped": "no summary record (unclean shutdown)"}
        out = {
            "wall_s": report.wall_seconds(records),
            "lanes": report.lane_utilization(records),
            "stages": report.stage_stats(records),
            "chunks": report.chunk_latency_percentiles(records),
            "sum_check": sum_out,
        }
        print(json.dumps(out))
        return 0 if ok else 1

    lines, ok = report.render_report(records)
    for ln in lines:
        print(ln)
    if not ok:
        print(
            "TRACE/REPORT MISMATCH: per-stage span totals disagree with "
            "RunReport.seconds — instrumentation bug",
            file=sys.stderr,
        )
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
