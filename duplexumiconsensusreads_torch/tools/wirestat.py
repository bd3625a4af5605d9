"""Byte-ledger report for a streaming-executor trace capture.

Run: python -m duplexumiconsensusreads_torch.tools.wirestat trace.jsonl
       (per-chunk byte table, per-direction totals with packing /
        deflate ratios, measured bandwidth p50/p95/effective, the
        wire-floor decomposition, and the two byte sum-checks: ledger
        records vs the summary's running totals, and header/EOF
        overhead + shard wire bytes vs the finalised output's on-disk
        size — exit 1 on any drift, the byte analogue of
        trace_report.py's time sum-check)
     python -m duplexumiconsensusreads_torch.tools.wirestat trace.jsonl --json
       (the same analysis as one machine-readable JSON object)
     python -m duplexumiconsensusreads_torch.tools.wirestat trace.jsonl --out other.bam
       (check the on-disk size of a moved/renamed output instead of
        the path recorded in the capture)

The analysis lives in duplexumiconsensusreads_torch/telemetry/ledger.py;
this file is the CLI shell (same split as trace_report.py/report.py).
"""

from __future__ import annotations

import argparse
import json
import sys

# cap the human table; a 200M-read run has hundreds of chunks and the
# totals/percentiles already carry the verdict (--json is unabridged)
_TABLE_ROWS = 40


def _fmt_bytes(n) -> str:
    return f"{n:,}" if isinstance(n, int) else "-"


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m duplexumiconsensusreads_torch.tools.wirestat",
        description="per-chunk byte accounting / measured wire model "
        "for a `call --trace` capture",
    )
    ap.add_argument("trace", help="JSONL capture from call --trace")
    ap.add_argument(
        "--json", action="store_true",
        help="emit the analysis as one JSON object instead of text",
    )
    ap.add_argument(
        "--out", metavar="BAM", default=None,
        help="output BAM to size-check (default: the path recorded in "
        "the capture summary)",
    )
    args = ap.parse_args(argv)

    from duplexumiconsensusreads_torch.telemetry import ledger, report

    try:
        records = report.load_trace(args.trace)
    except (OSError, ValueError) as e:
        print(f"wirestat: {e}", file=sys.stderr)
        return 1
    problems = report.validate_trace(records)
    if problems:
        for p in problems:
            print(f"wirestat: invalid capture: {p}", file=sys.stderr)
        return 1

    # one record scan feeds every analysis below
    totals = ledger.byte_totals(records)
    rows, sum_ok = ledger.sum_check_bytes(records, totals=totals)
    disk_problems, disk_ok = ledger.output_check(
        records, out_path=args.out, totals=totals
    )
    fill = ledger.fill_stats(records)
    # the padding sum-check mirrors the byte one: fill rows recorded
    # per dispatch must reproduce the summary counters exactly
    fill_ok = fill.get("sum_check_ok", True)
    ok = sum_ok and disk_ok and fill_ok
    n_xfer = sum(t["n"] for t in totals.values())

    if args.json:
        print(json.dumps({
            "n_xfer_records": n_xfer,
            "totals": totals,
            "bandwidth": ledger.bandwidth_stats(records, totals=totals),
            "wire_floor": ledger.wire_floor(records, totals=totals),
            "packing": ledger.packing_stats(records, totals=totals),
            "chunks": ledger.per_chunk_bytes(records),
            "fill": fill,
            "overlap": ledger.overlap_stats(records),
            "devices": ledger.device_lanes(records),
            "summary_bytes": ledger.summary_bytes(records),
            "sum_check": {"ok": sum_ok, "rows": rows},
            "output_check": {"ok": disk_ok, "problems": disk_problems},
        }))
    else:
        if n_xfer == 0:
            # legal (tracing predates the ledger, or a zero-chunk run)
            # but worth saying out loud: every check below is vacuous
            print("capture holds no xfer records (pre-ledger capture?)")
        chunks = ledger.per_chunk_bytes(records)
        print(
            f"{'chunk':>6} {'h2d_logical':>12} {'h2d_wire':>12} "
            f"{'d2h_logical':>12} {'d2h_wire':>12} "
            f"{'shard_raw':>12} {'shard_wire':>12} {'fill':>6}  note"
        )
        for i, (chunk, row) in enumerate(chunks.items()):
            if i >= _TABLE_ROWS:
                print(f"  ... {len(chunks) - _TABLE_ROWS} more chunks "
                      f"(--json for all)")
                break
            h2d = row.get("h2d", {})
            d2h = row.get("d2h", {})
            shard = row.get("shard", {})
            note = "resumed" if shard.get("resumed") else ""
            # per-chunk bucket fill factor (the tuner's audit column);
            # "-" on pre-tuner captures and resume-reused chunks
            cfill = (
                f"{h2d['rows_real'] / h2d['rows_pad']:.2f}"
                if h2d.get("rows_pad") else "-"
            )
            print(
                f"{chunk:>6} {_fmt_bytes(h2d.get('logical', 0)):>12} "
                f"{_fmt_bytes(h2d.get('wire', 0)):>12} "
                f"{_fmt_bytes(d2h.get('logical', 0)):>12} "
                f"{_fmt_bytes(d2h.get('wire', 0)):>12} "
                f"{_fmt_bytes(shard.get('logical', 0)):>12} "
                f"{_fmt_bytes(shard.get('wire', 0)):>12} {cfill:>6}  {note}"
            )
        print()
        for direction in ledger.KNOWN_XFER_DIRS:
            t = totals.get(direction)
            if not t:
                continue
            extra = (
                f"  ({t['n_resumed']} resume-reused)" if t["n_resumed"] else ""
            )
            print(
                f"{direction:<6} n={t['n']:<5} logical={t['logical']:,} "
                f"wire={t['wire']:,} busy={t['busy_s']:.3f}s{extra}"
            )
        devs = ledger.device_lanes(records)
        if devs:
            # the mesh view: which device's share of the tunnel each
            # direction paid, and the mesh-alignment padding it shipped
            print(
                f"{'device':>8} {'h2d_wire':>12} {'d2h_wire':>12} "
                f"{'mesh_pad':>9}"
            )
            for lane, d in devs.items():
                print(
                    f"{lane:>8} {_fmt_bytes(d['h2d_wire']):>12} "
                    f"{_fmt_bytes(d['d2h_wire']):>12} {d['mesh_pad']:>9}"
                )
        if fill:
            verdict = "" if fill_ok else "  SUM-CHECK FAIL"
            mesh = (
                f" mesh_pad_buckets={fill['mesh_pad_buckets']:,}"
                if "mesh_pad_buckets" in fill else ""
            )
            print(
                f"fill: rows_real={fill['rows_real']:,} "
                f"rows_pad={fill['rows_pad']:,} "
                f"fill_factor={fill['fill_factor']}{mesh}{verdict}"
            )
        pack = ledger.packing_stats(records, totals=totals)
        if pack:
            print("packing: " + "  ".join(
                f"{k}={v}" for k, v in pack.items()
            ))
        bw = ledger.bandwidth_stats(records, totals=totals)
        for direction, b in bw.items():
            print(
                f"{direction} bandwidth: effective {b['effective_mb_s']} "
                f"MB/s  p50 {b['p50_mb_s']}  p95 {b['p95_mb_s']} "
                f"(per-transfer)"
            )
        fl = ledger.wire_floor(records, totals=totals)
        print(
            f"wire floor: h2d {fl['h2d_s']}s + d2h {fl['d2h_s']}s "
            f"(union {fl['floor_s']}s) over wall {fl['wall_s']}s "
            f"= frac {fl['frac']}"
        )
        ov = ledger.overlap_stats(records)
        if ov:
            # the ingest-overlap verdict: how much host-side chunk prep
            # the background producer hid behind device-facing work
            print(
                f"ingest overlap ({ov['mode']}): prep {ov['ingest_busy_s']}s "
                f"hidden {ov['overlap_s']}s = efficiency "
                f"{ov['efficiency']}  stall {ov['stall_s']}s  "
                f"backpressure {ov['backpressure_s']}s"
            )
        print()
        if rows:
            verdict = "OK" if sum_ok else "FAIL"
            print(f"byte sum-check (records vs summary totals): {verdict}")
            for r in rows:
                if not r["ok"]:
                    print(
                        f"  {r['key']}: records {r['records']:,} vs "
                        f"summary {r['summary']:,}"
                    )
        else:
            print("byte sum-check skipped (no summary: unclean shutdown)")
        if disk_ok:
            b = ledger.summary_bytes(records) or {}
            if "output_bytes" in b:
                print(
                    f"output check: OK (overhead + shard wire == "
                    f"{b['output_bytes']:,} bytes)"
                )
        else:
            print("output check: FAIL")
            for p in disk_problems:
                print(f"  {p}")

    if not ok:
        print(
            "BYTE LEDGER DRIFT: ledger records disagree with the summary "
            "totals or the on-disk output — instrumentation bug or file "
            "corruption",
            file=sys.stderr,
        )
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
