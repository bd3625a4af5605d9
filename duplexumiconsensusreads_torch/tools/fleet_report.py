"""Fleet flight recorder CLI: stitch a fleet's service captures into
cross-daemon job timelines, aggregate fleet metrics, gate SLOs.

Run: python -m duplexumiconsensusreads_torch.tools.fleet_report SPOOL
       (discovers every service*.trace.jsonl[.prev] on the spool plus
        queue.json and the per-daemon metrics/ snapshots, stitches the
        per-job admission→terminal timelines, prints the fleet report,
        and writes durable SPOOL/fleet_metrics.json — exit 1 on any
        structural violation or sum-check drift, the fleet analogue of
        trace_report's time check and wirestat's byte check)
     python -m duplexumiconsensusreads_torch.tools.fleet_report CAPTURE [CAPTURE...]
       (capture-only mode: no journal/metrics cross-checks, no
        fleet_metrics.json write unless --out; run captures from
        per-job --trace may ride along for the Perfetto export)
     ... --json              one machine-readable JSON object
     ... --out PATH          fleet-metrics JSON destination ("-" skips)
     ... --prom PATH         Prometheus textfile exposition
     ... --chrome PATH       Perfetto export: one lane per daemon,
                             per-job colored slices (takeovers and
                             shard fan-out read as lane hops)
     ... --slo slo.toml --check-slo
                             evaluate declared SLO gates (p95 bounds,
                             deadline-hit-rate floors) — exit 1 on any
                             violated gate

The JAX package's tools/fleet_report.py, moved under the port package
(its arguments, output and exit codes unchanged: 0; 1 on drift or a
violated gate; 2 on usage errors) to read the port's ``serve.daemon``
captures. The analysis lives in duplexumiconsensusreads_torch/
telemetry/fleet.py; this file is the CLI shell. The device ledger's
peak is the port's (telemetry/device.py), so ``--json``'s
``device.peak_entry`` names an H100 entry.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _load_slo(path: str) -> dict:
    try:
        import tomllib
    except ModuleNotFoundError:  # stdlib tomllib is 3.11+
        try:
            import tomli as tomllib
        except ModuleNotFoundError:
            raise SystemExit(
                "fleet_report: reading --slo needs Python 3.11+ (stdlib "
                "tomllib) or the tomli package"
            )
    with open(path, "rb") as f:
        return tomllib.load(f)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m duplexumiconsensusreads_torch.tools.fleet_report",
        description="stitch N daemons' service captures into per-job "
        "cross-daemon timelines + fleet metrics + SLO gates",
    )
    ap.add_argument(
        "paths", nargs="+",
        help="a spool directory (captures/journal/metrics discovered) "
        "or explicit capture files (service and per-job run captures)",
    )
    ap.add_argument("--json", action="store_true",
                    help="one machine-readable JSON object")
    ap.add_argument(
        "--out", metavar="PATH", default=None,
        help="fleet-metrics JSON destination (default: "
        "SPOOL/fleet_metrics.json in spool mode, none in capture mode; "
        "'-' writes nowhere)",
    )
    ap.add_argument("--prom", metavar="PATH", default=None,
                    help="write a Prometheus textfile exposition here")
    ap.add_argument("--chrome", metavar="PATH", default=None,
                    help="write a Perfetto-openable fleet trace here")
    ap.add_argument("--slo", metavar="TOML", default=None,
                    help="declared SLO gates (see ARCHITECTURE.md "
                    "'Fleet observability' for the schema)")
    ap.add_argument(
        "--check-slo", action="store_true",
        help="evaluate --slo gates and exit 1 on any violation (the "
        "commit-time observability gate)",
    )
    args = ap.parse_args(argv)
    if args.check_slo and not args.slo:
        print("fleet_report: --check-slo needs --slo TOML", file=sys.stderr)
        return 2

    from duplexumiconsensusreads_torch.telemetry import chrome, fleet

    spool = None
    capture_paths: list[str] = []
    for p in args.paths:
        if os.path.isdir(p):
            if spool is not None:
                print("fleet_report: at most one spool directory",
                      file=sys.stderr)
                return 2
            spool = p
            capture_paths += fleet.discover_service_captures(p)
        else:
            capture_paths.append(p)
    if not capture_paths:
        print(
            f"fleet_report: no service captures found"
            + (f" on spool {spool}" if spool else ""),
            file=sys.stderr,
        )
        return 1

    try:
        captures = fleet.load_captures(capture_paths)
    except (OSError, ValueError) as e:
        print(f"fleet_report: {e}", file=sys.stderr)
        return 1
    journal = (
        fleet.load_journal(os.path.join(spool, "queue.json"))
        if spool else None
    )
    metrics_docs = fleet.load_metrics_docs(spool) if spool else []

    stitched = fleet.stitch(captures, journal=journal)
    metrics = fleet.fleet_metrics(stitched, metrics_docs=metrics_docs)
    # ingest-overlap efficiency aggregated over any per-run captures
    # that rode along ({} when none carry ingest spans)
    overlap = fleet.run_overlap(captures.get("run", ()))
    # per-class MFU aggregated the same way ({} when none carry dev
    # records — pre-devledger captures)
    device = fleet.run_device(captures.get("run", ()))

    slo_rows = None
    slo_ok = True
    if args.slo:
        try:
            slo_rows, slo_ok = fleet.check_slo(metrics, _load_slo(args.slo))
        except (OSError, ValueError) as e:
            print(f"fleet_report: --slo: {e}", file=sys.stderr)
            return 2

    # durable fleet-metrics artifact: the scrape/gate surface beside
    # the journal (same tmp+fsync+rename protocol as every spool write)
    out_path = args.out
    if out_path is None and spool is not None:
        out_path = os.path.join(spool, "fleet_metrics.json")
    if out_path and out_path != "-":
        from duplexumiconsensusreads_torch.io.durable import (
            unique_tmp,
            write_durable,
        )

        write_durable(
            out_path,
            json.dumps(metrics, sort_keys=True).encode(),
            tmp=unique_tmp(out_path),
        )
    if args.prom:
        with open(args.prom, "w") as f:
            f.write(fleet.render_prom(metrics))
    if args.chrome:
        doc = chrome.fleet_to_chrome(stitched, captures.get("run", ()))
        with open(args.chrome, "w") as f:
            json.dump(doc, f)

    if args.json:
        print(json.dumps({
            "jobs": stitched["jobs"],
            "metrics": metrics,
            "overlap": overlap,
            "device": device,
            "problems": stitched["problems"],
            "warnings": stitched["warnings"],
            "slo": slo_rows,
            "ok": stitched["ok"] and slo_ok,
        }, sort_keys=True))
    else:
        for line in fleet.render_report(stitched, metrics):
            print(line)
        if overlap:
            print()
            print(
                f"ingest overlap ({overlap['n_runs']} runs): prep "
                f"{overlap['ingest_busy_s']}s hidden "
                f"{overlap['overlap_s']}s = efficiency "
                f"{overlap['efficiency']}  stall {overlap['stall_s']}s  "
                f"backpressure {overlap['backpressure_s']}s"
            )
        if device:
            print()
            print(
                f"device ledger ({device['n_runs']} runs, peak "
                f"{device['peak_entry']}): {device['flops'] / 1e9:.3f} "
                f"GFLOP over {device['busy_s']:.3f}s busy = fleet mfu "
                f"{device['mfu']}"
            )
            for key, c in device["classes"].items():
                print(
                    f"  {key}: {c['flops'] / 1e9:.3f} GFLOP  "
                    f"busy {c['busy_s']:.3f}s  mfu {c['mfu']}"
                )
        if slo_rows is not None:
            print()
            for r in slo_rows:
                scope = f" class={r['class']}" if "class" in r else ""
                print(
                    f"slo {r['metric']}{scope}: {r['verdict'].upper()}"
                    + (f" (value {r['value']}, bound {r.get('bound')})"
                       if "value" in r else f" ({r.get('detail')})")
                )

    if not stitched["ok"]:
        print(
            "FLEET TIMELINE DRIFT: captures disagree with each other, "
            "the journal, or the admission→terminal sum-check — "
            "tampered/torn capture or instrumentation bug",
            file=sys.stderr,
        )
        return 1
    if args.check_slo and not slo_ok:
        print("SLO GATE FAILED", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
