"""Schema validator for telemetry captures (CI gate).

Run: python -m duplexumiconsensusreads_torch.tools.check_trace trace.jsonl [--require-summary]

Exit 0 when the capture conforms to the telemetry contract
(telemetry/trace.py: meta header first, known span stages and event
names, byte-ledger xfer records with registered directions and
integer byte counts, numeric non-negative timestamps, one terminal
summary whose n_events matches the record count and whose byte totals
are integers); exit 1 listing every violation otherwise.
``--require-summary`` additionally fails a capture that
lacks the terminal summary record — i.e. one from a run that did not
shut down cleanly: a finished run's capture must be COMPLETE, not
merely well-formed.

The capture KIND is read from the meta header: a ``run`` capture (the
streaming executor's per-chunk spans, the default) gets the core
checks; a ``service`` capture (a ``dut-serve`` daemon's job-lifecycle
record) additionally must keep every job event — including the fleet
events ``job_shed``, ``lease_takeover`` and ``job_fenced`` — on its
job-scoped ``job-<id>`` lane and every service heartbeat carrying the
queue snapshot (the JAX package's serving layer writes such captures;
the rules are kept here so one validator reads both kinds).

The rules live in telemetry/report.py (validate_trace /
validate_service_trace) so the CLI, the tier-1 tests, and the report
tools all enforce the same contract.
"""

from __future__ import annotations

import argparse
import sys


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m duplexumiconsensusreads_torch.tools.check_trace",
        description="validate a `call --trace` capture against the "
        "telemetry schema",
    )
    ap.add_argument("trace", help="JSONL capture from call --trace")
    ap.add_argument(
        "--require-summary", action="store_true",
        help="also fail captures without the terminal summary record "
        "(runs that did not shut down cleanly)",
    )
    args = ap.parse_args(argv)

    from duplexumiconsensusreads_torch.telemetry import report

    try:
        records = report.load_trace(args.trace)
    except (OSError, ValueError) as e:
        print(f"check_trace: {e}", file=sys.stderr)
        return 1
    kind = report.capture_kind(records)
    if kind == "service":
        problems = report.validate_service_trace(records)
    else:
        problems = report.validate_trace(records)
    if args.require_summary and report.summary_record(records) is None:
        problems.append("no terminal summary record (unclean shutdown?)")
    if problems:
        for p in problems:
            print(f"check_trace: {args.trace}: {p}", file=sys.stderr)
        return 1
    n_spans = sum(1 for r in records if r.get("type") == "span")
    n_events = sum(1 for r in records if r.get("type") == "event")
    n_xfer = sum(1 for r in records if r.get("type") == "xfer")
    n_dev = sum(1 for r in records if r.get("type") == "dev")
    print(
        f"[check_trace] {args.trace}: OK "
        f"({kind} capture, {n_spans} spans, {n_events} events, "
        f"{n_xfer} xfer, {n_dev} dev)",
        file=sys.stderr,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
