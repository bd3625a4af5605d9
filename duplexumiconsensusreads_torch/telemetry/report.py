"""Offline analysis of a trace capture (the consuming side).

A capture (telemetry/trace.py JSONL) answers the question the
RunReport aggregate cannot: WHERE did the wall go. This module holds
the analysis shared by ``tools/trace_report.py`` (human CLI),
``tools/check_trace.py`` (CI schema validator), and ``benchmark.py``
(per-chunk percentiles in the BENCH JSON):

  - schema validation (``validate_trace``) — the capture format is a
    contract between recorder versions and these consumers;
  - per-lane utilization — busy seconds per thread over the wall, the
    direct reading of "which lane is the critical path";
  - per-stage latency percentiles (p50/p95/max of span durations);
  - per-chunk critical path — each chunk's stage chain reassembled
    from its spans, its end-to-end latency, and its dominant stage;
  - the sum-check — per-stage span totals must reproduce
    ``RunReport.seconds`` busy totals (the recorder logs the same
    measured dt), so a capture that disagrees with the report is
    evidence of an instrumentation bug, exactly like the
    busy > wall x pool canary in ``profile_phases.py``.
"""

from __future__ import annotations

import json

from duplexumiconsensusreads_torch.telemetry.trace import (
    KNOWN_DEV_FIELDS,
    KNOWN_EVENTS,
    KNOWN_STAGES,
    KNOWN_XFER_DIRS,
    TRACE_VERSION,
)

# RunReport.seconds keys that are not span-backed stage totals.
# DELIBERATELY narrower than runtime.executor._NON_STAGE_KEYS:
# main_loop_stall is excluded from the executor's busy-wall TABLE (it
# is blocked wall, not stage busy) but it IS recorded as spans here, so
# the sum-check must cover it — "syncing" this tuple with the
# executor's would silently drop stall accounting from the canary.
_NON_STAGE_KEYS = ("total", "drain_utilization")

# sum-check tolerance: |trace - report| <= abs + rel * report. The
# report rounds to 3 decimals and each span to 6, so honest captures
# agree to well under a millisecond per stage; the slack only absorbs
# that rounding, never a missing span.
_SUM_ABS_TOL = 0.02
_SUM_REL_TOL = 0.01


def load_trace(path: str) -> list[dict]:
    """Parse a JSONL capture. Raises ValueError naming the line on
    malformed JSON — a torn capture must fail loudly, not half-load."""
    records = []
    with open(path) as f:
        for i, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{i}: malformed trace line: {e}")
            records.append(rec)
    return records


# ------------------------------------------------------------ validation

def _is_num(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def validate_trace(records: list[dict]) -> list[str]:
    """Schema problems as human-readable strings; empty list = valid.

    A capture without a summary record is legal (the run crashed before
    clean shutdown) — everything else in the envelope is mandatory.
    """
    problems: list[str] = []
    if not records:
        return ["empty trace (no records)"]
    meta = records[0]
    if not isinstance(meta, dict) or meta.get("type") != "meta":
        problems.append("record 1: first record must be the meta header")
    elif meta.get("version") != TRACE_VERSION:
        problems.append(
            f"record 1: unsupported trace version {meta.get('version')!r} "
            f"(want {TRACE_VERSION})"
        )
    n_counted = 0
    n_summary = 0
    for i, rec in enumerate(records[1:], 2):
        if not isinstance(rec, dict):
            problems.append(f"record {i}: not a JSON object")
            continue
        kind = rec.get("type")
        if kind == "meta":
            problems.append(f"record {i}: duplicate meta header")
        elif kind == "span":
            stage = rec.get("stage")
            if stage not in KNOWN_STAGES:
                problems.append(f"record {i}: unknown span stage {stage!r}")
            if not _is_num(rec.get("t")) or rec["t"] < 0:
                problems.append(f"record {i}: span needs numeric t >= 0")
            if not _is_num(rec.get("dur")) or rec["dur"] < 0:
                problems.append(f"record {i}: span needs numeric dur >= 0")
            if not isinstance(rec.get("lane"), str) or not rec.get("lane"):
                problems.append(f"record {i}: span needs a non-empty lane")
            if "chunk" in rec and (
                not isinstance(rec["chunk"], int) or rec["chunk"] < 0
            ):
                problems.append(f"record {i}: span chunk must be an int >= 0")
            n_counted += 1
        elif kind == "event":
            name = rec.get("name")
            if name not in KNOWN_EVENTS:
                problems.append(f"record {i}: unknown event name {name!r}")
            if not _is_num(rec.get("t")) or rec["t"] < 0:
                problems.append(f"record {i}: event needs numeric t >= 0")
            if not isinstance(rec.get("lane"), str) or not rec.get("lane"):
                problems.append(f"record {i}: event needs a non-empty lane")
            if name != "truncated":
                n_counted += 1
        elif kind == "xfer":
            # byte-ledger record (telemetry/ledger.py): registered
            # direction, non-negative integer byte counts, the span
            # envelope. `logical` is optional (resume-reused shards
            # never re-derive their raw size) but must be integral
            # when present.
            if rec.get("dir") not in KNOWN_XFER_DIRS:
                problems.append(
                    f"record {i}: unknown xfer dir {rec.get('dir')!r}"
                )
            if not _is_num(rec.get("t")) or rec["t"] < 0:
                problems.append(f"record {i}: xfer needs numeric t >= 0")
            if not _is_num(rec.get("dur")) or rec["dur"] < 0:
                problems.append(f"record {i}: xfer needs numeric dur >= 0")
            if not isinstance(rec.get("wire"), int) or rec["wire"] < 0:
                problems.append(
                    f"record {i}: xfer needs integer wire bytes >= 0"
                )
            if "logical" in rec and (
                not isinstance(rec["logical"], int) or rec["logical"] < 0
            ):
                problems.append(
                    f"record {i}: xfer logical bytes must be an int >= 0"
                )
            if not isinstance(rec.get("lane"), str) or not rec.get("lane"):
                problems.append(f"record {i}: xfer needs a non-empty lane")
            if "chunk" in rec and (
                not isinstance(rec["chunk"], int) or rec["chunk"] < 0
            ):
                problems.append(f"record {i}: xfer chunk must be an int >= 0")
            n_counted += 1
        elif kind == "dev":
            # device-ledger record (telemetry/devledger.py): the span
            # envelope plus the registered dev fields — the class
            # identity integral, the FLOP/second accumulators numeric
            # and non-negative, no unregistered fields (the schema is
            # a closed registry, unlike event attrs: devstat's table
            # and sum-check read every field, so an unknown one is a
            # schema fork, not extra context)
            if not _is_num(rec.get("t")) or rec["t"] < 0:
                problems.append(f"record {i}: dev needs numeric t >= 0")
            if not _is_num(rec.get("dur")) or rec["dur"] < 0:
                problems.append(f"record {i}: dev needs numeric dur >= 0")
            if not isinstance(rec.get("lane"), str) or not rec.get("lane"):
                problems.append(f"record {i}: dev needs a non-empty lane")
            if "chunk" in rec and (
                not isinstance(rec["chunk"], int) or rec["chunk"] < 0
            ):
                problems.append(f"record {i}: dev chunk must be an int >= 0")
            for fk in ("cap", "cycles", "buckets", "h2d_wire", "d2h_wire"):
                fv = rec.get(fk)
                if not isinstance(fv, int) or isinstance(fv, bool) or fv < 0:
                    problems.append(
                        f"record {i}: dev {fk} must be an int >= 0"
                    )
            if not isinstance(rec.get("method"), str) or not rec.get("method"):
                problems.append(
                    f"record {i}: dev needs a non-empty method"
                )
            for fk in ("flops", "disp_s"):
                if not _is_num(rec.get(fk)) or rec[fk] < 0:
                    problems.append(
                        f"record {i}: dev {fk} must be numeric >= 0"
                    )
            for fk in rec:
                if fk in ("type", "t", "dur", "chunk", "lane"):
                    continue
                if fk not in KNOWN_DEV_FIELDS:
                    problems.append(
                        f"record {i}: unregistered dev field {fk!r}"
                    )
            n_counted += 1
        elif kind == "summary":
            n_summary += 1
            if i != len(records):
                problems.append(f"record {i}: summary must be the last record")
            sec = rec.get("seconds", {})
            if not isinstance(sec, dict):
                problems.append(f"record {i}: summary seconds must be a dict")
            else:
                for sk, sv in sec.items():
                    if not _is_num(sv):
                        problems.append(
                            f"record {i}: summary seconds[{sk!r}] is "
                            f"non-numeric"
                        )
            byt = rec.get("bytes")
            if byt is not None:
                if not isinstance(byt, dict):
                    problems.append(f"record {i}: summary bytes must be a dict")
                else:
                    for bk, bv in byt.items():
                        # byte totals are exact integers (the wirestat
                        # sum-check is phrased as equality, and floats
                        # would smuggle rounding slack into it); the
                        # output path tag is the one legal string
                        if bk == "output_path":
                            continue
                        if not isinstance(bv, int) or isinstance(bv, bool):
                            problems.append(
                                f"record {i}: summary bytes[{bk!r}] must "
                                f"be an integer"
                            )
            if isinstance(rec.get("n_events"), int) and rec["n_events"] != n_counted:
                problems.append(
                    f"record {i}: summary n_events={rec['n_events']} but the "
                    f"capture holds {n_counted} span/event records"
                )
        else:
            problems.append(f"record {i}: unknown record type {kind!r}")
    if n_summary > 1:
        problems.append(f"{n_summary} summary records (at most one allowed)")
    return problems


def capture_kind(records: list[dict]) -> str:
    """The capture's kind from its meta header: "run" (streaming
    executor, the default — pre-kind captures read as this) or
    "service" (a serve/ daemon capture)."""
    meta = records[0] if records else None
    if isinstance(meta, dict) and meta.get("type") == "meta":
        k = meta.get("kind")
        if isinstance(k, str) and k:
            return k
    return "run"


_JOB_EVENTS = (
    "job_accepted", "job_rejected", "job_shed", "job_started",
    "job_preempted", "job_completed", "job_failed",
    "lease_takeover", "job_fenced",
    # defensive serving: deadline expiries, poison quarantines and
    # watchdog aborts are per-job verdicts — anonymous ones cannot be
    # decomposed, same contract as every other job event
    "job_expired", "job_quarantined", "watchdog_fired",
    # scatter-gather sharding: the parent's stage completions are
    # job-scoped like every other lifecycle event
    "job_split", "job_merged",
)


def validate_service_trace(records: list[dict]) -> list[str]:
    """The service-capture contract on top of :func:`validate_trace`:
    every job-lifecycle event must name its job (``job`` attr) and be
    recorded on that job's lane (``job-<id>``), and every service
    heartbeat must carry the queue-depth/in-flight sample — a capture
    where job events are anonymous cannot be decomposed per job, which
    is the whole point of the service capture."""
    problems = validate_trace(records)
    if capture_kind(records) != "service":
        problems.append('meta header is not kind="service"')
    for i, rec in enumerate(records, 1):
        if not isinstance(rec, dict) or rec.get("type") != "event":
            continue
        name = rec.get("name")
        if name in _JOB_EVENTS:
            job = rec.get("job")
            if not isinstance(job, str) or not job:
                problems.append(
                    f"record {i}: {name} event without a job id attr"
                )
            elif rec.get("lane") != f"job-{job}":
                problems.append(
                    f"record {i}: {name} event for job {job!r} not on "
                    f"lane 'job-{job}' (got {rec.get('lane')!r})"
                )
        elif name == "heartbeat":
            for attr in ("queue_depth", "jobs_inflight"):
                if not _is_num(rec.get(attr)):
                    problems.append(
                        f"record {i}: service heartbeat lacks numeric "
                        f"{attr!r}"
                    )
    return problems


# -------------------------------------------------------------- analysis

def summary_record(records: list[dict]) -> dict | None:
    last = records[-1] if records else None
    return last if isinstance(last, dict) and last.get("type") == "summary" else None


def wall_seconds(records: list[dict]) -> float:
    """The capture's wall: the report's total when a summary is
    embedded, else the last span end / event time seen."""
    s = summary_record(records)
    if s is not None:
        total = (s.get("seconds") or {}).get("total")
        if _is_num(total) and total > 0:
            return float(total)
    end = 0.0
    for rec in records:
        if rec.get("type") in ("span", "xfer"):
            end = max(end, float(rec.get("t", 0)) + float(rec.get("dur", 0)))
        elif rec.get("type") in ("event", "summary"):
            end = max(end, float(rec.get("t", 0)))
    return end


def _pctl(sorted_vals: list[float], q: float) -> float:
    """Linear-interpolated quantile of an ascending list."""
    if not sorted_vals:
        return 0.0
    pos = q * (len(sorted_vals) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(sorted_vals) - 1)
    return sorted_vals[lo] + (sorted_vals[hi] - sorted_vals[lo]) * (pos - lo)


def stage_stats(records: list[dict]) -> dict[str, dict]:
    """Per stage: span count, busy total, and p50/p95/max duration."""
    durs: dict[str, list[float]] = {}
    for rec in records:
        if rec.get("type") == "span":
            durs.setdefault(rec["stage"], []).append(float(rec["dur"]))
    out = {}
    for stage in KNOWN_STAGES:  # stable stage order
        if stage not in durs:
            continue
        vals = sorted(durs[stage])
        out[stage] = {
            "count": len(vals),
            "total_s": round(sum(vals), 6),
            "p50_s": round(_pctl(vals, 0.50), 6),
            "p95_s": round(_pctl(vals, 0.95), 6),
            "max_s": round(vals[-1], 6),
        }
    return out


def lane_utilization(records: list[dict]) -> dict[str, dict]:
    """Busy seconds and busy/wall per lane. ``main_loop_stall``,
    ``ingest_stall``, ``ingest_backpressure`` and the follow-mode
    ``live_poll``/``live_wait`` spans are excluded — the thread is
    BLOCKED there, and counting blocked time as busy would hide
    exactly the condition the stall metrics exist to expose. A drain
    lane near 1.0 while main sits low reads as 'the drain pool is the
    critical path'."""
    wall = wall_seconds(records)
    busy: dict[str, float] = {}
    stalled: dict[str, float] = {}
    _stall_stages = (
        "main_loop_stall", "ingest_stall", "ingest_backpressure",
        "live_poll", "live_wait",
    )
    for rec in records:
        if rec.get("type") != "span":
            continue
        tgt = stalled if rec["stage"] in _stall_stages else busy
        lane = rec.get("lane", "?")
        tgt[lane] = tgt.get(lane, 0.0) + float(rec["dur"])
    out = {}
    for lane in sorted(set(busy) | set(stalled)):
        b = busy.get(lane, 0.0)
        out[lane] = {
            "busy_s": round(b, 6),
            "utilization": round(b / wall, 4) if wall else 0.0,
            "stall_s": round(stalled.get(lane, 0.0), 6),
        }
    return out


def chunk_critical_paths(records: list[dict]) -> dict[int, dict]:
    """Per chunk: its stage chain (time order), end-to-end latency from
    first span start to last span end, per-stage busy, and the dominant
    (busiest) stage — the chunk's critical-path verdict. Stall spans
    tagged with the chunk join its chain: a chunk whose 'dominant'
    stage is main_loop_stall was waiting on drain capacity, not work."""
    spans: dict[int, list[dict]] = {}
    for rec in records:
        if rec.get("type") == "span" and "chunk" in rec:
            spans.setdefault(int(rec["chunk"]), []).append(rec)
    out = {}
    for chunk in sorted(spans):
        rows = sorted(spans[chunk], key=lambda r: float(r["t"]))
        start = float(rows[0]["t"])
        end = max(float(r["t"]) + float(r["dur"]) for r in rows)
        stages: dict[str, float] = {}
        for r in rows:
            stages[r["stage"]] = stages.get(r["stage"], 0.0) + float(r["dur"])
        dominant = max(stages.items(), key=lambda kv: kv[1])[0]
        out[chunk] = {
            "chain": [(r["stage"], round(float(r["dur"]), 6)) for r in rows],
            "latency_s": round(end - start, 6),
            "busy_s": round(sum(stages.values()), 6),
            "stages": {k: round(v, 6) for k, v in stages.items()},
            "dominant": dominant,
        }
    return out


def chunk_latency_percentiles(records: list[dict]) -> dict:
    """p50/p95/max of per-chunk end-to-end latency (the number a
    serving SLO is written against), plus the dominant-stage histogram
    across chunks."""
    paths = chunk_critical_paths(records)
    lat = sorted(p["latency_s"] for p in paths.values())
    hist: dict[str, int] = {}
    for p in paths.values():
        hist[p["dominant"]] = hist.get(p["dominant"], 0) + 1
    return {
        "n_chunks": len(lat),
        "p50_s": round(_pctl(lat, 0.50), 6),
        "p95_s": round(_pctl(lat, 0.95), 6),
        "max_s": round(lat[-1], 6) if lat else 0.0,
        "dominant_stages": dict(
            sorted(hist.items(), key=lambda kv: -kv[1])
        ),
    }


def sum_check(
    records: list[dict], seconds: dict | None = None
) -> tuple[list[dict], bool]:
    """Per-stage span totals vs RunReport busy totals.

    ``seconds`` defaults to the capture's embedded summary. Returns
    (rows, ok); rows carry stage/trace_s/report_s/ok. Stages the report
    knows but the capture never saw (and vice versa) fail the check
    unless both sides are ~zero.

    A capture TRUNCATED by the bounded recorder (summary n_dropped > 0)
    cannot account for the spans it dropped, so its totals are a lower
    bound, not a sum: the check degrades to one-sided — only an
    impossible EXCESS (trace > report) fails, never a shortfall. That
    keeps 'exit 1' meaning instrumentation rot, exactly as documented,
    instead of punishing the designed disk-space bound."""
    dropped = int((summary_record(records) or {}).get("n_dropped") or 0)
    if seconds is None:
        s = summary_record(records)
        seconds = (s or {}).get("seconds") or {}
    stats = stage_stats(records)
    rows = []
    ok_all = True
    stages = [k for k in seconds if k not in _NON_STAGE_KEYS]
    stages += [k for k in stats if k not in seconds]
    for stage in stages:
        trace_s = stats.get(stage, {}).get("total_s", 0.0)
        # callers can hand in report JSONs too: a non-numeric entry is
        # a mismatch to surface in the rows, never a TypeError
        rv = seconds.get(stage, 0.0)
        report_s = float(rv) if _is_num(rv) else 0.0
        tol = _SUM_ABS_TOL + _SUM_REL_TOL * report_s
        if dropped:
            ok = trace_s <= report_s + tol
        else:
            ok = abs(trace_s - report_s) <= tol
        ok_all &= ok
        rows.append({
            "stage": stage,
            "trace_s": round(trace_s, 3),
            "report_s": round(report_s, 3),
            "ok": ok,
        })
    return rows, ok_all


# ------------------------------------------------------------- rendering

def render_report(records: list[dict]) -> tuple[list[str], bool]:
    """The human report ``tools/trace_report.py`` prints. Returns
    (lines, ok) — ok is False when the sum-check fails."""
    lines: list[str] = []
    n_spans = sum(1 for r in records if r.get("type") == "span")
    n_events = sum(1 for r in records if r.get("type") == "event")
    s = summary_record(records)
    dropped = (s or {}).get("n_dropped", 0)
    wall = wall_seconds(records)
    lines.append(
        f"capture: {n_spans} spans, {n_events} events, {dropped} dropped; "
        f"wall {wall:.3f}s"
        + ("" if s else "  [no summary record: run did not shut down cleanly]")
    )

    lines.append("")
    lines.append(f"{'lane':<10} {'busy_s':>9} {'util':>6} {'stall_s':>9}")
    for lane, u in lane_utilization(records).items():
        lines.append(
            f"{lane:<10} {u['busy_s']:9.3f} {u['utilization']:6.2f} "
            f"{u['stall_s']:9.3f}"
        )

    lines.append("")
    lines.append(
        f"{'stage':<18} {'count':>6} {'total_s':>9} {'p50_s':>8} "
        f"{'p95_s':>8} {'max_s':>8}"
    )
    for stage, st in stage_stats(records).items():
        lines.append(
            f"{stage:<18} {st['count']:6d} {st['total_s']:9.3f} "
            f"{st['p50_s']:8.4f} {st['p95_s']:8.4f} {st['max_s']:8.4f}"
        )

    pct = chunk_latency_percentiles(records)
    lines.append("")
    lines.append(
        f"chunk critical path: n={pct['n_chunks']} latency "
        f"p50={pct['p50_s']:.3f}s p95={pct['p95_s']:.3f}s "
        f"max={pct['max_s']:.3f}s"
    )
    for stage, n in pct["dominant_stages"].items():
        lines.append(f"  dominant in {n}/{pct['n_chunks']} chunks: {stage}")

    ok = True
    if s is not None and s.get("seconds"):
        rows, ok = sum_check(records)
        bad = [r for r in rows if not r["ok"]]
        lines.append("")
        mode = (
            f"one-sided, {dropped} records dropped by the bounded capture"
            if dropped
            else "exact"
        )
        if ok:
            lines.append(
                f"sum-check vs RunReport.seconds: OK "
                f"({len(rows)} stages within tolerance; {mode})"
            )
        else:
            lines.append(f"sum-check vs RunReport.seconds: FAIL ({mode})")
            for r in bad:
                lines.append(
                    f"  {r['stage']}: trace {r['trace_s']}s vs report "
                    f"{r['report_s']}s"
                )
    return lines, ok
