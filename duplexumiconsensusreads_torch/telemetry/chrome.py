"""Chrome trace-event exporter: open a capture in Perfetto.

Maps a JSONL capture (telemetry/trace.py) onto the Trace Event Format
consumed by https://ui.perfetto.dev and chrome://tracing — spans become
complete ('X') slices, point events become instants ('i'), byte-ledger
xfer records become counter ('C') tracks of bytes-in-flight per lane,
device-ledger dev records become FLOP/s counter tracks (the roofline's
numerator, live under the timeline), and each LANE becomes one named
pseudo-thread so the main loop,
transfer workers, and every drain worker render as parallel tracks. That
side-by-side rendering is the whole point: overlap that hides the
critical path in aggregate numbers is visible at a glance.

Timestamps: trace seconds (monotonic-relative) -> microseconds, the
unit the format requires.
"""

from __future__ import annotations

import json
import os

# one synthetic process for the whole capture
_PID = 1


def _lane_order(lane: str) -> tuple:
    """Stable track order: main first, then xfer, then drain, then any
    stray lanes, each numerically within its pool."""
    for rank, prefix in ((0, "main"), (1, "xfer-"), (2, "drain-")):
        if lane == prefix or lane.startswith(prefix):
            tail = lane[len(prefix):]
            return (rank, int(tail) if tail.isdigit() else 0, lane)
    return (3, 0, lane)


def to_chrome(records) -> dict:
    """Convert parsed capture records to a Chrome trace-event dict.

    ``records`` is any iterable of the dicts a JSONL capture holds
    (``telemetry.report.load_trace`` output). Returns the JSON-object
    form ({"traceEvents": [...]}), which Perfetto accepts directly.
    """
    spans, instants, xfers, devs, lanes = [], [], [], [], set()
    for rec in records:
        kind = rec.get("type")
        if kind not in ("span", "event", "xfer", "dev"):
            continue
        lane = rec.get("lane", "?")
        lanes.add(lane)
        # "dur" maps onto the X-event field for spans only; on point
        # events (e.g. durable_write's fsync cost) it is a payload
        # attribute and must survive into args
        drop = ("type", "stage", "name", "t", "lane")
        drop += ("dur",) if kind == "span" else ()
        args = {k: v for k, v in rec.items() if k not in drop}
        if kind == "span":
            spans.append((rec, lane, args))
        elif kind == "xfer":
            xfers.append((rec, lane))
        elif kind == "dev":
            devs.append((rec, lane))
        else:
            instants.append((rec, lane, args))

    tid = {
        lane: i + 1 for i, lane in enumerate(sorted(lanes, key=_lane_order))
    }
    events = [
        {
            "name": "process_name", "ph": "M", "pid": _PID, "tid": 0,
            "args": {"name": "duplexumi streaming executor"},
        }
    ]
    for lane, t in tid.items():
        events.append({
            "name": "thread_name", "ph": "M", "pid": _PID, "tid": t,
            "args": {"name": lane},
        })
        events.append({
            "name": "thread_sort_index", "ph": "M", "pid": _PID, "tid": t,
            "args": {"sort_index": t},
        })
    for rec, lane, args in spans:
        events.append({
            "name": rec.get("stage", "?"), "cat": "stage", "ph": "X",
            "ts": round(float(rec.get("t", 0.0)) * 1e6, 3),
            "dur": round(float(rec.get("dur", 0.0)) * 1e6, 3),
            "pid": _PID, "tid": tid[lane], "args": args,
        })
    for rec, lane, args in instants:
        events.append({
            "name": rec.get("name", "?"), "cat": "event", "ph": "i",
            "ts": round(float(rec.get("t", 0.0)) * 1e6, 3),
            "pid": _PID, "tid": tid[lane], "s": "t", "args": args,
        })
    # byte-ledger records render as COUNTER tracks ("C"): each transfer
    # raises "<dir>_bytes (<lane>)" to its wire size for its span and
    # drops it back to zero at the end, so Perfetto shows H2D/D2H
    # bytes-in-flight per lane right under the span timeline — transfer
    # pressure next to the time it cost. Counter identity is (pid,
    # name); the lane rides in the name because tids don't key counters.
    for rec, lane in xfers:
        name = f"{rec.get('dir', '?')}_bytes ({lane})"
        t0 = round(float(rec.get("t", 0.0)) * 1e6, 3)
        t1 = round(
            (float(rec.get("t", 0.0)) + float(rec.get("dur", 0.0))) * 1e6, 3
        )
        wire = int(rec.get("wire", 0))
        events.append({
            "name": name, "cat": "xfer", "ph": "C", "ts": t0,
            "pid": _PID, "tid": tid[lane], "args": {"bytes": wire},
        })
        events.append({
            "name": name, "cat": "xfer", "ph": "C", "ts": t1,
            "pid": _PID, "tid": tid[lane], "args": {"bytes": 0},
        })
    # device-ledger records render as a FLOP/s counter track: each dev
    # record raises "device_gflops_s (<class>)" to its average rate
    # (flops/dur) for its device-wait window and drops it back to zero
    # — so Perfetto shows WHICH bucket class the card was earning on at
    # any instant, right under the span timeline. Same raise/drop
    # pattern as the byte counters; the class rides in the name because
    # counter identity is (pid, name).
    for rec, lane in devs:
        cap = int(rec.get("cap", 0))
        name = (
            f"device_gflops_s (c{cap}xL{int(rec.get('cycles', 0))}/"
            f"{rec.get('method', '?')})"
        )
        t0 = round(float(rec.get("t", 0.0)) * 1e6, 3)
        dur = float(rec.get("dur", 0.0))
        t1 = round((float(rec.get("t", 0.0)) + dur) * 1e6, 3)
        rate = float(rec.get("flops", 0.0)) / dur / 1e9 if dur > 0 else 0.0
        events.append({
            "name": name, "cat": "dev", "ph": "C", "ts": t0,
            "pid": _PID, "tid": tid[lane], "args": {"gflops_s": round(rate, 3)},
        })
        events.append({
            "name": name, "cat": "dev", "ph": "C", "ts": t1,
            "pid": _PID, "tid": tid[lane], "args": {"gflops_s": 0},
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome(records, out_path: str) -> int:
    """Export ``records`` as a Chrome trace JSON file; returns the
    number of traceEvents written."""
    doc = to_chrome(records)
    with open(out_path, "w") as f:
        json.dump(doc, f)
    return len(doc["traceEvents"])


# ------------------------------------------------------------ fleet view

def fleet_to_chrome(stitched: dict, run_captures=()) -> dict:
    """Render stitched fleet timelines (telemetry/fleet.py) as Chrome
    trace events: ONE LANE PER DAEMON whose slices are named by job id
    (Perfetto colors slices by name hash, so each job keeps its color
    as it hops lanes — a takeover or a shard fan-out is visible as the
    same color resuming on another daemon's track), plus one lane per
    job carrying its full admission→terminal decomposition (segments
    AND attributed gaps). Per-job run captures, when provided
    (``--trace`` jobs), add their per-chunk spans on a ``run:`` lane
    aligned by their own ``epoch_m``."""
    jobs = stitched["jobs"]
    # one shared origin so Perfetto's clock starts near zero
    t0s = []
    for tl in jobs.values():
        if tl["admission_us"] is not None:
            t0s.append(tl["admission_us"])
        t0s += [s["t0_us"] for s in tl["segments"]]
    origin = min(t0s) if t0s else 0

    lanes = sorted(stitched["daemons"])
    job_lanes = [f"job {j}" for j in sorted(jobs)]
    run_lanes = [f"run:{os.path.basename(c['path'])}" for c in run_captures]
    tid = {}
    events = [{
        "name": "process_name", "ph": "M", "pid": _PID, "tid": 0,
        "args": {"name": "duplexumi fleet"},
    }]
    for i, lane in enumerate(
        [f"daemon {d}" for d in lanes] + job_lanes + run_lanes
    ):
        tid[lane] = i + 1
        events.append({
            "name": "thread_name", "ph": "M", "pid": _PID, "tid": i + 1,
            "args": {"name": lane},
        })
        events.append({
            "name": "thread_sort_index", "ph": "M", "pid": _PID,
            "tid": i + 1, "args": {"sort_index": i + 1},
        })

    def _x(name, t0_us, t1_us, lane, cat, args):
        events.append({
            "name": name, "cat": cat, "ph": "X",
            "ts": round((t0_us - origin), 3),
            "dur": round((t1_us - t0_us), 3),
            "pid": _PID, "tid": tid[lane], "args": args,
        })

    for job_id in sorted(jobs):
        tl = jobs[job_id]
        for s in tl["segments"]:
            args = {k: v for k, v in s.items() if k not in ("t0_us", "t1_us")}
            lane = f"daemon {s['daemon']}"
            if lane in tid:
                _x(job_id, s["t0_us"], s["t1_us"], lane, "segment", args)
            _x(f"{s['kind']} ({s['daemon'][:12]})", s["t0_us"], s["t1_us"],
               f"job {job_id}", "segment", args)
        for g in tl["gaps"]:
            _x(f"gap:{g['kind']}", g["t0_us"], g["t1_us"],
               f"job {job_id}", "gap", {})
    for cap in run_captures:
        lane = f"run:{os.path.basename(cap['path'])}"
        epoch = cap["epoch_us"] or 0
        for rec in cap["records"]:
            if not isinstance(rec, dict) or rec.get("type") != "span":
                continue
            t0 = epoch + round(float(rec.get("t", 0)) * 1e6)
            t1 = t0 + round(float(rec.get("dur", 0)) * 1e6)
            args = {k: v for k, v in rec.items()
                    if k not in ("type", "stage", "t", "dur")}
            _x(rec.get("stage", "?"), t0, t1, lane, "stage", args)
    return {"traceEvents": events, "displayTimeUnit": "ms"}
