"""Summarise a serve daemon's service capture (kind="service" JSONL).

Run: python -m duplexumiconsensusreads_torch.tools.serve_report SPOOL/service.<id>.trace.jsonl [--json]

The JAX package's tools/serve_report.py, moved under the port package
(its output, flags and exit codes unchanged) to read the port's
``serve.daemon`` captures. One word changed meaning: "warm" is the
worker's warm-signature start (the kernel libraries loaded and the
allocator warm for the job's bucket spec, serve/worker.py), where the
JAX package counts jit-cache hits.

The service capture records the daemon's whole life: admissions,
per-job slices/preemptions/completions on ``job-<id>`` lanes, service
heartbeats carrying the queue snapshot, and every switchboard event
(fault/retry/durable) that fired while jobs ran. This tool decomposes
it the way ``trace_report.py`` decomposes a run capture:

  * per job: state, slices, preemptions, lease takeovers, fenced
    (zombie) slices, total slice wall, final chunk/consensus counts,
    warm or cold start, and the per-phase busy
    seconds the completing slice reported;
  * service: admission/shed/completion/failure counts, preemption and
    takeover totals, warm-start rate, queue-depth curve
    (max/mean over the heartbeats), retry/fault event counts.

Exit 1 on a capture that fails the service schema
(telemetry/report.validate_service_trace) — a malformed capture must
fail CI the same way a malformed run capture does.
"""

from __future__ import annotations

import argparse
import json
import sys


def summarize(records: list[dict]) -> dict:
    jobs: dict[str, dict] = {}
    hb_depths: list[float] = []
    n_faults = n_retries = 0
    for rec in records:
        if rec.get("type") != "event":
            continue
        name = rec.get("name")
        if name == "heartbeat":
            d = rec.get("queue_depth")
            if isinstance(d, (int, float)):
                hb_depths.append(float(d))
            continue
        if name == "fault_injected":
            n_faults += 1
            continue
        if name == "retry":
            n_retries += 1
            continue
        if not isinstance(name, str) or not (
            name.startswith("job_") or name == "lease_takeover"
        ):
            continue
        job = rec.get("job")
        if not isinstance(job, str):
            continue
        j = jobs.setdefault(
            job,
            {"state": "accepted", "slices": 0, "preemptions": 0,
             "takeovers": 0, "fenced": 0, "watchdogs": 0,
             "wall_s": 0.0, "warm": None},
        )
        if name == "job_accepted":
            j["priority"] = rec.get("priority")
        elif name == "job_rejected":
            j["state"] = "rejected"
            j["error"] = rec.get("reason")
        elif name == "job_shed":
            # admission-control rejection: the job never entered the
            # queue — its reason is the shed policy's verdict
            j["state"] = "shed"
            j["error"] = rec.get("reason")
            j["priority"] = rec.get("priority", j.get("priority"))
        elif name == "lease_takeover":
            j["takeovers"] += 1
            j["takeover_reason"] = rec.get("reason")
        elif name == "job_fenced":
            j["fenced"] += 1
        elif name == "job_started":
            j["slices"] += 1
            if j["warm"] is None:
                j["warm"] = bool(rec.get("warm"))
            # shard lineage (serve/shard/): sub-job slices carry their
            # parent id + shard index; parent slices carry the stage
            if isinstance(rec.get("parent"), str):
                j["parent"] = rec["parent"]
                j["shard_idx"] = rec.get("shard_idx")
        elif name == "job_split":
            # the parent fanned out: sub-jobs registered, merge pending
            j["state"] = "fanned"
            j["n_shards"] = rec.get("n_shards")
            j["n_plan_chunks"] = rec.get("n_chunks")
        elif name == "job_merged":
            j["n_shards"] = rec.get("n_shards", j.get("n_shards"))
            j["merge_s"] = rec.get("merge_s")
            j["merged_bytes"] = rec.get("output_bytes")
        elif name == "job_preempted":
            j["preemptions"] += 1
            j["wall_s"] = round(j["wall_s"] + float(rec.get("wall_s") or 0), 3)
            j["chunks_done"] = rec.get("chunks_done")
        elif name == "job_completed":
            j["state"] = "done"
            j["wall_s"] = round(j["wall_s"] + float(rec.get("wall_s") or 0), 3)
            j["n_chunks"] = rec.get("n_chunks")
            j["n_consensus"] = rec.get("n_consensus")
            sec = rec.get("seconds")
            if isinstance(sec, dict):
                j["seconds"] = sec
            # whole-job byte ledger (all slices), from the service's
            # per-job accumulation — pre-ledger captures simply lack
            # it; device_flops/mfu are the device-ledger twin
            for key in ("h2d_bytes", "d2h_bytes", "bytes_per_read",
                        "device_flops", "mfu"):
                if isinstance(rec.get(key), (int, float)):
                    j[key] = rec[key]
        elif name == "job_failed":
            j["state"] = "failed"
            j["error"] = rec.get("error")
        elif name == "job_expired":
            # deadline verdict: terminal, with the durable reason
            j["state"] = "expired"
            j["error"] = rec.get("reason")
        elif name == "job_quarantined":
            # poison verdict: terminal after crash_count unclean aborts
            j["state"] = "quarantined"
            j["error"] = rec.get("reason")
            j["crash_count"] = rec.get("crash_count")
        elif name == "watchdog_fired":
            j["watchdogs"] += 1
            j["stalled_s"] = rec.get("stalled_s")
    last = records[-1] if records else {}
    summary = last if isinstance(last, dict) and last.get("type") == "summary" else {}
    counters = summary.get("counters") if isinstance(summary, dict) else None
    done = sum(1 for j in jobs.values() if j["state"] == "done")
    failed = sum(1 for j in jobs.values() if j["state"] == "failed")
    warm_known = [j for j in jobs.values() if j["warm"] is not None]
    out = {
        "n_jobs": len(jobs),
        "n_done": done,
        "n_failed": failed,
        "n_rejected": sum(1 for j in jobs.values() if j["state"] == "rejected"),
        "n_shed": sum(1 for j in jobs.values() if j["state"] == "shed"),
        # disk-pressure sheds carry a "shed: disk ..." reason — split
        # out so overload-by-disk is legible apart from class/queue
        # bounds
        "n_disk_shed": sum(
            1 for j in jobs.values()
            if j["state"] == "shed"
            and str(j.get("error", "")).startswith("shed: disk")
        ),
        "n_expired": sum(1 for j in jobs.values() if j["state"] == "expired"),
        "n_quarantined": sum(
            1 for j in jobs.values() if j["state"] == "quarantined"
        ),
        "n_watchdog_fired": sum(j["watchdogs"] for j in jobs.values()),
        "n_takeovers": sum(j["takeovers"] for j in jobs.values()),
        "n_fenced": sum(j["fenced"] for j in jobs.values()),
        "n_preemptions": sum(j["preemptions"] for j in jobs.values()),
        "n_warm_starts": sum(1 for j in warm_known if j["warm"]),
        "n_cold_starts": sum(1 for j in warm_known if not j["warm"]),
        "n_fault_events": n_faults,
        "n_retry_events": n_retries,
        "queue_depth_max": max(hb_depths) if hb_depths else 0,
        "queue_depth_mean": (
            round(sum(hb_depths) / len(hb_depths), 2) if hb_depths else 0
        ),
        "clean_shutdown": bool(summary),
        "jobs": jobs,
    }
    # scatter-gather rollup: every job that fanned out (or that shard
    # sub-jobs point at) gets a parent row aggregating its shards
    parents: dict[str, dict] = {}
    for job_id, j in jobs.items():
        if "n_shards" in j:
            parents.setdefault(job_id, {}).update({
                "n_shards": j.get("n_shards"),
                "state": j["state"],
                "merge_s": j.get("merge_s"),
            })
    for job_id, j in jobs.items():
        parent = j.get("parent")
        if not isinstance(parent, str):
            continue
        p = parents.setdefault(parent, {})
        p["n_shard_jobs"] = p.get("n_shard_jobs", 0) + 1
        p.setdefault("shard_states", {})
        p["shard_states"][j["state"]] = (
            p["shard_states"].get(j["state"], 0) + 1
        )
    if parents:
        out["parents"] = parents
        out["n_split"] = len(parents)
        out["n_merged"] = sum(
            1 for p in parents.values() if p.get("merge_s") is not None
        )
    if isinstance(counters, dict):
        out["service_counters"] = counters
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m duplexumiconsensusreads_torch.tools.serve_report",
        description="summarise a serve daemon's service telemetry capture",
    )
    ap.add_argument("trace", help="kind=\"service\" JSONL capture")
    ap.add_argument("--json", action="store_true", help="machine-readable")
    args = ap.parse_args(argv)

    from duplexumiconsensusreads_torch.telemetry import report

    try:
        records = report.load_trace(args.trace)
    except (OSError, ValueError) as e:
        print(f"serve_report: {e}", file=sys.stderr)
        return 1
    problems = report.validate_service_trace(records)
    if problems:
        for p in problems:
            print(f"serve_report: {args.trace}: {p}", file=sys.stderr)
        return 1
    s = summarize(records)
    if args.json:
        print(json.dumps(s, sort_keys=True))
        return 0
    print(
        f"service: {s['n_jobs']} jobs ({s['n_done']} done, "
        f"{s['n_failed']} failed, {s['n_rejected']} rejected, "
        f"{s['n_shed']} shed), "
        f"{s['n_preemptions']} preemptions, "
        f"{s['n_warm_starts']}/{s['n_warm_starts'] + s['n_cold_starts']} "
        f"warm starts"
        + ("" if s["clean_shutdown"] else
           "  [no summary record: daemon did not shut down cleanly]")
    )
    if s["n_takeovers"] or s["n_fenced"]:
        print(
            f"fleet: {s['n_takeovers']} lease takeovers, "
            f"{s['n_fenced']} fenced (zombie) slices"
        )
    if (
        s["n_expired"] or s["n_quarantined"] or s["n_watchdog_fired"]
        or s["n_disk_shed"]
    ):
        print(
            f"defense: {s['n_expired']} expired, "
            f"{s['n_quarantined']} quarantined, "
            f"{s['n_watchdog_fired']} watchdog fires, "
            f"{s['n_disk_shed']} disk sheds"
        )
    if s["queue_depth_max"]:
        print(
            f"queue depth over heartbeats: max {s['queue_depth_max']:.0f} "
            f"mean {s['queue_depth_mean']}"
        )
    if s["n_fault_events"] or s["n_retry_events"]:
        print(
            f"switchboard: {s['n_fault_events']} injected faults, "
            f"{s['n_retry_events']} retries"
        )
    if s.get("parents"):
        # scatter-gather rollup: one line per parent, shard states
        # aggregated — the fleet-wide progress view of a sharded job
        print(f"sharding: {s['n_split']} parents fanned out, "
              f"{s['n_merged']} merged")
        for pid in sorted(s["parents"]):
            p = s["parents"][pid]
            states = ", ".join(
                f"{n} {st}" for st, n in
                sorted(p.get("shard_states", {}).items())
            ) or "no shard slices in capture"
            merge = (
                f", merge {p['merge_s']:.3f}s"
                if isinstance(p.get("merge_s"), (int, float)) else ""
            )
            print(f"  {pid}: {p.get('n_shards', '?')} shards "
                  f"({states}){merge}")
    print(f"{'job':<18} {'state':<11} {'pri':>3} {'slices':>6} "
          f"{'preempt':>7} {'wd':>3} {'wall_s':>8} {'warm':>5} "
          f"{'h2d_mb':>8} {'d2h_mb':>8} {'B/read':>7} {'mfu':>7} "
          f"{'lineage':>12}")
    def _mb(v):
        return f"{v / 1e6:.1f}" if isinstance(v, (int, float)) else "-"

    def _fmt_mfu(v):
        # "-" for pre-devledger captures (no mfu on the event at all)
        return f"{v:.2g}" if isinstance(v, (int, float)) else "-"

    for job_id in sorted(s["jobs"]):
        j = s["jobs"][job_id]
        bpr = j.get("bytes_per_read")
        if isinstance(j.get("parent"), str):
            lineage = f"{j['parent'][-8:]}#{j.get('shard_idx')}"
        elif "n_shards" in j:
            lineage = f"parent/{j.get('n_shards')}"
        else:
            lineage = "-"
        print(
            f"{job_id:<18} {j['state']:<11} {str(j.get('priority', '?')):>3} "
            f"{j['slices']:>6} {j['preemptions']:>7} "
            f"{j.get('watchdogs', 0):>3} {j['wall_s']:>8.3f} "
            f"{str(j['warm']):>5} {_mb(j.get('h2d_bytes')):>8} "
            f"{_mb(j.get('d2h_bytes')):>8} "
            f"{f'{bpr:g}' if isinstance(bpr, (int, float)) else '-':>7} "
            f"{_fmt_mfu(j.get('mfu')):>7} "
            f"{lineage:>12}"
        )
        sec = j.get("seconds")
        if isinstance(sec, dict):
            busy = {k: v for k, v in sorted(sec.items())
                    if k not in ("total", "drain_utilization") and v}
            if busy:
                print(f"{'':<18}   " + " ".join(
                    f"{k}={v:.3g}" for k, v in busy.items()
                ))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
