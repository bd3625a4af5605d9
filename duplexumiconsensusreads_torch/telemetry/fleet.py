"""Fleet flight recorder: cross-daemon job timelines + fleet metrics.

Since the serving layer became a fleet (leases/takeover, preemption
slices, watchdog requeues, shard fan-out/merge), one job's life spans
daemons — but every daemon records its OWN service capture and its own
metrics snapshot, so no single artifact can answer "where did job X's
40 seconds go across the fleet?" or "what is fleet-wide p95 queue-wait
per priority class?". This module is the stitching side: it ingests N
daemons' service captures (plus the spool journal and the per-daemon
metrics snapshots when present) and reconstructs, per job, the complete
admission→terminal timeline, then aggregates fleet-level metrics and
evaluates declared SLO gates over them. ``tools/fleet_report.py`` is
the CLI shell (the same split as report.py/trace_report.py and
ledger.py/wirestat.py).

Alignment: every capture's meta header carries ``epoch_m`` — the
recorder's epoch as a raw machine-wide CLOCK_MONOTONIC reading — so a
record's global time is ``epoch_m + t``. That scopes stitching to one
host, exactly the scope flock and the lease clock already impose on a
spool. All stitched times are INTEGER MICROSECONDS on that shared
clock; the journal's ``admitted_m``/``deadline_m`` stamps live in the
same domain and join directly.

The timeline model (per job, keyed (job_id, fencing token, daemon_id)):

  segment  an interval in which one daemon held the job's lease and
           worked it — a ``run`` slice, a planner ``split`` stage, or a
           ``merge`` stage (``FLEET_SEGMENT_KINDS``). A segment opens
           at the owning daemon's ``job_started`` (which names its
           token) and closes at the SAME daemon+token's end event
           (``job_preempted``/``job_completed``/``job_failed``/
           ``job_expired``/``job_split``) — or, when the owner died
           holding the lease, at the ``lease_takeover``/
           ``watchdog_fired`` event with which the fleet durably
           reclaimed it (lease-hold semantics: authority ends at the
           reclaim, wherever the corpse stopped writing).
  gap      an attributed interval in which nobody held the job
           (``FLEET_GAP_KINDS``): ``queue_wait`` (admission → first
           claim, and any sweep-side wait), ``requeued`` (after a clean
           preemption), ``takeover`` / ``watchdog`` (after an unclean
           reclaim, until the next claim — the fleet's recovery
           latency), ``fanned`` (a sharding parent waiting on its
           sub-jobs between ``job_split`` and its merge claim).

THE SUM-CHECK (exact, integers): for every job with an observed
admission and terminal, ``terminal - admission == Σ segments + Σ
gaps``. Like trace_report's time check and wirestat's byte check, the
equality is enforced together with the structural invariants that make
it meaningful: every segment must open with a ``job_started`` and close
with a matching end event on the same (daemon, token), segments may
never overlap (two daemons holding one job at once is a lease-protocol
violation), and terminals are exactly-once across all captures. A
capture written by a daemon that did not shut down cleanly (no summary
record) or that truncated (``n_dropped > 0``) cannot promise complete
testimony, so — same policy as the other sum-checks — the check
degrades to ONE-SIDED for that daemon's slices: an unclosed slice is
closed at the reclaim (or capture end) with a recorded warning instead
of a failure, while impossible structure (overlap, duplicate
terminals, an end event whose start was never recorded in a CLEAN
capture) still fails. Exit 1 in the CLI means a tampered/torn capture
or an instrumentation bug, never the designed bounds.

The port's copy: the JAX package's telemetry/fleet.py with its imports
rewritten to this package, and nothing else changed. It reads through
the port's ``report``, ``ledger``, ``devledger`` and ``device``
modules, so a capture from either engine stitches alike. Two points
the card decides:

- :func:`run_device` takes its peak the way the port's devledger does
  (``device.device_peak_flops()``): the H100 entry when a card is
  visible, the table's default entry offline, ``DUT_PEAK_TFLOPS`` over
  both; so its ``peak_entry`` is the port's own, never a TPU's.
- The CUDA-event device time the port adds to a slice (``device_s``
  and ``device_flops`` on the service's ``job_completed`` events, the
  ``dev`` records of a run capture) rides along as attributes and
  per-daemon metrics only: the stitcher reads lifecycle EVENT times
  alone, so device spans never enter the sum-check as host segments.
"""

from __future__ import annotations

import json
import os

from duplexumiconsensusreads_torch.telemetry.report import (
    _is_num,
    _pctl,
    capture_kind,
    load_trace,
    summary_record,
    validate_service_trace,
    validate_trace,
)

__all__ = [
    "FLEET_SEGMENT_KINDS", "FLEET_GAP_KINDS", "FLEET_METRIC_KEYS",
    "seg_rec", "gap_rec", "discover_service_captures",
    "load_capture", "load_captures", "load_journal",
    "load_metrics_docs", "stitch", "fleet_metrics", "run_overlap",
    "run_device", "render_prom", "check_slo", "render_report",
]

# Timeline segment kinds: what a daemon was doing while it held the
# job's lease. One registry like trace.KNOWN_STAGES — dutlint's
# phase-registry rule pins every literal ``seg_rec("...")`` call site
# to this tuple, and the SLO/prom surfaces key on it.
FLEET_SEGMENT_KINDS = (
    "run",  # a consensus slice (WarmWorker.run_slice under a lease)
    "split",  # a sharding parent's planner stage (claim -> job_split)
    "merge",  # a sharding parent's splice stage (claim -> job_completed)
)

# Attributed ownerless intervals between segments — the registry
# ``gap_rec("...")`` literals are pinned to.
FLEET_GAP_KINDS = (
    "queue_wait",  # admission -> first claim (and sweep-side waiting)
    "requeued",  # clean preemption (budget/drain) -> next claim
    "takeover",  # lease_takeover reclaim -> next claim: recovery latency
    "watchdog",  # watchdog_fired reclaim -> next claim
    "fanned",  # parent waiting on sub-jobs: job_split -> merge claim
)

# The fleet-metrics scalar surface: exactly these keys appear at the
# top level of :func:`fleet_metrics` output, in spool/fleet_metrics.json
# and in the Prometheus exposition; SLO gates (--check-slo) may bound
# any of them. Percentile keys also appear per priority class under
# "classes". A golden test pins fleet_metrics to this registry.
FLEET_METRIC_KEYS = (
    "fleet_daemons", "fleet_jobs", "fleet_done", "fleet_failed",
    "fleet_expired", "fleet_quarantined", "fleet_shed", "fleet_rejected",
    "fleet_takeovers", "fleet_watchdog_fired", "fleet_fenced",
    "fleet_preemptions", "fleet_splits", "fleet_merges",
    "fleet_wall_s",
    "queue_wait_p50_s", "queue_wait_p95_s",
    "ttfc_p50_s", "ttfc_p95_s",
    "e2e_p50_s", "e2e_p95_s",
    "takeover_gap_p50_s", "takeover_gap_p95_s", "takeover_gap_max_s",
    "deadline_hit_rate",
)

# terminal lifecycle events -> stitched terminal state
_TERMINALS = {
    "job_completed": "done",
    "job_failed": "failed",
    "job_expired": "expired",
    "job_quarantined": "quarantined",
}

# end events only a live slice can emit: seeing one without a matching
# open segment in a clean capture means a record was dropped (tampered
# or torn capture) — the structural half of the sum-check.
# (job_merged is NOT here: it is an annotation inside the merge
# segment, handled before end-event matching; job_completed closes the
# merge and carries the structural check for that stage.)
_SLICE_ONLY_ENDS = ("job_preempted", "job_completed", "job_split")


def _us(seconds) -> int:
    """Seconds (already rounded at record time) -> integer microseconds
    — the sum-check's exact domain. Bytes don't round; neither do these."""
    return round(float(seconds) * 1e6)


def seg_rec(kind: str, t0_us: int, t1_us: int, daemon: str, **attrs) -> dict:
    """One timeline segment. ``kind`` must be registered in
    FLEET_SEGMENT_KINDS — literal call sites are lint-pinned by
    dutlint's phase-registry rule, and the constructor refuses unknown
    kinds at runtime so a computed kind cannot fork the schema either."""
    if kind not in FLEET_SEGMENT_KINDS:
        raise ValueError(f"unknown fleet segment kind {kind!r}")
    rec = {"kind": kind, "t0_us": int(t0_us), "t1_us": int(t1_us),
           "daemon": daemon}
    rec.update(attrs)
    return rec


def gap_rec(kind: str, t0_us: int, t1_us: int, **attrs) -> dict:
    """One attributed gap (``kind`` ∈ FLEET_GAP_KINDS, pinned like
    :func:`seg_rec`)."""
    if kind not in FLEET_GAP_KINDS:
        raise ValueError(f"unknown fleet gap kind {kind!r}")
    rec = {"kind": kind, "t0_us": int(t0_us), "t1_us": int(t1_us)}
    rec.update(attrs)
    return rec


# ------------------------------------------------------------- ingestion

def discover_service_captures(dir_path: str) -> list[str]:
    """Every service capture in a spool directory, name-sorted: the
    per-daemon ``service.<id>.trace.jsonl`` files, their rotated
    ``.prev`` siblings (a restarted daemon's previous life is still
    fleet history), and the legacy shared ``service.trace.jsonl``. The
    ONE definition of the capture naming convention — fleet_report's
    spool discovery, the quarantine diagnosis scan and the bench
    serve_fleet leg all resolve captures through here."""
    try:
        names = sorted(os.listdir(dir_path))
    except OSError:
        return []
    return [
        os.path.join(dir_path, n) for n in names
        if n.startswith("service.") and (
            n.endswith(".trace.jsonl") or n.endswith(".trace.jsonl.prev")
        )
    ]


def load_capture(path: str) -> dict:
    """Parse + validate one capture for stitching. Returns
    ``{path, records, kind, daemon_id, epoch_us, clean, truncated,
    end_us, problems}`` — ``problems`` holds schema violations (the CLI
    fails on them; a summary-less capture is NOT a violation, it is the
    unclean-shutdown marker the lenient policy keys on)."""
    records = load_trace(path)
    kind = capture_kind(records)
    problems = (
        validate_service_trace(records) if kind == "service"
        else validate_trace(records)
    )
    meta = records[0] if records and isinstance(records[0], dict) else {}
    s = summary_record(records)
    epoch = meta.get("epoch_m")
    end = 0.0
    truncated = bool(s and int(s.get("n_dropped") or 0) > 0)
    for rec in records:
        if not isinstance(rec, dict):
            continue
        if rec.get("type") in ("span", "xfer"):
            end = max(end, float(rec.get("t", 0)) + float(rec.get("dur", 0)))
        elif rec.get("type") in ("event", "summary"):
            end = max(end, float(rec.get("t", 0)))
            if rec.get("type") == "event" and rec.get("name") == "truncated":
                truncated = True
    daemon_id = meta.get("daemon_id")
    if not isinstance(daemon_id, str) or not daemon_id:
        # pre-fleet capture: fall back to the filename so single-capture
        # reports still render; multi-capture stitching flags it below
        daemon_id = os.path.basename(path)
    return {
        "path": path,
        "records": records,
        "kind": kind,
        "daemon_id": daemon_id,
        "epoch_us": _us(epoch) if _is_num(epoch) else None,
        "clean": s is not None,
        "truncated": truncated,
        "end_us": (_us(epoch) if _is_num(epoch) else 0) + _us(end),
        "problems": problems,
    }


def load_captures(paths: list[str]) -> dict:
    """Load + classify captures: ``{"service": [...], "run": [...],
    "problems": [...]}``. Run captures (per-job ``--trace``) ride along
    for the Perfetto export; service captures feed the stitcher.
    Multi-capture alignment REQUIRES ``epoch_m`` in every service
    capture's meta — without it two timelines cannot share a clock and
    guessing would silently fabricate gaps."""
    out = {"service": [], "run": [], "problems": []}
    for path in paths:
        cap = load_capture(path)
        out["problems"] += [f"{path}: {p}" for p in cap["problems"]]
        out["service" if cap["kind"] == "service" else "run"].append(cap)
    if len(out["service"]) > 1:
        for cap in out["service"]:
            if cap["epoch_us"] is None:
                out["problems"].append(
                    f"{cap['path']}: capture meta lacks epoch_m — "
                    f"pre-fleet captures cannot be stitched cross-daemon"
                )
    # a daemon_id may legitimately recur across RECORDER LIVES — a
    # restarted daemon's rotated .prev beside its live capture is
    # fleet history, and epoch_m discriminates the lives. Only two
    # captures of the SAME life (one file passed twice, possibly via
    # copies) are a duplicate: they would double every event.
    seen: dict[tuple, str] = {}
    for cap in out["service"]:
        key = (cap["daemon_id"], cap["epoch_us"])
        first = seen.setdefault(key, cap["path"])
        if first != cap["path"]:
            out["problems"].append(
                f"{cap['path']}: duplicate capture for daemon "
                f"{cap['daemon_id']!r} (same recorder epoch as {first}) "
                f"— pass each capture once"
            )
    return out


def load_journal(path: str) -> dict | None:
    """The spool journal's jobs map (None when absent/torn — stitching
    then runs capture-only, skipping the journal cross-checks)."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    jobs = doc.get("jobs") if isinstance(doc, dict) else None
    return jobs if isinstance(jobs, dict) else None


def load_metrics_docs(spool: str) -> list[dict]:
    """Every per-daemon metrics snapshot on the spool
    (``metrics/<daemon_id>.json``), falling back to the legacy shared
    ``metrics.json`` when the directory is absent. Torn files are
    skipped — snapshots are observability, not the record."""
    docs = []
    mdir = os.path.join(spool, "metrics")
    paths = []
    try:
        paths = [os.path.join(mdir, n) for n in sorted(os.listdir(mdir))
                 if n.endswith(".json")]
    except OSError:
        pass
    if not paths:
        paths = [os.path.join(spool, "metrics.json")]
    for p in paths:
        try:
            with open(p) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            continue
        if isinstance(doc, dict):
            docs.append(doc)
    return docs


# -------------------------------------------------------------- stitching

_JOB_ATTR_EVENTS = (
    "job_accepted", "job_rejected", "job_shed", "job_started",
    "job_preempted", "job_completed", "job_failed", "job_expired",
    "job_quarantined", "job_split", "job_merged", "job_fenced",
    "lease_takeover", "watchdog_fired",
)


def _job_events(service_caps: list[dict]) -> dict[str, list[dict]]:
    """Per job: lifecycle events from every capture, each wrapped with
    its global time and writing daemon, in global time order."""
    jobs: dict[str, list[dict]] = {}
    for cap in service_caps:
        epoch = cap["epoch_us"] or 0
        for rec in cap["records"]:
            if not isinstance(rec, dict) or rec.get("type") != "event":
                continue
            if rec.get("name") not in _JOB_ATTR_EVENTS:
                continue
            job = rec.get("job")
            if not isinstance(job, str) or not job:
                continue
            jobs.setdefault(job, []).append({
                "t_us": epoch + _us(rec.get("t", 0)),
                "daemon": cap["daemon_id"],
                "cap": cap,
                "rec": rec,
            })
    for evs in jobs.values():
        evs.sort(key=lambda e: e["t_us"])
    return jobs


def _stitch_job(
    job_id: str,
    evs: list[dict],
    entry: dict | None,
    problems: list[str],
) -> dict:
    """One job's timeline from its merged event stream. Appends
    structural violations to ``problems`` (the CLI's exit-1 surface);
    per-job warnings (lenient closures) land in the returned dict."""
    out: dict = {
        "job_id": job_id, "state": "accepted", "priority": None,
        "segments": [], "gaps": [], "warnings": [],
        "n_fenced": 0, "n_takeovers": 0, "n_watchdog": 0,
        "admission_us": None, "terminal_us": None,
    }
    segs: list[dict] = out["segments"]
    gaps: list[dict] = out["gaps"]
    open_seg: dict | None = None  # {"t0_us","daemon","token","kind","cap"}
    pending_gap = "queue_wait"
    # admission seed: the journal's admitted_m is in the same raw
    # monotonic domain as epoch_m + t, so it anchors the queue-wait gap
    # even when the admitting daemon's capture was rotated away. It is
    # ms-rounded where event times are µs-rounded — clamp to the first
    # event so the tiling can never start after its own first record.
    if entry is not None and _is_num(entry.get("admitted_m")):
        out["admission_us"] = _us(entry["admitted_m"])
    if evs and out["admission_us"] is not None:
        out["admission_us"] = min(out["admission_us"], evs[0]["t_us"])
    cursor: int | None = out["admission_us"]

    def close_seg(t_us: int, end: str, **attrs) -> None:
        nonlocal open_seg, cursor
        s = open_seg
        open_seg = None
        if t_us < s["t0_us"]:
            problems.append(
                f"job {job_id}: segment on {s['daemon']} would close "
                f"before it opened (clock skew or tampered capture)"
            )
            t_us = s["t0_us"]
        segs.append(seg_rec(
            s["kind"], s["t0_us"], t_us, s["daemon"],
            token=s["token"], end=end, **attrs,
        ))
        cursor = t_us

    def push_gap(t_us: int) -> None:
        nonlocal cursor
        if cursor is None:
            cursor = t_us
            return
        if t_us <= cursor:
            return  # zero-length wait (or µs-vs-ms rounding): no gap
        gaps.append(gap_rec(pending_gap, cursor, t_us))
        cursor = t_us

    def lenient(cap: dict) -> bool:
        # a daemon that died (no summary) or truncated its capture
        # cannot testify completely: one-sided policy for ITS records
        return not cap["clean"] or cap["truncated"]

    for ev in evs:
        rec, t_us, daemon = ev["rec"], ev["t_us"], ev["daemon"]
        name = rec["name"]
        token = rec.get("token")
        if name == "job_accepted":
            out["admission_us"] = (
                t_us if out["admission_us"] is None
                else min(out["admission_us"], t_us)
            )
            out["priority"] = rec.get("priority", out["priority"])
            if cursor is None:
                cursor = out["admission_us"]
            continue
        if name in ("job_rejected", "job_shed"):
            out["state"] = "shed" if name == "job_shed" else "rejected"
            out["priority"] = rec.get("priority", out["priority"])
            out["terminal_us"] = t_us
            continue
        if name == "job_started":
            stage = rec.get("stage")
            kind = (
                "split" if stage == "split"
                else "merge" if stage == "merge" else "run"
            )
            if open_seg is not None:
                # two leases at once is what fencing exists to prevent:
                # real protocol violation, or a dropped end record
                if lenient(open_seg["cap"]):
                    out["warnings"].append(
                        f"slice on {open_seg['daemon']} closed at the "
                        f"next claim (its capture is unclean/truncated)"
                    )
                    close_seg(t_us, "truncated", truncated=True)
                else:
                    problems.append(
                        f"job {job_id}: job_started on {daemon} (token "
                        f"{token}) while the slice on "
                        f"{open_seg['daemon']} (token "
                        f"{open_seg['token']}) is still open — "
                        f"overlapping segments"
                    )
                    close_seg(t_us, "overlap")
            push_gap(t_us)
            out["state"] = "running"
            open_seg = {"t0_us": t_us, "daemon": daemon, "token": token,
                        "kind": kind, "cap": ev["cap"]}
            continue
        if name in ("lease_takeover", "watchdog_fired"):
            which = "takeover" if name == "lease_takeover" else "watchdog"
            out["n_takeovers" if which == "takeover" else "n_watchdog"] += 1
            if open_seg is not None:
                # lease-hold semantics: the dead owner's authority ends
                # HERE, at the durable reclaim — not wherever its
                # capture happens to stop
                close_seg(t_us, which)
            else:
                out["warnings"].append(
                    f"{name} at t={t_us}us reclaimed a slice no capture "
                    f"recorded a start for"
                )
                push_gap(t_us)
            pending_gap = which
            out["state"] = "queued"
            continue
        if name == "job_fenced":
            out["n_fenced"] += 1
            if open_seg is not None and open_seg["daemon"] == daemon:
                # the zombie's own too-late abort: its authority already
                # ended at the takeover; only an unclean fleet (no
                # takeover event captured) leaves the segment open here
                out["warnings"].append(
                    f"slice on {daemon} closed at its fence (no reclaim "
                    f"event captured before it)"
                )
                close_seg(t_us, "fenced")
                pending_gap = "takeover"
            continue
        if name == "job_merged":
            # annotation inside the merge segment (job_completed closes)
            out["merge_s"] = rec.get("merge_s")
            continue
        # end events: close the owning segment (slice path) or the
        # pending gap (sweep-side terminals carry no open slice)
        is_terminal = name in _TERMINALS
        if open_seg is not None and open_seg["daemon"] == daemon and (
            token is None or open_seg["token"] is None
            or int(token) == int(open_seg["token"])
        ):
            after = {
                "job_preempted": "requeued",
                "job_split": "fanned",
            }.get(name)
            close_seg(t_us, name.removeprefix("job_"),
                      **({"reason": rec["reason"]}
                         if isinstance(rec.get("reason"), str) else {}))
            if after:
                pending_gap = after
                out["state"] = "fanned" if name == "job_split" else "queued"
        elif name in _SLICE_ONLY_ENDS:
            cap = ev["cap"]
            if lenient(cap):
                out["warnings"].append(
                    f"{name} on {daemon} without a recorded slice start "
                    f"(capture unclean/truncated)"
                )
                push_gap(t_us)
            else:
                problems.append(
                    f"job {job_id}: {name} on {daemon} (token {token}) "
                    f"has no matching job_started in a clean capture — "
                    f"dropped slice segment"
                )
                push_gap(t_us)
        else:
            # sweep-side job_failed/job_expired/job_quarantined: the
            # waiting interval ends here
            push_gap(t_us)
        if is_terminal:
            if out["terminal_us"] is not None:
                problems.append(
                    f"job {job_id}: duplicate terminal {name} on "
                    f"{daemon} — the fleet completed it more than once"
                )
            out["terminal_us"] = t_us
            out["state"] = _TERMINALS[name]

    if open_seg is not None:
        cap = open_seg["cap"]
        if lenient(cap):
            out["warnings"].append(
                f"slice on {open_seg['daemon']} never closed; closed at "
                f"its capture's end (unclean shutdown)"
            )
            close_seg(max(cap["end_us"], open_seg["t0_us"]), "truncated",
                      truncated=True)
        else:
            problems.append(
                f"job {job_id}: slice on {open_seg['daemon']} (token "
                f"{open_seg['token']}) never closed in a clean capture "
                f"— dropped end record"
            )
            close_seg(max(cap["end_us"], open_seg["t0_us"]), "unclosed")

    # journal cross-checks + fallbacks: the journal is the durable
    # record; the captures are testimony. Where both speak they must
    # agree.
    if entry is not None:
        if out["priority"] is None:
            out["priority"] = entry.get("priority")
        n_started = sum(
            1 for e in evs if e["rec"]["name"] == "job_started"
        )
        slices = entry.get("slices")
        if (
            isinstance(slices, int) and n_started
            and not any(lenient(e["cap"]) for e in evs)
            and slices != n_started
        ):
            problems.append(
                f"job {job_id}: journal says {slices} slices but the "
                f"captures hold {n_started} job_started events — a "
                f"daemon's capture is missing or tampered"
            )
        jstate = entry.get("state")
        if (
            jstate in _TERMINALS.values()
            and out["state"] in _TERMINALS.values()
            and jstate != out["state"]
        ):
            problems.append(
                f"job {job_id}: journal state {jstate!r} disagrees with "
                f"stitched terminal {out['state']!r}"
            )
        out["parent"] = entry.get("parent")
        out["deadline"] = _is_num(entry.get("deadline_m"))
    if out["priority"] is None:
        out["priority"] = 1

    # THE SUM-CHECK: segments + gaps must tile admission -> terminal
    # exactly. The structure above makes honest captures tile by
    # construction, so any drift left IS evidence of overlap/clamping —
    # i.e. of the violations the problems list narrates.
    adm, term = out["admission_us"], out["terminal_us"]
    if adm is not None and term is not None and out["state"] != "shed" \
            and out["state"] != "rejected":
        head = segs[0]["t0_us"] if segs else term
        if gaps and gaps[0]["t0_us"] < adm:
            problems.append(
                f"job {job_id}: timeline begins {adm - gaps[0]['t0_us']}us "
                f"before admission"
            )
        total = sum(s["t1_us"] - s["t0_us"] for s in segs)
        total += sum(g["t1_us"] - g["t0_us"] for g in gaps)
        out["wall_us"] = term - adm
        out["busy_us"] = sum(s["t1_us"] - s["t0_us"] for s in segs)
        out["sum_check_ok"] = (total == out["wall_us"]) and head >= adm
        if not out["sum_check_ok"]:
            problems.append(
                f"job {job_id}: SUM-CHECK DRIFT — admission→terminal "
                f"{out['wall_us']}us != Σ segments + Σ gaps {total}us"
            )
    else:
        out["sum_check_ok"] = None  # open/shed job: nothing to total
    return out


def stitch(captures: dict, journal: dict | None = None) -> dict:
    """Stitch loaded captures (:func:`load_captures` output) + the
    journal into per-job timelines. Returns ``{"jobs": {...},
    "daemons": {...}, "problems": [...], "warnings": [...], "ok":
    bool}`` — ``ok`` is False on any structural violation or sum-check
    drift (the CLI's exit 1)."""
    problems = list(captures.get("problems", ()))
    service_caps = captures.get("service", ())
    jobs_out: dict[str, dict] = {}
    warnings: list[str] = []
    for job_id, evs in sorted(_job_events(list(service_caps)).items()):
        entry = journal.get(job_id) if journal else None
        tl = _stitch_job(job_id, evs, entry, problems)
        warnings += [f"job {job_id}: {w}" for w in tl.pop("warnings")]
        jobs_out[job_id] = tl
    # journal-only jobs (their daemon's capture was rotated away or
    # never passed): surfaced, not stitched — coverage must be audible
    for job_id in sorted(journal or ()):
        if job_id not in jobs_out:
            warnings.append(
                f"job {job_id}: journaled "
                f"({(journal[job_id] or {}).get('state')}) but absent "
                f"from every capture"
            )
    daemons: dict[str, dict] = {}
    for cap in service_caps:
        # a restarted daemon contributes several captures (live +
        # rotated .prev) under one id: an unclean/truncated life marks
        # the daemon, whichever life it was — the lenient one-sided
        # closure stays per-capture above either way
        d = daemons.setdefault(cap["daemon_id"], {
            "path": cap["path"],
            "clean": True,
            "truncated": False,
            "n_slices": 0,
            "busy_us": 0,
        })
        d["clean"] = d["clean"] and cap["clean"]
        d["truncated"] = d["truncated"] or cap["truncated"]
    for tl in jobs_out.values():
        for s in tl["segments"]:
            d = daemons.setdefault(
                s["daemon"],
                {"path": None, "clean": False, "truncated": False,
                 "n_slices": 0, "busy_us": 0},
            )
            d["n_slices"] += 1
            d["busy_us"] += s["t1_us"] - s["t0_us"]
    return {
        "jobs": jobs_out,
        "daemons": daemons,
        "problems": problems,
        "warnings": warnings,
        "ok": not problems,
    }


# ------------------------------------------------------------ aggregation

def _round_us(us: int | None) -> float | None:
    return None if us is None else round(us / 1e6, 6)


def fleet_metrics(
    stitched: dict, metrics_docs: list[dict] | None = None
) -> dict:
    """Fleet-level metrics over the stitched timelines + the per-daemon
    metrics snapshots. Top-level scalars are exactly
    ``FLEET_METRIC_KEYS`` (None where no sample exists); per-class
    percentile tables sit under ``"classes"`` and the per-daemon
    balance under ``"daemons"``."""
    jobs = stitched["jobs"]
    by_class: dict[str, dict[str, list[float]]] = {}

    def _cls(pri) -> dict[str, list[float]]:
        return by_class.setdefault(
            str(pri), {"queue_wait": [], "e2e": [], "ttfc": []}
        )

    takeover_gaps: list[float] = []
    totals = {k: 0 for k in FLEET_METRIC_KEYS if k.startswith("fleet_")}
    n_deadline = n_deadline_hit = 0
    t_lo = t_hi = None
    for tl in jobs.values():
        state = tl["state"]
        totals["fleet_jobs"] += 1
        key = {
            "done": "fleet_done", "failed": "fleet_failed",
            "expired": "fleet_expired", "quarantined": "fleet_quarantined",
            "shed": "fleet_shed", "rejected": "fleet_rejected",
        }.get(state)
        if key:
            totals[key] += 1
        totals["fleet_takeovers"] += tl["n_takeovers"]
        totals["fleet_watchdog_fired"] += tl["n_watchdog"]
        totals["fleet_fenced"] += tl["n_fenced"]
        cls = _cls(tl["priority"])
        for g in tl["gaps"]:
            dur = (g["t1_us"] - g["t0_us"]) / 1e6
            if g["kind"] == "takeover":
                takeover_gaps.append(dur)
        for s in tl["segments"]:
            if s["end"] == "preempted":
                totals["fleet_preemptions"] += 1
            elif s["end"] == "split":
                totals["fleet_splits"] += 1
            if s["kind"] == "merge" and s["end"] == "completed":
                totals["fleet_merges"] += 1
        if tl["gaps"] and tl["gaps"][0]["kind"] == "queue_wait":
            g = tl["gaps"][0]
            cls["queue_wait"].append((g["t1_us"] - g["t0_us"]) / 1e6)
        adm, term = tl["admission_us"], tl["terminal_us"]
        if adm is not None:
            t_lo = adm if t_lo is None else min(t_lo, adm)
        ends = [s["t1_us"] for s in tl["segments"]] + (
            [term] if term is not None else []
        )
        if ends:
            t_hi = max(ends) if t_hi is None else max(t_hi, *ends)
        if state == "done" and adm is not None and term is not None:
            cls["e2e"].append((term - adm) / 1e6)
        if tl.get("deadline"):
            n_deadline += 1
            if state == "done":
                n_deadline_hit += 1
    # TTFC (admission -> first fresh chunk durable) only exists in the
    # services' own sample FIFOs — the capture has no chunk-level
    # events. Merging the raw samples is exact; merging percentiles
    # would not be.
    for doc in metrics_docs or ():
        samples = doc.get("class_latency_samples")
        if not isinstance(samples, dict):
            continue
        for pri, kinds in samples.items():
            if isinstance(kinds, dict) and isinstance(
                kinds.get("ttfc"), list
            ):
                _cls(pri)["ttfc"] += [
                    float(v) for v in kinds["ttfc"] if _is_num(v)
                ]

    daemons = {
        d: {
            "n_slices": info["n_slices"],
            "busy_s": round(info["busy_us"] / 1e6, 6),
            "clean": info["clean"],
            "truncated": info["truncated"],
        }
        for d, info in stitched["daemons"].items()
    }
    fleet_wall = (
        round((t_hi - t_lo) / 1e6, 6)
        if t_lo is not None and t_hi is not None else None
    )
    for d, info in daemons.items():
        info["utilization"] = (
            round(info["busy_s"] / fleet_wall, 4) if fleet_wall else 0.0
        )
    for doc in metrics_docs or ():
        d = doc.get("daemon_id")
        if not isinstance(d, str) or d not in daemons:
            continue
        info = daemons[d]
        for key in ("h2d_bytes", "d2h_bytes", "jobs_done", "jobs_failed",
                    "compile_hit_rate", "verdict_hit_rate",
                    "device_flops", "mfu"):
            if _is_num(doc.get(key)):
                info[key] = doc[key]

    classes = {}
    all_qw: list[float] = []
    all_ttfc: list[float] = []
    all_e2e: list[float] = []
    for pri in sorted(by_class):
        row = {}
        for kind, sink in (("queue_wait", all_qw), ("ttfc", all_ttfc),
                           ("e2e", all_e2e)):
            vals = sorted(by_class[pri][kind])
            sink += vals
            row[f"n_{kind}"] = len(vals)
            row[f"{kind}_p50_s"] = (
                round(_pctl(vals, 0.50), 6) if vals else None
            )
            row[f"{kind}_p95_s"] = (
                round(_pctl(vals, 0.95), 6) if vals else None
            )
        classes[pri] = row

    def _p(vals: list[float], q: float) -> float | None:
        vals = sorted(vals)
        return round(_pctl(vals, q), 6) if vals else None

    out = {
        **totals,
        "fleet_daemons": len(daemons),
        "fleet_wall_s": fleet_wall,
        "queue_wait_p50_s": _p(all_qw, 0.50),
        "queue_wait_p95_s": _p(all_qw, 0.95),
        "ttfc_p50_s": _p(all_ttfc, 0.50),
        "ttfc_p95_s": _p(all_ttfc, 0.95),
        "e2e_p50_s": _p(all_e2e, 0.50),
        "e2e_p95_s": _p(all_e2e, 0.95),
        "takeover_gap_p50_s": _p(takeover_gaps, 0.50),
        "takeover_gap_p95_s": _p(takeover_gaps, 0.95),
        "takeover_gap_max_s": (
            round(max(takeover_gaps), 6) if takeover_gaps else None
        ),
        "deadline_hit_rate": (
            round(n_deadline_hit / n_deadline, 4) if n_deadline else None
        ),
        "classes": classes,
        "daemons": daemons,
        "sum_check_ok": stitched["ok"],
        "n_problems": len(stitched["problems"]),
    }
    return out


def run_overlap(run_caps: list[dict]) -> dict:
    """Ingest-overlap efficiency aggregated over the fleet's per-run
    captures (the ``run``-kind captures that ride along for the
    Perfetto export). Per run: :func:`ledger.overlap_stats`; fleet
    level: byte-ledger-style exact sums, so the fleet efficiency is
    overlap seconds over ingest-busy seconds ACROSS runs — a long run
    weighs proportionally, not one-run-one-vote. Returns {} when no
    run capture carries ingest spans (service-only spools)."""
    from duplexumiconsensusreads_torch.telemetry import ledger

    per: dict[str, dict] = {}
    ingest = overlap = stall = backpressure = 0.0
    for cap in run_caps:
        ov = ledger.overlap_stats(cap["records"])
        if not ov:
            continue
        per[os.path.basename(cap["path"])] = ov
        ingest += ov["ingest_busy_s"]
        overlap += ov["overlap_s"]
        stall += ov["stall_s"]
        backpressure += ov["backpressure_s"]
    if not per:
        return {}
    return {
        "n_runs": len(per),
        "ingest_busy_s": round(ingest, 3),
        "overlap_s": round(overlap, 3),
        "efficiency": round(overlap / ingest, 4) if ingest > 0 else 0.0,
        "stall_s": round(stall, 3),
        "backpressure_s": round(backpressure, 3),
        "runs": per,
    }


def run_device(run_caps: list[dict]) -> dict:
    """Per-class MFU aggregated over the fleet's per-run captures —
    the fleet view of the device ledger (telemetry/devledger.py).
    Per run: :func:`devledger.device_totals`; fleet level: FLOPs and
    busy seconds sum EXACTLY across runs (distinct captures never share
    a device interval, so the sum IS the union) and the fleet MFU is
    total FLOPs over total busy over peak — a long run weighs
    proportionally, the same weighting :func:`run_overlap` uses.
    Per-class rows merge across runs by class key. Returns {} when no
    run capture carries dev records (pre-devledger captures)."""
    from duplexumiconsensusreads_torch.telemetry import devledger
    from duplexumiconsensusreads_torch.telemetry.device import (
        device_peak_flops,
        round_mfu,
    )

    peak, peak_entry = device_peak_flops()
    per: dict[str, dict] = {}
    classes: dict[str, dict] = {}
    flops = busy = 0.0
    for cap in run_caps:
        tot = devledger.device_totals(cap["records"], peak_flops=peak)
        if not tot:
            continue
        per[os.path.basename(cap["path"])] = {
            "flops": tot["flops"], "busy_s": tot["busy_s"],
            "mfu": tot["mfu"], "intensity": tot["intensity"],
        }
        flops += tot["flops"]
        busy += tot["busy_s"]
        for key, d in devledger.class_stats(
            cap["records"], peak_flops=peak
        ).items():
            c = classes.setdefault(key, {"flops": 0.0, "busy_s": 0.0})
            c["flops"] = round(c["flops"] + d["flops"], 3)
            c["busy_s"] = round(c["busy_s"] + d["busy_s"], 6)
    if not per:
        return {}
    for c in classes.values():
        c["mfu"] = (
            round_mfu(c["flops"] / c["busy_s"] / peak)
            if c["busy_s"] > 0 and peak > 0 else 0.0
        )
    return {
        "n_runs": len(per),
        "peak_entry": peak_entry,
        "flops": round(flops, 3),
        "busy_s": round(busy, 6),
        "mfu": round_mfu(flops / busy / peak) if busy > 0 and peak > 0 else 0.0,
        "classes": dict(sorted(classes.items(),
                               key=lambda kv: -kv[1]["flops"])),
        "runs": per,
    }


# ----------------------------------------------------------- exposition

def render_prom(metrics: dict) -> str:
    """Prometheus textfile exposition of the fleet metrics: one
    ``dut_fleet_<key>`` gauge per FLEET_METRIC_KEYS scalar (absent
    samples are omitted, not zeroed — a missing percentile is not a
    zero-latency fleet), plus ``{class=...}``-labeled percentile
    variants and ``{daemon=...}``-labeled balance gauges. Written by
    ``fleet_report --prom`` for the node-exporter textfile collector."""
    lines: list[str] = []
    for key in FLEET_METRIC_KEYS:
        v = metrics.get(key)
        if not _is_num(v):
            continue
        name = f"dut_fleet_{key}"
        lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name} {v}")
    for pri, row in sorted(metrics.get("classes", {}).items()):
        for k, v in sorted(row.items()):
            if not _is_num(v) or k.startswith("n_"):
                continue
            name = f"dut_fleet_class_{k}"
            lines.append(f'{name}{{class="{pri}"}} {v}')
    for d, info in sorted(metrics.get("daemons", {}).items()):
        for k in ("n_slices", "busy_s", "utilization",
                  "h2d_bytes", "d2h_bytes", "device_flops", "mfu"):
            v = info.get(k)
            if _is_num(v):
                lines.append(f'dut_fleet_daemon_{k}{{daemon="{d}"}} {v}')
    return "\n".join(lines) + "\n"


def check_slo(metrics: dict, slo: dict) -> tuple[list[dict], bool]:
    """Evaluate declared SLO gates against the fleet metrics.

    ``slo`` is the parsed TOML document: each table names a metric from
    ``FLEET_METRIC_KEYS`` and bounds it with ``max`` and/or ``min``
    (floats); an optional ``class = "N"`` scopes a percentile gate to
    one priority class (the per-class table key, e.g. ``queue_wait_p95_s``
    under ``classes["0"]``). Returns (rows, ok): one row per gate with
    the measured value and verdict. A gate over a metric with NO data
    (None) is reported ``skipped`` and does not fail — an SLO on an
    idle fleet is vacuous, not violated; an unknown metric name is an
    error row and fails (a typo'd gate that silently passes is worse
    than no gate)."""
    rows: list[dict] = []
    ok = True
    for key in sorted(slo):
        gate = slo[key]
        if not isinstance(gate, dict):
            rows.append({"metric": key, "verdict": "error",
                         "detail": "gate must be a TOML table"})
            ok = False
            continue
        if key not in FLEET_METRIC_KEYS:
            rows.append({
                "metric": key, "verdict": "error",
                "detail": f"unknown fleet metric (known: "
                          f"{', '.join(FLEET_METRIC_KEYS)})",
            })
            ok = False
            continue
        cls = gate.get("class")
        if cls is not None:
            value = (metrics.get("classes", {}).get(str(cls)) or {}).get(key)
        else:
            value = metrics.get(key)
        row = {"metric": key, "value": value}
        if cls is not None:
            row["class"] = str(cls)
        if not _is_num(value):
            row["verdict"] = "skipped"
            row["detail"] = "no data"
            rows.append(row)
            continue
        verdict = "pass"
        if _is_num(gate.get("max")) and value > gate["max"]:
            verdict = "fail"
            row["bound"] = f"max {gate['max']}"
        if _is_num(gate.get("min")) and value < gate["min"]:
            verdict = "fail"
            row["bound"] = f"min {gate['min']}"
        if verdict == "pass":
            row["bound"] = " ".join(
                f"{b} {gate[b]}" for b in ("max", "min") if _is_num(gate.get(b))
            )
        row["verdict"] = verdict
        ok &= verdict == "pass"
        rows.append(row)
    return rows, ok


# ------------------------------------------------------------- rendering

def render_report(stitched: dict, metrics: dict) -> list[str]:
    """The human report ``tools/fleet_report.py`` prints: per-daemon
    balance, per-class latency, and one timeline line per job."""
    lines: list[str] = []
    jobs = stitched["jobs"]
    lines.append(
        f"fleet: {metrics['fleet_daemons']} daemons, "
        f"{metrics['fleet_jobs']} jobs ({metrics['fleet_done']} done, "
        f"{metrics['fleet_failed']} failed, "
        f"{metrics['fleet_expired']} expired, "
        f"{metrics['fleet_quarantined']} quarantined, "
        f"{metrics['fleet_shed']} shed), "
        f"{metrics['fleet_takeovers']} takeovers, "
        f"{metrics['fleet_watchdog_fired']} watchdog fires, "
        f"{metrics['fleet_preemptions']} preemptions"
    )
    if metrics["fleet_wall_s"] is not None:
        lines.append(f"wall: {metrics['fleet_wall_s']:.3f}s")
    lines.append("")
    lines.append(f"{'daemon':<24} {'slices':>6} {'busy_s':>9} {'util':>6} "
                 f"{'clean':>6}")
    for d, info in sorted(metrics["daemons"].items()):
        lines.append(
            f"{d[:24]:<24} {info['n_slices']:>6} {info['busy_s']:>9.3f} "
            f"{info['utilization']:>6.2f} {str(info['clean']):>6}"
        )
    if metrics["classes"]:
        lines.append("")
        lines.append(f"{'class':<6} {'n':>4} {'qwait_p50':>10} "
                     f"{'qwait_p95':>10} {'ttfc_p95':>9} {'e2e_p95':>9}")
        for pri, row in sorted(metrics["classes"].items()):

            def _f(v):
                return f"{v:.3f}" if _is_num(v) else "-"

            lines.append(
                f"{pri:<6} {row['n_queue_wait']:>4} "
                f"{_f(row['queue_wait_p50_s']):>10} "
                f"{_f(row['queue_wait_p95_s']):>10} "
                f"{_f(row['ttfc_p95_s']):>9} {_f(row['e2e_p95_s']):>9}"
            )
    if _is_num(metrics["takeover_gap_max_s"]):
        lines.append(
            f"takeover gaps: p50 {metrics['takeover_gap_p50_s']}s "
            f"p95 {metrics['takeover_gap_p95_s']}s "
            f"max {metrics['takeover_gap_max_s']}s"
        )
    lines.append("")
    for job_id in sorted(jobs):
        tl = jobs[job_id]
        chain = " → ".join(
            f"{s['kind']}@{s['daemon'][:12]}"
            f"[{(s['t1_us'] - s['t0_us']) / 1e6:.3f}s]"
            for s in tl["segments"]
        ) or "(no slices captured)"
        wall = (
            f" wall {(tl['terminal_us'] - tl['admission_us']) / 1e6:.3f}s"
            if tl["admission_us"] is not None
            and tl["terminal_us"] is not None else ""
        )
        check = (
            "" if tl["sum_check_ok"] is None
            else " ✓" if tl["sum_check_ok"] else " SUM-CHECK FAIL"
        )
        lines.append(f"{job_id}: {tl['state']}{wall}{check}  {chain}")
        for g in tl["gaps"]:
            if g["kind"] != "queue_wait" or g is tl["gaps"][0]:
                lines.append(
                    f"  gap {g['kind']}: "
                    f"{(g['t1_us'] - g['t0_us']) / 1e6:.3f}s"
                )
    if stitched["warnings"]:
        lines.append("")
        for w in stitched["warnings"]:
            lines.append(f"warning: {w}")
    if stitched["problems"]:
        lines.append("")
        for p in stitched["problems"]:
            lines.append(f"PROBLEM: {p}")
    return lines
