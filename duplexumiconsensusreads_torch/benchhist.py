"""Bench-trajectory analysis: the recorded bench rounds of the torch
port (``BENCH_torch_rNN.json``) as a time series, and the regression
gate over it. The JAX package's benchhist, with one change: the
default trajectory is the port's own files, never the JAX package's
``BENCH_rNN.json`` rounds (those ran on another device, and the gate
must never compare a card run with them).

A round file is ``{"n", "cmd", "rc", "tail", "parsed"}``: ``tail`` is a
BOUNDED suffix (~2000 bytes) of the bench's merged stdout+stderr and
``parsed`` the JSON line the recorder could recover from that window.
When the bench's result line outgrows the window its head falls off,
``parsed`` is null and the round's canonical metrics survive only as a
truncated JSON FRAGMENT in the tail: :func:`salvage_metrics` recovers
every scalar ``"key": value`` pair from such fragments, so the round
still contributes to the trajectory instead of reading as a gap. The
bench itself (benchmark.main) keeps its LAST stdout line a compact
canonical summary that fits the window, with the full result printed on
the line above and mirrored to ``<cache>/bench_full.json``.

The gate (:func:`check_regression`): compare each canonical metric's
latest reading against the previous round that measured it; a drop
beyond the threshold exits 1 through ``tools.bench_history --check``.
The default threshold is deliberately loose (50%): host-clock numbers
spread between runs on a shared host, and a gate that cries weather
trains everyone to ignore it; it exists to catch a metric silently
halving or vanishing, not 10% noise.
"""

from __future__ import annotations

import json
import os
import re

# canonical trajectory metrics, in display order: (key, higher_is_better,
# gate) — `gate` marks the metrics --check defends by default. Keys
# match the bench JSON (compact line and full result alike).
CANONICAL_METRICS = (
    ("value", True, True),  # device-compute reads/s (the headline)
    ("mfu", True, False),
    ("e2e_reads_per_sec", True, True),
    ("e2e_wall_s", False, False),
    # device ledger (telemetry/devledger.py): e2e MFU measured from the
    # capture's own dev records, and the fraction of the measured
    # roofline the run attained — informational, never gated (both
    # follow the host's spread and the capture's own device windows)
    ("e2e_mfu", True, False),
    ("e2e_roofline_frac", True, False),
    ("e2e_wire_floor_frac", False, False),
    ("e2e_wire_floor_frac_measured", False, False),
    ("e2e_bytes_per_read", False, False),
    ("e2e_packed_speedup", True, False),
    # the packed wire: what the packed consensus-only return path
    # buys on its own, the H2D rung the canonical leg actually ran
    # (16/8/7/5 bits per cycle), and the bounded prefetch window —
    # informational, never gated (rung choice follows the input's qual
    # alphabet; depth is a config echo)
    ("e2e_d2h_packed_speedup", True, False),
    ("e2e_h2d_bits_per_cycle", False, False),
    ("e2e_prefetch_depth", False, False),
    # bucket auto-tuner: measured fill of the long-tail fixture
    # under the auto verdict and the verdict's cost-model ratio —
    # informational, never gated (shape decisions follow the input mix)
    ("e2e_fill_factor", True, False),
    ("tuner_predicted_speedup", True, False),
    ("e2e_vs_cpu_e2e", True, False),
    ("serve_amortised_speedup", True, False),
    # defensive serving: quarantine depth should sit AT the
    # max_crashes bound (lower = gave up early, higher = re-ran poison)
    # and watchdog latency is a detection cost — informational only,
    # never gated (they characterise defense policy, not throughput)
    ("serve_quarantine_after_crashes", False, False),
    ("serve_watchdog_detect_latency_s", False, False),
    # fleet flight recorder (tools/fleet_report.py): e2e p95 and the
    # takeover recovery gap measured from the serve_fleet leg's OWN
    # stitched captures — informational, never gated (single-host
    # in-process fleets measure scheduling, not production latency)
    ("fleet_e2e_p95_s", False, False),
    ("fleet_takeover_gap_s", False, False),
    # scatter-gather sharding (serve/shard/): single-host fleets share
    # one device, so the K=4/K=1 ratio characterises scheduling +
    # pipeline-overlap headroom, not device scaling — informational,
    # never gated
    ("serve_shard_speedup", True, False),
    ("serve_shard_merge_s", False, False),
    # cross-host fleet (sharedfs lease store): takeover latency is
    # lease-expiry-dominated by design (pid-free detection waits out
    # the translated lease, never probes a pid) and the recovery count
    # is a scenario invariant — informational, never gated
    ("serve_xhost_takeover_latency_s", False, False),
    ("serve_xhost_recovered", True, False),
    # mesh-sharded execution (real multi-device consensus): the e2e
    # leg's resolved device count and the K-vs-1 wall ratio of the
    # mesh-scaling A/B — informational, never gated (simulated CPU
    # devices share the host's cores; judge scaling on real silicon)
    ("e2e_mesh_devices", False, False),
    ("e2e_mesh_scaling", True, False),
    # live follow-mode (live/): first-snapshot latency and steady lag
    # behind the paced synthetic writer — informational, never gated
    # (both numbers follow the writer's slab cadence, not the pipeline)
    ("live_first_snapshot_latency_s", False, False),
    ("live_steady_lag_chunks", False, False),
)

_NUM = r"-?(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?"
# `"key": 1.5`, `"key": [1.5, 2.5]` — the scalar shapes the canonical
# metrics use; strings/objects are context, not trajectory data
_PAIR_RE = re.compile(
    rf'"([A-Za-z0-9_]+)":\s*({_NUM}|\[\s*{_NUM}(?:\s*,\s*{_NUM})*\s*\])'
)


def salvage_metrics(tail: str) -> dict:
    """Recover numeric ``"key": value`` pairs from a bounded tail whose
    JSON line may be truncated at the HEAD. Whole
    parseable JSON lines win over fragment scans; within fragments the
    last occurrence of a key wins (later lines are later output)."""
    out: dict = {}
    for line in tail.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        try:
            d = json.loads(line)
        except ValueError:
            d = None
        if isinstance(d, dict):
            out.update(d)
            continue
        if '"' not in line:
            continue
        for key, val in _PAIR_RE.findall(line):
            try:
                out[key] = json.loads(val)
            except ValueError:
                continue
    return out


def _metric_value(d: dict, key: str):
    """One representative float for a metric, or None. List values
    (the probe-bracketed floor fracs like [0.63, 0.72]) read as their
    midpoint — a single trajectory needs a single number."""
    v = d.get(key)
    if isinstance(v, bool):
        return None
    if isinstance(v, (int, float)):
        return float(v)
    if (
        isinstance(v, list)
        and v
        and all(isinstance(x, (int, float)) and not isinstance(x, bool)
                for x in v)
    ):
        return round(sum(float(x) for x in v) / len(v), 6)
    return None


def load_round(path: str) -> dict:
    """One round file -> {"name", "path", "metrics", "salvaged",
    "rc"}. ``metrics`` comes from ``parsed`` when the recorder recovered
    it, else from the tail salvage; a bench RESULT json (no tail — the
    --candidate form) is used as-is."""
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict):
        raise ValueError(f"{path}: not a JSON object")
    name = os.path.basename(path)
    name = re.sub(r"^BENCH_|\.json$", "", name)
    if "tail" in doc or "parsed" in doc:
        parsed = doc.get("parsed")
        salvaged = not isinstance(parsed, dict)
        metrics = (
            dict(parsed) if isinstance(parsed, dict)
            else salvage_metrics(str(doc.get("tail") or ""))
        )
        rc = doc.get("rc")
    else:
        metrics, salvaged, rc = dict(doc), False, None
    return {
        "name": name, "path": path, "metrics": metrics,
        "salvaged": salvaged, "rc": rc,
    }


def default_paths(root: str = ".") -> list[str]:
    """The port's trajectory files in ``root``, in round order (their
    zero-padded names sort correctly). Only ``BENCH_torch_r*`` rounds:
    the JAX package's ``BENCH_r*`` rounds ran on another device."""
    import glob

    return sorted(glob.glob(os.path.join(root, "BENCH_torch_r[0-9]*.json")))


def trajectory(rounds: list[dict]) -> dict:
    """The canonical-metric table: per metric, the per-round readings
    and the delta (%) between the last two rounds that measured it."""
    out: dict = {"rounds": [r["name"] for r in rounds], "metrics": {}}
    for key, higher, gate in CANONICAL_METRICS:
        vals = [_metric_value(r["metrics"], key) for r in rounds]
        present = [(i, v) for i, v in enumerate(vals) if v is not None]
        row = {"values": vals, "higher_is_better": higher, "gate": gate}
        if len(present) >= 2:
            (_, prev), (_, last) = present[-2], present[-1]
            row["delta_pct"] = (
                round((last - prev) / abs(prev) * 100, 1) if prev else None
            )
        out["metrics"][key] = row
    return out


def check_regression(
    rounds: list[dict],
    threshold: float = 0.5,
    metrics: list[str] | None = None,
) -> tuple[bool, list[str]]:
    """The gate: for each gate metric, the NEWEST round's reading must
    not regress beyond ``threshold`` (fractional, on the
    better-direction axis) against the previous round that measured
    it. A metric the newest round did not measure is SKIPPED entirely
    — a tiny smoke bench must not fail the gate for not running the
    e2e leg, and the gate must never re-litigate a regression between
    two HISTORICAL rounds the current run had no part in (an earlier
    dip is recorded fact, not this run's fault). A parse hole shows as
    the round's ``parsed`` being null (salvage keeps the trajectory,
    the last-line contract keeps new rounds parseable)."""
    if not (0 < threshold):
        raise ValueError(f"threshold must be > 0 (got {threshold})")
    gate_keys = metrics or [k for k, _, g in CANONICAL_METRICS if g]
    directions = {k: h for k, h, _ in CANONICAL_METRICS}
    problems: list[str] = []
    for key in gate_keys:
        higher = directions.get(key, True)
        readings = [
            (r["name"], _metric_value(r["metrics"], key)) for r in rounds
        ]
        if not readings or readings[-1][1] is None:
            continue  # the round under judgment didn't measure this
        present = [(n, v) for n, v in readings if v is not None]
        if len(present) < 2:
            continue
        (prev_name, prev), (last_name, last) = present[-2], present[-1]
        if prev == 0:
            continue
        drop = (prev - last) / abs(prev) if higher else (last - prev) / abs(prev)
        if drop > threshold:
            problems.append(
                f"{key}: {last_name} = {last:g} regressed "
                f"{drop * 100:.0f}% vs {prev_name} = {prev:g} "
                f"(threshold {threshold * 100:.0f}%)"
            )
    return not problems, problems


def render_table(rounds: list[dict]) -> list[str]:
    traj = trajectory(rounds)
    names = traj["rounds"]
    lines = []
    lines.append(
        f"{'metric':<30} " + " ".join(f"{n:>10}" for n in names)
        + f" {'Δ last':>8}"
    )
    for key, row in traj["metrics"].items():
        if all(v is None for v in row["values"]):
            continue
        cells = " ".join(
            f"{v:>10g}" if v is not None else f"{'-':>10}"
            for v in row["values"]
        )
        delta = row.get("delta_pct")
        dtxt = f"{delta:+.1f}%" if delta is not None else "-"
        lines.append(f"{key:<30} {cells} {dtxt:>8}")
    salvaged = [r["name"] for r in rounds if r["salvaged"]]
    if salvaged:
        lines.append(
            f"(salvaged from truncated tails: {', '.join(salvaged)} — "
            f"metrics recovered per-key, absent keys read as '-')"
        )
    return lines
