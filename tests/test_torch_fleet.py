"""The port's fleet flight recorder (telemetry/fleet.py and
tools/fleet_report) and the bench's four fleet legs against the JAX
package's.

- Fixtures: on the committed 2-daemon captures
  (tests/data/fleet.fixture.{a,b}.trace.jsonl: a SIGKILL takeover
  mid-slice and a K=2 sharded parent) and on tampered variants of them,
  the port's ``load_captures``, ``stitch``, ``fleet_metrics``,
  ``render_prom``, ``render_report`` and ``fleet_to_chrome`` equal the
  JAX functions' outputs, and each tamper is caught with the JAX
  problem text; ``check_slo`` equals JAX's on a table of gates.
  ``run_device`` equals JAX's under a ``DUT_PEAK_TFLOPS`` override and
  otherwise scores against the port's own peak entry.
- The CLI: ``python -m duplexumiconsensusreads_torch.tools.fleet_report``
  prints the JAX tool's ``--json`` on the same files, and exits as it
  does: 0, 1 on a tampered capture or a violated ``--check-slo``, 2 on
  usage errors.
- Live, on the CPU: a daemon subprocess SIGKILLed mid-slice and taken
  over by a second daemon, and a K=4 sharded parent through two
  in-process daemons, each stitch exactly once with every sum-check
  green, and the JAX stitcher reads the port's captures alike.
- The bench's serve_fleet, serve_defense, serve_shard and serve_xhost
  legs, on the CPU at a tiny DUT_BENCH_SERVE_READS, give the JAX legs'
  keys, with the stitch green.
"""

from __future__ import annotations

import copy
import importlib.util
import inspect
import json
import os
import signal
import subprocess
import sys
import threading
import time

import pytest

from duplexumiconsensusreads_tpu import benchmark as jax_bench
from duplexumiconsensusreads_tpu.io import simulated_bam
from duplexumiconsensusreads_tpu.simulate import SimConfig
from duplexumiconsensusreads_tpu.telemetry import chrome as jax_chrome
from duplexumiconsensusreads_tpu.telemetry import fleet as jfleet
from duplexumiconsensusreads_torch import benchmark
from duplexumiconsensusreads_torch.runtime import faults
from duplexumiconsensusreads_torch.runtime.stream import stream_call_consensus
from duplexumiconsensusreads_torch.serve import ConsensusService, client
from duplexumiconsensusreads_torch.serve.job import job_params, serve_provenance, validate_spec
from duplexumiconsensusreads_torch.telemetry import chrome, fleet
from duplexumiconsensusreads_torch.telemetry.device import round_mfu
from duplexumiconsensusreads_torch.tools import fleet_report

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = [os.path.join(REPO, "tests", "data", f"fleet.fixture.{x}.trace.jsonl")
            for x in ("a", "b")]
CONFIG = dict(grouping="adjacency", mode="duplex", capacity=128, chunk_reads=120)
# the subprocesses keep to two threads each: the suite runs beside other
# files' daemons on a shared host
ENV = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2")
DAEMON = [sys.executable, "-m", "duplexumiconsensusreads_torch.serve.daemon"]
TOOL = [sys.executable, "-m", "duplexumiconsensusreads_torch.tools.fleet_report"]


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_fleet_report", os.path.join(REPO, "tools", "fleet_report.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JAX_TOOL = _jax_tool()


@pytest.fixture(autouse=True)
def _clean_faults():
    yield
    faults.uninstall()


# ---- the committed fixtures and tampered copies of them

def _fixture():
    out = []
    for p in FIXTURES:
        with open(p) as f:
            out.append([json.loads(line) for line in f])
    return out


def _write(path, records):
    with open(path, "w") as f:
        for r in records:
            f.write(json.dumps(r, separators=(",", ":")) + "\n")
    return str(path)


def _ev(name, t, job, **attrs):
    return {"type": "event", "name": name, "t": t, "lane": f"job-{job}", "job": job, **attrs}


def _drop(records, name, job):
    out = [r for r in records if not (r.get("name") == name and r.get("job") == job)]
    if out[-1].get("type") == "summary":
        out[-1] = dict(out[-1], n_events=out[-1]["n_events"] - 1)  # a "smart" tamper
    return out


def _scenario(name, tmp_path):
    """(capture paths, journal, expected problem text or None)."""
    a, b = _fixture()
    if name == "committed":
        return list(FIXTURES), None, None
    if name == "dropped_start":
        return [_write(tmp_path / "sa.trace.jsonl", a),
                _write(tmp_path / "sb.trace.jsonl", _drop(b, "job_started", "job-pp.s001"))
                ], None, "no matching job_started"
    if name == "dropped_end":
        return [_write(tmp_path / "sa.trace.jsonl", a),
                _write(tmp_path / "sb.trace.jsonl", _drop(b, "job_completed", "job-pp.s000"))
                ], None, "never closed in a clean capture"
    if name == "duplicate_terminal":
        dup = _ev("job_completed", 1.25, "job-aa", wall_s=1.0, token=1)
        return [_write(tmp_path / "sa.trace.jsonl", a + [dup]),
                _write(tmp_path / "sb.trace.jsonl", b)], None, "duplicate terminal"
    if name == "no_epoch":
        del a[0]["epoch_m"]
        return [_write(tmp_path / "sa.trace.jsonl", a),
                _write(tmp_path / "sb.trace.jsonl", b)], None, "epoch_m"
    if name == "prev_history":
        a2 = [{"type": "meta", "version": 1, "kind": "service",
               "clock": "monotonic-relative", "epoch_m": 1005.0, "daemon_id": "fleet-a"},
              _ev("job_accepted", 0.1, "job-cc", priority=1, seq=3, queue_depth=1),
              _ev("job_started", 0.2, "job-cc", slice=1, warm=False, resumed=False, token=1),
              _ev("job_completed", 0.9, "job-cc", wall_s=0.7, token=1, n_chunks=3,
                  n_consensus=5, warm=False, seconds={})]
        a2.append({"type": "summary", "t": 1.0, "n_events": len(a2) - 1, "n_dropped": 0})
        _write(tmp_path / "service.fleet-a.trace.jsonl.prev", a)
        _write(tmp_path / "service.fleet-a.trace.jsonl", a2)
        _write(tmp_path / "service.fleet-b.trace.jsonl", b)
        return fleet.discover_service_captures(str(tmp_path)), None, None
    if name == "same_life_twice":
        return [_write(tmp_path / "sa.trace.jsonl", a),
                _write(tmp_path / "sa-copy.trace.jsonl", a),
                _write(tmp_path / "sb.trace.jsonl", b)], None, "duplicate capture"
    if name == "journal_slices":
        a.append({"type": "summary", "t": 1.4, "n_events": len(a) - 1, "n_dropped": 0})
        a = [r for r in a if r.get("job") != "job-bb"]
        a[-1]["n_events"] -= 2
        journal = {"job-aa": {"state": "done", "slices": 3, "priority": 1}}
        return [_write(tmp_path / "sa.trace.jsonl", a),
                _write(tmp_path / "sb.trace.jsonl", b)], journal, "journal says 3 slices"
    if name == "journal_agrees":
        journal = {"job-aa": {"state": "done", "slices": 1, "priority": 1,
                              "admitted_m": 1000.05},
                   "job-gone": {"state": "done", "slices": 1}}
        return list(FIXTURES), journal, None
    raise AssertionError(name)


SCENARIOS = ["committed", "dropped_start", "dropped_end", "duplicate_terminal", "no_epoch",
             "prev_history", "same_life_twice", "journal_slices", "journal_agrees"]


@pytest.mark.parametrize("name", SCENARIOS)
def test_stitch_and_renderings_equal_jax(tmp_path, name):
    paths, journal, problem = _scenario(name, tmp_path)
    caps, jcaps = fleet.load_captures(paths), jfleet.load_captures(paths)
    assert caps == jcaps
    st = fleet.stitch(copy.deepcopy(caps), journal=journal)
    assert st == jfleet.stitch(copy.deepcopy(jcaps), journal=journal)
    m = fleet.fleet_metrics(st)
    assert m == jfleet.fleet_metrics(st)
    assert fleet.render_prom(m) == jfleet.render_prom(m)
    assert fleet.render_report(st, m) == jfleet.render_report(st, m)
    assert chrome.fleet_to_chrome(st) == jax_chrome.fleet_to_chrome(st)
    if problem is None:
        assert st["ok"], st["problems"]
        for tl in st["jobs"].values():
            assert tl["sum_check_ok"] in (True, None)
    else:
        assert not st["ok"] and any(problem in p for p in st["problems"])


def test_committed_timelines_tile_exactly():
    st = fleet.stitch(fleet.load_captures(FIXTURES))
    bb = st["jobs"]["job-bb"]
    assert [(s["kind"], s["daemon"], s["end"]) for s in bb["segments"]] == [
        ("run", "fleet-a", "takeover"), ("run", "fleet-b", "completed")]
    assert [g["kind"] for g in bb["gaps"]] == ["queue_wait", "takeover"]
    total = sum(s["t1_us"] - s["t0_us"] for s in bb["segments"])
    total += sum(g["t1_us"] - g["t0_us"] for g in bb["gaps"])
    assert total == bb["wall_us"] == bb["terminal_us"] - bb["admission_us"]
    pp = st["jobs"]["job-pp"]
    assert [s["kind"] for s in pp["segments"]] == ["split", "merge"]
    assert [g["kind"] for g in pp["gaps"]] == ["queue_wait", "fanned"]
    # fleet-a died holding job-bb (no summary): its slice closes at the
    # reclaim, and the daemon is marked unclean, never a failure
    assert st["ok"] and st["daemons"]["fleet-a"]["clean"] is False


@pytest.mark.parametrize("name", ["FLEET_SEGMENT_KINDS", "FLEET_GAP_KINDS",
                                  "FLEET_METRIC_KEYS", "__all__"])
def test_registries_equal_jax(name):
    assert getattr(fleet, name) == getattr(jfleet, name)


def test_seg_and_gap_constructors_refuse_unknown_kinds():
    with pytest.raises(ValueError, match="segment kind"):
        fleet.seg_rec("warp", 0, 1, "d")
    with pytest.raises(ValueError, match="gap kind"):
        fleet.gap_rec("warp", 0, 1)
    assert fleet.seg_rec("run", 1, 2, "d", token=1) == jfleet.seg_rec("run", 1, 2, "d", token=1)


def _metrics():
    return fleet.fleet_metrics(fleet.stitch(fleet.load_captures(FIXTURES)))


@pytest.mark.parametrize("slo", [
    {"e2e_p95_s": {"max": 0.01}},
    {"e2e_p95_s": {"max": 60.0}, "queue_wait_p95_s": {"max": 60.0, "class": "1"}},
    {"queue_wait_p95_s": {"min": 5.0, "class": 0}},
    {"not_a_metric": {"max": 1.0}},
    {"deadline_hit_rate": {"min": 0.9}},
    {"e2e_p95_s": 3},
    {"fleet_takeovers": {"max": 0}, "fleet_done": {"min": 5, "max": 5}},
], ids=lambda v: ",".join(v))
def test_check_slo_equals_jax(slo):
    m = _metrics()
    assert fleet.check_slo(m, slo) == jfleet.check_slo(m, slo)


def test_metrics_totals_and_merged_samples_equal_jax():
    st = fleet.stitch(fleet.load_captures(FIXTURES))
    docs = [{"daemon_id": "fleet-a", "class_latency_samples": {"1": {"ttfc": [0.5, 0.7]}}},
            {"daemon_id": "fleet-b", "class_latency_samples": {"1": {"ttfc": [0.9]}},
             "job_bytes": {"job-bb": {"h2d_bytes": 10, "d2h_bytes": 4, "device_flops": 2e6,
                                      "device_s": 0.5}}}]
    m = fleet.fleet_metrics(st, metrics_docs=docs)
    assert m == jfleet.fleet_metrics(st, metrics_docs=docs)
    assert m["fleet_jobs"] == m["fleet_done"] == 5 and m["fleet_takeovers"] == 1
    assert m["takeover_gap_max_s"] == pytest.approx(0.1)
    assert m["ttfc_p50_s"] == pytest.approx(0.7) and m["classes"]["1"]["n_ttfc"] == 3
    assert set(m) == set(fleet.FLEET_METRIC_KEYS) | {"classes", "daemons", "sum_check_ok",
                                                     "n_problems"}
    text = fleet.render_prom(m)
    assert "dut_fleet_fleet_done 5" in text and 'class="0"' in text


DEV = dict(cap=128, cycles=9, buckets=1, method="segment_gemm", h2d_wire=10, d2h_wire=10,
           disp_s=0.01)
DEV_RECS = [{"type": "meta", "version": 1, "kind": "run", "clock": "monotonic-relative"},
            {"type": "dev", "t": 0.0, "dur": 1.0, "chunk": 0, "lane": "drain-0",
             "flops": 197e6, **DEV},
            {"type": "dev", "t": 1.0, "dur": 0.5, "chunk": 1, "lane": "drain-1",
             "flops": 50e6, **dict(DEV, cap=256)}]


def test_run_device_equals_jax_under_a_peak_override(monkeypatch):
    caps = [{"path": "a.trace.jsonl", "records": DEV_RECS},
            {"path": "b.trace.jsonl", "records": DEV_RECS}]
    monkeypatch.setenv("DUT_PEAK_TFLOPS", "50")
    d = fleet.run_device(caps)
    assert d == jfleet.run_device(caps)
    assert d["peak_entry"] == "env:50T" and d["n_runs"] == 2
    assert d["flops"] == pytest.approx(2 * 247e6) and d["busy_s"] == pytest.approx(3.0)
    assert fleet.run_device([{"path": "c", "records": DEV_RECS[:1]}]) == {}


def test_run_device_scores_against_the_ports_peak(monkeypatch):
    monkeypatch.delenv("DUT_PEAK_TFLOPS", raising=False)
    caps = [{"path": "a.trace.jsonl", "records": DEV_RECS}]
    d, j = fleet.run_device(caps), jfleet.run_device(caps)
    assert d["peak_entry"] == "default-h100-sxm-f32" != j["peak_entry"]
    assert d["mfu"] == round_mfu(247e6 / 1.5 / 66.9e12) > 0
    for k in ("n_runs", "flops", "busy_s"):
        assert d[k] == j[k]
    assert {k: (c["flops"], c["busy_s"]) for k, c in d["classes"].items()} == {
        k: (c["flops"], c["busy_s"]) for k, c in j["classes"].items()}


# ---- the CLI

def _main(mod, argv, capsys):
    rc = mod.main(argv)
    out, err = capsys.readouterr()
    return rc, out, err


@pytest.mark.parametrize("name, extra", [
    ("committed", ["--json"]),
    ("committed", []),
    ("dropped_start", ["--json"]),
    ("committed", ["--json", "--slo", "TIGHT", "--check-slo"]),
    ("committed", ["--slo", "LOOSE", "--check-slo"]),
    ("prev_history", ["--json"]),
], ids=lambda v: v if isinstance(v, str) else " ".join(v))
def test_fleet_report_equals_the_jax_tool(tmp_path, capsys, name, extra):
    paths, _, problem = _scenario(name, tmp_path)
    (tmp_path / "tight.toml").write_text("[e2e_p95_s]\nmax = 0.01\n")
    (tmp_path / "loose.toml").write_text("[e2e_p95_s]\nmax = 60.0\n")
    extra = [str(tmp_path / "tight.toml") if a == "TIGHT" else
             str(tmp_path / "loose.toml") if a == "LOOSE" else a for a in extra]
    ours = _main(fleet_report, [*paths, *extra], capsys)
    theirs = _main(JAX_TOOL, [*paths, *extra], capsys)
    assert ours == theirs
    want_rc = 1 if problem or any(a.endswith("tight.toml") for a in extra) else 0
    assert ours[0] == want_rc
    if "--json" in extra:
        doc = json.loads(ours[1])
        assert doc["ok"] is (want_rc == 0)
    if problem:
        assert "FLEET TIMELINE DRIFT" in ours[2]


@pytest.mark.parametrize("argv_of, rc", [
    (lambda t: [FIXTURES[0], "--check-slo"], 2),
    (lambda t: [str(t / "empty")], 1),
    (lambda t: [str(t / "empty"), str(t / "empty2")], 2),
])
def test_fleet_report_usage_exits_as_jax(tmp_path, capsys, argv_of, rc):
    (tmp_path / "empty").mkdir()
    (tmp_path / "empty2").mkdir()
    argv = argv_of(tmp_path)
    ours, theirs = _main(fleet_report, argv, capsys), _main(JAX_TOOL, argv, capsys)
    assert ours == theirs and ours[0] == rc


def test_fleet_report_module_entry_point(tmp_path):
    out = str(tmp_path / "m.json")
    prom, chrome_path = str(tmp_path / "f.prom"), str(tmp_path / "f.json")
    p = subprocess.run(TOOL + [*FIXTURES, "--out", out, "--prom", prom, "--chrome", chrome_path],
                       capture_output=True, text=True, timeout=120, env=ENV)
    assert p.returncode == 0, p.stderr
    assert "fleet: 2 daemons, 5 jobs (5 done" in p.stdout
    with open(out) as f:
        assert json.load(f)["fleet_takeovers"] == 1
    assert os.path.getsize(prom) > 0 and json.load(open(chrome_path))["traceEvents"]
    paths, _, _ = _scenario("dropped_end", tmp_path)
    p = subprocess.run(TOOL + paths, capture_output=True, text=True, timeout=120, env=ENV)
    assert p.returncode == 1 and "FLEET TIMELINE DRIFT" in p.stderr


# ---- live fleets on the CPU

@pytest.fixture(scope="module")
def sim(tmp_path_factory):
    """(input path, bytes of the one-shot port stream with the job's
    provenance line)."""
    d = tmp_path_factory.mktemp("torch_fleet")
    path = str(d / "in.bam")
    simulated_bam(SimConfig(n_molecules=70, read_len=60, n_positions=9, umi_error=0.02,
                            seed=31), path=path, sort=True)
    out = str(d / "ref.bam")
    spec = validate_spec({"job_id": "ref", "input": path, "output": out, "config": CONFIG})
    gp, cp, kw = job_params(spec)
    kw.pop("mesh")
    rep = stream_call_consensus(path, out, gp, cp, device="cpu",
                                provenance_cl=serve_provenance(CONFIG), **kw)
    assert rep.n_chunks >= 3
    with open(out, "rb") as f:
        return path, f.read()


def _stitch_spool(mod, spool):
    caps = mod.load_captures(mod.discover_service_captures(spool))
    return mod.stitch(caps, journal=mod.load_journal(os.path.join(spool, "queue.json")))


def _wait_for(pred, timeout_s, what, proc):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return
        if proc.poll() is not None:
            raise AssertionError(f"daemon exited before {what}: {proc.communicate()[1]}")
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


def test_sigkill_takeover_stitches_exactly_once(sim, tmp_path):
    in_path, ref_bytes = sim
    spool = str(tmp_path / "spool")
    jobs = []
    for i in range(2):
        out = str(tmp_path / f"out{i}.bam")
        jobs.append((client.submit(spool, in_path, out, config=dict(CONFIG)), out))
    a = subprocess.Popen(DAEMON + [spool, "--device", "cpu", "--poll", "0.05", "--heartbeat",
                                   "0.2", "--lease", "30", "--daemon-id", "fl-A"],
                         env=ENV, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True)
    cap_a = os.path.join(spool, "service.fl-A.trace.jsonl")

    def a_in_slice():
        """A holds a job's lease and its capture has recorded that
        slice's start: killed between the claim's journal commit and
        that record, A would leave no slice of its own to take over."""
        try:
            with open(cap_a) as f:
                started = {json.loads(line).get("job") for line in f
                           if '"job_started"' in line and line.endswith("\n")}
        except OSError:
            return False
        return any(j in started
                   and (client.status(spool, j).get("lease") or {}).get("owner") == "fl-A"
                   for j, _ in jobs)

    try:
        _wait_for(a_in_slice, 120, "a claimed slice in A's capture", a)
        a.send_signal(signal.SIGKILL)
        a.communicate(timeout=30)
    finally:
        if a.poll() is None:
            a.kill()
            a.communicate(timeout=30)
    ConsensusService(spool, device="cpu", poll_s=0.02, chunk_budget=0, daemon_id="fl-B",
                     trace_path=os.path.join(spool, "service.fl-B.trace.jsonl")
                     ).run_until_idle()
    for jid, out in jobs:
        assert client.status(spool, jid)["state"] == "done"
        with open(out, "rb") as f:
            assert f.read() == ref_bytes
    st = _stitch_spool(fleet, spool)
    assert st["ok"], st["problems"]
    # the JAX stitcher reads the port's captures alike
    assert st == _stitch_spool(jfleet, spool)
    n_takeover_segs = 0
    for jid, _ in jobs:
        tl = st["jobs"][jid]
        assert tl["state"] == "done" and tl["sum_check_ok"] is True
        ends = [s["end"] for s in tl["segments"]]
        assert ends.count("completed") == 1
        n_takeover_segs += ends.count("takeover")
    assert n_takeover_segs == 1
    m = fleet.fleet_metrics(st, metrics_docs=fleet.load_metrics_docs(spool))
    assert m["fleet_takeovers"] == 1 and m["fleet_done"] == 2
    assert m["takeover_gap_max_s"] is not None and m["e2e_p95_s"] > 0
    p = subprocess.run(TOOL + [spool, "--json"], capture_output=True, text=True,
                       timeout=120, env=ENV)
    assert p.returncode == 0, p.stdout + p.stderr
    assert json.loads(p.stdout)["metrics"]["fleet_takeovers"] == 1
    assert os.path.exists(os.path.join(spool, "fleet_metrics.json"))


def test_sharded_parent_k4_stitches_exactly_once(sim, tmp_path):
    in_path, ref_bytes = sim
    spool = str(tmp_path / "spool")
    out = str(tmp_path / "sharded.bam")
    parent = client.submit(spool, in_path, out, config=dict(CONFIG), shards=4)
    svcs = [ConsensusService(spool, device="cpu", chunk_budget=2, poll_s=0.02,
                             daemon_id=f"live-{i}",
                             trace_path=os.path.join(spool, f"service.live-{i}.trace.jsonl"))
            for i in range(2)]
    threads = [threading.Thread(target=s.run_until_idle, daemon=True) for s in svcs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert client.status(spool, parent)["state"] == "done"
    with open(out, "rb") as f:
        assert f.read() == ref_bytes
    st = _stitch_spool(fleet, spool)
    assert st["ok"], st["problems"]
    assert st == _stitch_spool(jfleet, spool)
    tl = st["jobs"][parent]
    assert tl["state"] == "done" and tl["sum_check_ok"] is True
    kinds = [s["kind"] for s in tl["segments"]]
    assert kinds[0] == "split" and kinds[-1] == "merge"
    assert "fanned" in [g["kind"] for g in tl["gaps"]]
    children = [j for j in st["jobs"] if j.startswith(parent + ".s")]
    assert len(children) == 4
    for cid in children:
        c = st["jobs"][cid]
        assert c["state"] == "done" and c["sum_check_ok"] is True
        assert [s["end"] for s in c["segments"]].count("completed") == 1
    m = fleet.fleet_metrics(st)
    assert m["fleet_splits"] == 1 and m["fleet_merges"] == 1


# ---- the bench's fleet legs

LEG_KEYS = {
    "run_serve_fleet_bench": {
        "serve_fleet_daemons", "serve_fleet_jobs", "serve_fleet_wall_s",
        "serve_fleet_takeover_latency_s", "serve_fleet_recovered",
        "serve_fleet_class_queue_wait", "serve_fleet_stitch_ok", "fleet_e2e_p95_s",
        "fleet_takeover_gap_s"},
    "run_serve_defense_bench": {"serve_quarantine_after_crashes",
                                "serve_watchdog_detect_latency_s"},
    "run_serve_shard_bench": {"serve_shard_daemons", "serve_shard_k1_wall_s",
                              "serve_shard_k4_wall_s", "serve_shard_speedup",
                              "serve_shard_merge_s"},
    "run_serve_xhost_bench": {"serve_xhost_hosts", "serve_xhost_lease_s",
                              "serve_xhost_takeover_latency_s", "serve_xhost_recovered"},
}


@pytest.mark.parametrize("leg", sorted(LEG_KEYS))
def test_fleet_bench_leg_gives_the_jax_keys(tmp_path, monkeypatch, leg):
    # each expected key is one the JAX leg writes
    src = inspect.getsource(getattr(jax_bench, leg))
    assert all(f'"{k}"' in src for k in LEG_KEYS[leg])
    monkeypatch.setenv("DUT_BENCH_SERVE_READS", "2000")
    monkeypatch.setenv("DUT_BENCH_CACHE", str(tmp_path / "cache"))
    monkeypatch.setenv("DUT_BENCH_CAPACITY", "256")
    fn = getattr(benchmark, leg)
    out = fn(2, "cpu") if leg in ("run_serve_fleet_bench", "run_serve_shard_bench") else fn("cpu")
    assert not [k for k in out if k.endswith("_error")], out
    assert set(out) == LEG_KEYS[leg]
    if leg == "run_serve_fleet_bench":
        assert out["serve_fleet_stitch_ok"] is True and out["serve_fleet_recovered"] == 1
        assert out["fleet_takeover_gap_s"] >= 0 and out["fleet_e2e_p95_s"] > 0
    elif leg == "run_serve_defense_bench":
        assert out["serve_quarantine_after_crashes"] == 3
    elif leg == "run_serve_xhost_bench":
        assert out["serve_xhost_recovered"] == 1
        assert out["serve_xhost_takeover_latency_s"] >= out["serve_xhost_lease_s"] * 0.5


def test_defense_leg_times_the_wedge_when_every_first_chunk_is_slow(tmp_path, monkeypatch):
    # every slice's first commit takes longer than the leg's 0.5 s
    # watchdog threshold (plus its 0.25 s tick), as slice start-up can
    # on a loaded host: the watchdog must still time the wedge, not
    # reclaim the slow first chunks until the job is quarantined
    from duplexumiconsensusreads_torch.serve import worker

    renew = worker.fenced_renew
    slowed = set()

    def slow_first_renewal(queue, job_id, daemon_id, token, *args, **kwargs):
        if (job_id, token) not in slowed:
            slowed.add((job_id, token))
            time.sleep(1.0)
        return renew(queue, job_id, daemon_id, token, *args, **kwargs)

    monkeypatch.setattr(worker, "fenced_renew", slow_first_renewal)
    monkeypatch.setenv("DUT_BENCH_SERVE_READS", "2000")
    monkeypatch.setenv("DUT_BENCH_CACHE", str(tmp_path / "cache"))
    monkeypatch.setenv("DUT_BENCH_CAPACITY", "256")
    out = benchmark.run_serve_defense_bench("cpu")
    assert set(out) == LEG_KEYS["run_serve_defense_bench"], out
    assert out["serve_quarantine_after_crashes"] == 3
    assert 0.25 < out["serve_watchdog_detect_latency_s"] < 30
    assert slowed
