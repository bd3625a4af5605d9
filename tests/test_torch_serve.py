"""The port's serving layer (serve/ and the CLI's client verbs) against
the JAX package's.

- Specs: ``validate_spec`` accepts and refuses the JAX table of specs
  with the JAX messages; ``call --submit`` writes the JAX job file and
  job id for the same argv (the random id suffix pinned on both sides).
- Journal: the same script of queue transitions leaves the JAX journal
  (clock stamps aside), and the scheduler picks, yields and sheds as
  the JAX one does.
- Service, on the CPU: three jobs through an in-process
  ``ConsensusService(device="cpu")`` are byte-identical to the one-shot
  port stream with ``serve_provenance``; a SIGKILLed subprocess daemon's
  job is taken over and finished byte-identical (token 2); deadlines
  expire, a poison job is quarantined, admission sheds — with the JAX
  CLI's exit codes for each.
- The device: the service and the daemon default to cuda and raise
  without a card; the client verbs never initialise CUDA.
- The build-directory knob: a second process pointed at the same
  directory loads the native loader and builds nothing.
- ``tools/serve_report`` reads a port capture with the JAX report's
  keys and counts.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time

import pytest

from duplexumiconsensusreads_tpu.cli.main import main as jax_main
from duplexumiconsensusreads_tpu.io import simulated_bam
from duplexumiconsensusreads_tpu.serve import FairScheduler as JaxScheduler
from duplexumiconsensusreads_tpu.serve import SpoolQueue as JaxQueue
from duplexumiconsensusreads_tpu.serve.job import validate_spec as jax_validate
from duplexumiconsensusreads_tpu.serve.scheduler import parse_class_depths as jax_depths
from duplexumiconsensusreads_tpu.simulate import SimConfig
from duplexumiconsensusreads_torch.cli.main import main as cli_main
from duplexumiconsensusreads_torch.runtime import faults
from duplexumiconsensusreads_torch.runtime.stream import stream_call_consensus
from duplexumiconsensusreads_torch.serve import (
    ConsensusService,
    FairScheduler,
    SpoolQueue,
    client,
)
from duplexumiconsensusreads_torch.serve.job import (
    job_params,
    serve_provenance,
    spec_signature,
    validate_spec,
)
from duplexumiconsensusreads_torch.serve.scheduler import parse_class_depths
from duplexumiconsensusreads_torch.telemetry import report as trace_report

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = dict(grouping="adjacency", mode="duplex", capacity=128, chunk_reads=120)
# the subprocesses (daemons, tools) keep to two threads each: the suite
# runs beside other files' daemons on a shared host
ENV = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2")
DAEMON = [sys.executable, "-m", "duplexumiconsensusreads_torch.serve.daemon"]


@pytest.fixture(scope="module")
def sim(tmp_path_factory):
    """(input path, bytes of the one-shot port stream with the job's
    canonical provenance line): what every service output must be."""
    d = tmp_path_factory.mktemp("torch_serve")
    path = str(d / "in.bam")
    simulated_bam(SimConfig(n_molecules=70, read_len=60, n_positions=9, umi_error=0.02,
                            seed=31), path=path, sort=True)
    return path, _one_shot(path, str(d / "ref.bam"), CONFIG)


def _one_shot(path, out, config):
    spec = validate_spec({"job_id": "ref", "input": path, "output": out, "config": config})
    gp, cp, kw = job_params(spec)
    kw.pop("mesh")
    rep = stream_call_consensus(path, out, gp, cp, device="cpu",
                                provenance_cl=serve_provenance(config), **kw)
    assert rep.n_chunks >= 3
    with open(out, "rb") as f:
        return f.read()


@pytest.fixture(autouse=True)
def _clean_faults():
    yield
    faults.uninstall()


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _submit_n(spool, in_path, tmp_path, n, priority=None, prefix="out", **kw):
    return [
        (client.submit(spool, in_path, str(tmp_path / f"{prefix}{i}.bam"),
                       config=dict(CONFIG), priority=priority[i] if priority else 1, **kw),
         str(tmp_path / f"{prefix}{i}.bam"))
        for i in range(n)
    ]


def _events(trace):
    recs = trace_report.load_trace(trace)
    return recs, [r for r in recs if r.get("type") == "event"]


def _service(spool, **kw):
    return ConsensusService(spool, device="cpu", poll_s=0.02, **kw)


# ---- specs and the client's job file

def _spec(**over):
    d = {"job_id": "job-x", "input": "/i.bam", "output": "/o.bam", "config": dict(CONFIG)}
    d.update(over)
    return d


SPECS = [
    {}, {"config": {}}, {"priority": 0}, {"deadline_s": 5}, {"shards": 3},
    {"shard_bytes": 1 << 20}, {"trace": "/t.jsonl"}, {"chaos": "shard.write:2:oserror"},
    {"config": {**CONFIG, "follow": True, "finalize_on": "idle:3", "snapshot_chunks": 2}},
    {"config": {**CONFIG, "bucket_ladder": [64, 128]}},
    {"shard": {"parent": "p", "idx": 1, "k": 2, "chunk_base": 3}},
    {"config": {"chunk_reads": 0}}, {"config": {"grouping": "fuzzy"}},
    {"config": {"frobnicate": 1}}, {"priority": -1}, {"priority": True},
    {"chaos": "bogus.site:1:oserror"}, {"job_id": ""}, {"extra_field": 1},
    {"deadline_s": 0}, {"shards": 0}, {"shards": 2, "shard_bytes": 9},
    {"config": {**CONFIG, "finalize_on": "never"}},
    {"config": {**CONFIG, "live_poll_s": 0}}, {"config": {**CONFIG, "snapshot_chunks": -1}},
    {"config": {**CONFIG, "follow": True}, "shards": 2},
    {"config": {**CONFIG, "mesh": 0}}, {"config": {**CONFIG, "bucket_ladder": [64, 256]}},
    {"shard": {"parent": "p"}}, {"shard": {"parent": "p", "idx": 0, "k": 1,
                                           "chunk_base": 0}, "shards": 2},
]


@pytest.mark.parametrize("over", SPECS, ids=lambda o: json.dumps(o, sort_keys=True)[:60])
def test_validate_spec_accepts_and_refuses_as_jax(over):
    def run(fn):
        try:
            return fn(_spec(**over)).to_dict()
        except ValueError as e:
            return f"ValueError: {e}"

    assert run(validate_spec) == run(jax_validate)


@pytest.mark.parametrize("flags", [
    [],
    ["--priority", "0", "--deadline", "30"],
    ["--shards", "3", "--write-index"],
    ["--shard-bytes", "4096", "--config", "config5", "--per-base-tags"],
    ["--follow", "--finalize-on", "idle:2", "--live-poll-s", "0.5", "--snapshot-chunks", "2"],
    ["--bucket-ladder", "64,128", "--max-reads", "3", "--read-group-id", "Z"],
    ["--chaos", "shard.write:1:kill", "--trace", "t.jsonl"],
], ids=lambda f: " ".join(f) or "plain")
def test_submit_writes_the_jax_job_file_and_id(sim, tmp_path, monkeypatch, capsys, flags):
    in_path, _ = sim
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(os, "urandom", lambda n: b"\x07" * n)
    out = str(tmp_path / "o.bam")
    ids, files = [], []
    for fn, spool in ((cli_main, "ours"), (jax_main, "theirs")):
        argv = ["call", in_path, "-o", out, "--submit", "--spool", str(tmp_path / spool),
                "--grouping", "adjacency", "--mode", "duplex", "--capacity", "128",
                "--chunk-reads", "120", *flags]
        assert fn(argv) == 0
        ids.append(capsys.readouterr().out.strip())
        files.append(_read(str(tmp_path / spool / "inbox" / f"{ids[-1]}.json")))
    assert ids[0] == ids[1] and ids[0].startswith("job-")
    assert files[0] == files[1]


# ---- the journal and the scheduler

def _normalize(jobs):
    """A journal's jobs minus what depends on the clock or the process."""
    def clean(v):
        if isinstance(v, dict):
            return {k: clean(x) for k, x in v.items()
                    if not k.endswith("_m") and k not in ("pid", "host", "boot")}
        if isinstance(v, list):
            return [clean(x) for x in v]
        return v
    return clean(jobs)


def _script(q, spool, in_path, out_dir, submit):
    """One script of queue events; returns the journal after each."""
    seen = []
    ids = [submit(spool, in_path, os.path.join(out_dir, f"o{i}.bam"), config=dict(CONFIG),
                  priority=p) for i, p in enumerate((1, 0, 1, 2))]
    for jid in ids:
        q.accept_one(jid)
    seen.append(q.jobs)
    t0 = q.claim(ids[1], "d-A", 30.0)
    q.renew_lease(ids[1], "d-A", t0, 30.0, progress={"snapshot_seq": 1, "reads_emitted": 5})
    q.requeue(ids[1], 2, back=True, daemon_id="d-A", token=t0)
    seen.append(q.jobs)
    t1 = q.claim(ids[0], "d-B", 30.0)
    q.mark_done(ids[0], {"n_consensus": 7}, "d-B", t1)
    t2 = q.claim(ids[2], "d-B", 30.0)
    q.mark_failed(ids[2], "RuntimeError('x')", "d-B", t2)
    q.mark_expired(ids[3], "expired: test")
    seen.append(q.jobs)
    return ids, [_normalize(json.loads(json.dumps(s))) for s in seen]


def test_queue_transitions_equal_jax(sim, tmp_path, monkeypatch):
    from duplexumiconsensusreads_tpu.serve import client as jax_client

    in_path, _ = sim
    monkeypatch.setattr(os, "urandom", lambda n: b"\x01" * n)
    ours = _script(SpoolQueue(str(tmp_path / "a")), str(tmp_path / "a"), in_path,
                   str(tmp_path), client.submit)
    theirs = _script(JaxQueue(str(tmp_path / "b")), str(tmp_path / "b"), in_path,
                     str(tmp_path), jax_client.submit)
    assert ours == theirs
    ids = ours[0]
    for jid in ids:
        a = SpoolQueue(str(tmp_path / "a")).status(jid)
        b = JaxQueue(str(tmp_path / "b")).status(jid)
        assert _normalize(a) == _normalize(b)


@pytest.mark.parametrize("depths", [None, {1: 1}, {0: 1, 2: 2}])
def test_scheduler_matches_jax(depths):
    jobs = {
        "a": {"state": "queued", "priority": 1, "seq": 0},
        "b": {"state": "queued", "priority": 0, "seq": 5},
        "c": {"state": "queued", "priority": 1, "seq": 1},
        "d": {"state": "running", "priority": 1, "seq": 2},
        "e": {"state": "queued", "priority": 2, "seq": 3, "deadline_m": 1.0},
    }
    ours, theirs = FairScheduler(2, depths), JaxScheduler(2, depths)
    for step in range(5):
        assert ours.pick(jobs, now=2.0) == theirs.pick(jobs, now=2.0)
        for jid in jobs:
            assert ours.others_waiting(jobs, jid) == theirs.others_waiting(jobs, jid)
        for pri in (0, 1, 2):
            assert ours.shed_reason(jobs, pri) == theirs.shed_reason(jobs, pri)
        picked = ours.pick(jobs, now=2.0)
        if picked is None:
            break
        jobs[picked]["state"] = "done"
    for spec in ("0=8,1=4", " 2=1 ", "0", "a=1", "0=0", "0=-1", "-1=2", "0:3"):
        def run(fn):
            try:
                return fn(spec)
            except ValueError as e:
                return str(e)
        assert run(parse_class_depths) == run(jax_depths)


# ---- the service on the CPU

def test_three_jobs_byte_identical_and_observable(sim, tmp_path):
    in_path, ref_bytes = sim
    spool = str(tmp_path / "spool")
    trace = str(tmp_path / "service.jsonl")
    jobs = _submit_n(spool, in_path, tmp_path, 3, priority=[1, 0, 1])
    svc = _service(spool, chunk_budget=2, trace_path=trace, heartbeat_s=0.05)
    assert svc.device == "cpu"
    snap = svc.run_until_idle()
    assert snap["jobs_done"] == 3 and snap["jobs_failed"] == 0 and snap["preemptions"] >= 1
    for jid, out in jobs:
        assert _read(out) == ref_bytes
        st = client.status(spool, jid)
        assert st["state"] == "done" and st["result"]["n_consensus"] > 0
    # jobs 2 and 3 share job 1's bucket spec: warm starts
    assert svc.worker.n_spec_hits == 2 and svc.worker.n_spec_misses == 1
    with open(os.path.join(spool, "metrics.json")) as f:
        metrics = json.load(f)
    assert metrics["compile_hit_rate"] == round(2 / 3, 3)
    assert metrics["jobs_done"] == 3 and set(metrics["job_seconds"]) == {j for j, _ in jobs}
    assert set(metrics["class_latency"]) == {"0", "1"}
    for jb in metrics["job_bytes"].values():
        assert jb["h2d_bytes"] > 0 and jb["reads"] > 0 and jb["device_s"] > 0
    recs, events = _events(trace)
    assert trace_report.validate_service_trace(recs) == []
    assert trace_report.summary_record(recs) is not None
    assert {"job_accepted", "job_started", "job_completed", "job_preempted"} <= {
        e["name"] for e in events}
    # serve_report: the port tool and the JAX tool read the capture alike
    ours = subprocess.run(
        [sys.executable, "-m", "duplexumiconsensusreads_torch.tools.serve_report", trace,
         "--json"], capture_output=True, text=True, timeout=120, env=ENV)
    theirs = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "serve_report.py"), trace, "--json"],
        capture_output=True, text=True, timeout=120, env=ENV)
    assert ours.returncode == theirs.returncode == 0, ours.stderr + theirs.stderr
    rep = json.loads(ours.stdout)
    assert rep == json.loads(theirs.stdout)
    assert rep["n_jobs"] == rep["n_done"] == 3 and rep["clean_shutdown"] is True
    assert rep["n_warm_starts"] == 2 and rep["n_preemptions"] == snap["preemptions"]
    human = subprocess.run(
        [sys.executable, "-m", "duplexumiconsensusreads_torch.tools.serve_report", trace],
        capture_output=True, text=True, timeout=120, env=ENV)
    assert human.returncode == 0 and "3 jobs" in human.stdout
    chk = subprocess.run(
        [sys.executable, "-m", "duplexumiconsensusreads_torch.tools.check_trace", trace,
         "--require-summary"], capture_output=True, text=True, timeout=120, env=ENV)
    assert chk.returncode == 0, chk.stderr


def test_failed_job_keeps_the_service_up_and_warms_nothing(sim, tmp_path):
    in_path, ref_bytes = sim
    spool = str(tmp_path / "spool")
    bad = client.submit(spool, __file__, str(tmp_path / "bad.bam"), config=dict(CONFIG))
    (good, out), = _submit_n(spool, in_path, tmp_path, 1)
    svc = _service(spool, chunk_budget=0)
    snap = svc.run_until_idle()
    assert snap["jobs_failed"] == 1 and snap["jobs_done"] == 1
    assert client.status(spool, bad)["state"] == "failed"
    assert _read(out) == ref_bytes
    assert svc.worker.n_spec_hits == 0 and svc.worker.n_spec_misses == 2


def test_drain_yields_at_a_chunk_boundary_and_a_restart_resumes(sim, tmp_path):
    """The SIGTERM path, in process (what the daemon's handler calls):
    a drain requested mid-job yields at the next chunk boundary with
    reason "drain", the job is queued again, and a restarted service
    resumes its checkpoint to the one-shot bytes in a second slice."""
    in_path, ref_bytes = sim
    spool = str(tmp_path / "spool")
    (jid, out), = _submit_n(spool, in_path, tmp_path, 1)
    trace = str(tmp_path / "svc1.jsonl")
    svc = _service(spool, chunk_budget=1, trace_path=trace)
    orig = svc.worker.run_slice

    def run_slice_then_drain(spec, budget, should_yield, drain_event, lease=None):
        def drain_not_yield():
            svc.request_drain()
            return False

        return orig(spec, budget, drain_not_yield, drain_event, lease=lease)

    svc.worker.run_slice = run_slice_then_drain
    snap = svc.run()
    assert snap["preemptions"] == 1 and snap["jobs_done"] == 0
    pre = [e for e in _events(trace)[1] if e["name"] == "job_preempted"]
    assert len(pre) == 1 and pre[0]["reason"] == "drain" and pre[0]["chunks_done"] >= 1
    assert SpoolQueue(spool).jobs[jid]["state"] == "queued"
    assert _service(spool).run_until_idle()["jobs_done"] == 1
    assert _read(out) == ref_bytes
    assert SpoolQueue(spool).jobs[jid]["slices"] == 2


def _wait_for(pred, timeout_s, what, proc=None):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return
        if proc is not None and proc.poll() is not None:
            raise AssertionError(f"daemon exited before {what}: {proc.communicate()[1]}")
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


def test_sigkill_takeover_by_a_second_daemon(sim, tmp_path):
    """Daemon A (a subprocess on the CPU) claims the job and is
    SIGKILLed mid-slice; daemon B --once takes the lease over at once
    (A's pid is provably dead) and finishes byte-identical, token 2,
    building its libraries in its --build-dir; serve_report reads one
    takeover and no fenced slice."""
    in_path, ref_bytes = sim
    spool = str(tmp_path / "spool")
    (jid, out), = _submit_n(spool, in_path, tmp_path, 1)
    a = subprocess.Popen(DAEMON + [spool, "--device", "cpu", "--poll", "0.05", "--heartbeat",
                                   "0.2", "--lease", "30", "--daemon-id", "tk-A"],
                         env=ENV, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True)
    try:
        _wait_for(lambda: client.status(spool, jid).get("state") == "running"
                  and client.status(spool, jid).get("lease"), 120, "the claim", a)
        a.send_signal(signal.SIGKILL)
        a.communicate(timeout=30)
    finally:
        if a.poll() is None:
            a.kill()
            a.communicate(timeout=30)
    st = client.status(spool, jid)
    assert st["state"] == "running" and st["lease"]["owner"] == "tk-A"
    build = str(tmp_path / "build")
    b = subprocess.run(DAEMON + [spool, "--device", "cpu", "--once", "--poll", "0.05",
                                 "--heartbeat", "0", "--daemon-id", "tk-B", "--build-dir",
                                 build],
                       env={k: v for k, v in ENV.items() if k != "DUT_BUILD_DIR"}, cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert b.returncode == 0, b.stderr
    assert "device=cpu" in b.stderr
    st = client.status(spool, jid)
    assert st["state"] == "done" and st["token"] >= 2
    assert _read(out) == ref_bytes
    assert any(n.startswith("libdutbam-") and n.endswith(".so") for n in os.listdir(build))
    trace = os.path.join(spool, "service.tk-B.trace.jsonl")
    recs, ev = _events(trace)
    assert trace_report.validate_service_trace(recs) == []
    tk = [e for e in ev if e["name"] == "lease_takeover"]
    assert len(tk) == 1 and tk[0]["reason"] == "dead-owner" and tk[0]["prev_owner"] == "tk-A"
    r = subprocess.run([sys.executable, "-m",
                        "duplexumiconsensusreads_torch.tools.serve_report", trace, "--json"],
                       capture_output=True, text=True, timeout=120, env=ENV)
    assert r.returncode == 0, r.stderr
    rep = json.loads(r.stdout)
    assert rep["n_takeovers"] == 1 and rep["n_fenced"] == 0 and rep["n_done"] == 1


def test_deadline_expires_and_wait_exits_1(sim, tmp_path, capsys):
    in_path, ref_bytes = sim
    spool = str(tmp_path / "spool")
    (jid_a, out_a), = _submit_n(spool, in_path, tmp_path, 1, prefix="a")
    jid_b = client.submit(spool, in_path, str(tmp_path / "b.bam"), config=dict(CONFIG),
                          deadline_s=0.001)
    snap = _service(spool, chunk_budget=0).run_until_idle()
    assert snap["jobs_done"] == 1 and snap["jobs_expired"] == 1
    st = client.status(spool, jid_b)
    assert st["state"] == "expired" and "before the job could run" in st["error"]
    assert not os.path.exists(str(tmp_path / "b.bam"))
    assert _read(out_a) == ref_bytes
    for fn in (cli_main, jax_main):
        assert fn(["call", "--wait", jid_b, "--spool", spool, "--wait-timeout", "5"]) == 1
        err = capsys.readouterr().err
        assert "expired" in err and "deadline passed" in err


def test_poison_job_is_quarantined_after_max_crashes(sim, tmp_path, capsys):
    in_path, ref_bytes = sim
    spool = str(tmp_path / "spool")
    poison = client.submit(spool, in_path, str(tmp_path / "p.bam"), config=dict(CONFIG),
                           chaos="shard.write:1:kill")
    (healthy, out), = _submit_n(spool, in_path, tmp_path, 1, prefix="h")
    deaths = 0
    for i in range(6):
        svc = _service(spool, chunk_budget=0, max_crashes=2, daemon_id=f"pd-{i}")
        try:
            snap = svc.run_until_idle()
            break
        except faults.InjectedKill:
            deaths += 1
    else:
        pytest.fail("the service never got past the poison job")
    assert deaths == 2 and snap["jobs_quarantined"] == 1 and snap["jobs_done"] == 1
    st = client.status(spool, poison)
    assert st["state"] == "quarantined" and "quarantined after 2 crashed runs" in st["error"]
    diag = st["result"]["diagnosis"]
    assert diag["crash_count"] == 2 and [h["owner"] for h in diag["lease_history"]] == [
        "pd-0", "pd-1"]
    assert _read(out) == ref_bytes
    for fn in (cli_main, jax_main):
        assert fn(["call", "--status", poison, "--spool", spool]) == 1
        assert "quarantined" in capsys.readouterr().err


def test_class_depth_sheds_with_the_jax_exit_code(sim, tmp_path, capsys):
    in_path, ref_bytes = sim
    spool = str(tmp_path / "spool")
    trace = str(tmp_path / "svc.jsonl")
    jobs = _submit_n(spool, in_path, tmp_path, 3)
    snap = _service(spool, chunk_budget=0, trace_path=trace,
                    class_depths={1: 1}).run_until_idle()
    assert snap["jobs_done"] == 1 and snap["jobs_shed"] == 2 and snap["jobs_rejected"] == 0
    states = {jid: client.status(spool, jid) for jid, _ in jobs}
    shed = [j for j, st in states.items() if st.get("shed")]
    assert len(shed) == 2
    assert all(states[j]["error"].startswith("shed: priority class 1") for j in shed)
    done = [j for j, st in states.items() if st["state"] == "done"]
    assert _read(dict(jobs)[done[0]]) == ref_bytes
    _, ev = _events(trace)
    assert len([e for e in ev if e["name"] == "job_shed"]) == 2
    for fn in (cli_main, jax_main):
        assert fn(["call", "--status", shed[0], "--spool", spool]) == 1
        cap = capsys.readouterr()
        assert json.loads(cap.out)["shed"] is True
        assert "shed by admission control" in cap.err


# ---- the CLI verbs: the JAX CLI's exit codes and words

@pytest.mark.parametrize("argv", [
    ["call", "--status", "job-nope", "--spool", "SPOOL"],
    ["call", "--status", "job-nope", "--spool", "SPOOL", "--json"],
    ["call", "--wait", "job-nope", "--spool", "SPOOL", "--wait-timeout", "1"],
    ["call", "--wait", "SUBMITTED", "--spool", "SPOOL", "--wait-timeout", "0.2"],
    ["call", "--wait", "SUBMITTED", "--spool", "SPOOL", "--wait-timeout", "0.2", "--json"],
    ["call", "--status", "SUBMITTED", "--spool", "SPOOL"],
    ["call", "--status", "DONE", "--spool", "SPOOL", "--json"],
    ["call", "--wait", "DONE", "--spool", "SPOOL"],
], ids=lambda a: " ".join(a[1:3] + a[5:]))
def test_client_verbs_exit_like_jax(sim, tmp_path_factory, capsys, argv):
    in_path, _ = sim
    d = tmp_path_factory.mktemp("verbs")
    spool = str(d / "spool")
    sub = client.submit(spool, in_path, str(d / "s.bam"), config=dict(CONFIG))
    done = client.submit(spool, in_path, str(d / "d.bam"), config=dict(CONFIG))
    q = SpoolQueue(spool)
    q.accept_one(done)
    token = q.claim(done, "d-X", 30.0)
    q.mark_done(done, {"n_consensus": 1}, "d-X", token)
    argv = [{"SPOOL": spool, "SUBMITTED": sub, "DONE": done}.get(a, a) for a in argv]
    results = []
    for fn in (cli_main, jax_main):
        rc = fn(list(argv))
        cap = capsys.readouterr()
        out = json.loads(cap.out)
        results.append((rc, out.get("state"), out.get("timed_out"),
                        cap.err.replace("duplexumi-torch", "duplexumi")))
    assert results[0][:3] == results[1][:3]
    assert results[0][3] == results[1][3]


@pytest.mark.parametrize("argv, word", [
    (["call", "--status", "job-x"], "spool"),
    (["call"], "INPUT"),
    (["call", "--status", "a", "--wait", "b", "--spool", "s"], "mutually exclusive"),
    (["call", "IN", "-o", "OUT", "--json"], "--json applies"),
    (["call", "IN", "-o", "OUT", "--submit", "--spool", "S", "--chunk-reads", "0"],
     "chunk-reads"),
    (["call", "IN", "-o", "OUT", "--submit", "--spool", "S", "--ref-projected"],
     "whole-file"),
    (["call", "IN", "-o", "OUT", "--submit", "--spool", "S", "--report", "r.json"],
     "service"),
    (["call", "IN", "-o", "OUT", "--submit", "--spool", "S", "--devices", "1"],
     "daemon-side"),
    (["call", "IN", "-o", "OUT", "--submit", "--spool", "S", "--priority", "-1"],
     "--priority"),
    (["call", "IN", "-o", "OUT", "--submit", "--spool", "S", "--shards", "2",
      "--shard-bytes", "5"], "mutually exclusive"),
    (["call", "IN", "-o", "OUT", "--chunk-reads", "90", "--deadline", "10"], "--deadline"),
    (["call", "IN", "-o", "OUT", "--chunk-reads", "90", "--shards", "2"], "--shards"),
    (["call", "IN", "-o", "OUT", "--chunk-reads", "90", "--follow", "--finalize-on", "x"],
     "--finalize-on"),
    (["call", "IN", "-o", "OUT", "--chunk-reads", "90", "--follow", "--live-poll-s", "0"],
     "--live-poll-s"),
    (["call", "IN", "-o", "OUT", "--chunk-reads", "90", "--snapshot-chunks", "-1"],
     "--snapshot-chunks"),
], ids=lambda v: " ".join(v[1:]) if isinstance(v, list) else v)
def test_usage_errors_use_the_jax_words(sim, tmp_path, monkeypatch, argv, word):
    in_path, _ = sim
    monkeypatch.delenv("DUT_SPOOL", raising=False)
    argv = [{"IN": in_path, "OUT": str(tmp_path / "o.bam"),
             "S": str(tmp_path / "s")}.get(a, a) for a in argv]
    msgs = []
    for fn in (cli_main, jax_main):
        with pytest.raises(SystemExit) as e:
            fn(list(argv))
        msgs.append(str(e.value))
    assert word in msgs[0]
    assert msgs[0] == msgs[1].replace("dut-serve", "serve.daemon")


def test_submit_refuses_a_device_and_names_the_daemon_flag(sim, tmp_path):
    in_path, _ = sim
    with pytest.raises(SystemExit, match="serve.daemon --device"):
        cli_main(["call", in_path, "-o", str(tmp_path / "o.bam"), "--submit", "--spool",
                  str(tmp_path / "s"), "--chunk-reads", "90", "--device", "cpu"])
    assert not os.path.exists(tmp_path / "s" / "inbox") or not os.listdir(
        tmp_path / "s" / "inbox")


def test_client_verbs_never_touch_cuda_or_the_executor(sim, tmp_path):
    """call --submit, --status and --wait with no visible card: they
    answer, and neither the executor stack nor CUDA was initialised."""
    in_path, _ = sim
    spool = str(tmp_path / "spool")
    code = (
        "import sys, io, contextlib, torch\n"
        "from duplexumiconsensusreads_torch.cli.main import main\n"
        "buf = io.StringIO()\n"
        "with contextlib.redirect_stdout(buf):\n"
        f"    assert main(['call', {in_path!r}, '-o', {str(tmp_path / 'o.bam')!r}, "
        f"'--submit', '--spool', {spool!r}, '--chunk-reads', '90']) == 0\n"
        "jid = buf.getvalue().strip()\n"
        f"assert main(['call', '--status', jid, '--spool', {spool!r}]) == 0\n"
        f"assert main(['call', '--wait', jid, '--spool', {spool!r}, '--wait-timeout', "
        "'0.1']) == 3\n"
        "bad = [m for m in sys.modules if m.startswith(("
        "'duplexumiconsensusreads_torch.runtime.stream', "
        "'duplexumiconsensusreads_torch.runtime.executor', "
        "'duplexumiconsensusreads_torch.ops', 'duplexumiconsensusreads_torch.kernels', "
        "'jax', 'duplexumiconsensusreads_tpu'))]\n"
        "assert not bad, bad\n"
        "assert not torch.cuda.is_initialized()\n"
        "print('clean')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=120, env=dict(ENV, CUDA_VISIBLE_DEVICES=""))
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("clean")


# ---- the device rule and the build directory

def test_service_and_daemon_default_to_cuda_and_raise_without_a_card(tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ConsensusService(str(tmp_path / "spool"))
    r = subprocess.run(DAEMON + [str(tmp_path / "spool2"), "--once"], env=dict(
        ENV, CUDA_VISIBLE_DEVICES=""), cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and "no CUDA device" in r.stderr


@pytest.mark.parametrize("devices, refusal", [
    ("0,1", None), ("2", None), ("1,2,3", None), ("1", None), ("0", "one-element list"),
    ("x", "comma-separated"), ("9", "requested 9 devices, have 8"), ("0,8", "out of range"),
])
def test_daemon_devices_pin_one_card_and_refuse_more(tmp_path, devices, refusal):
    """--devices takes the JAX daemon's count and index-list forms over
    the device pool (here the CPU's logical lanes); a count past the
    pool or an index outside it is refused at start, in the mesh's
    words."""
    from duplexumiconsensusreads_torch.serve import daemon

    argv = [str(tmp_path / "spool"), "--devices", devices, "--device", "cpu", "--once",
            "--no-trace", "--poll", "0.02"]
    if refusal is None:
        assert daemon.main(argv) == 0
        return
    with pytest.raises(SystemExit, match=refusal):
        daemon.main(argv)


def test_parse_devices_matches_jax():
    from duplexumiconsensusreads_tpu.serve.daemon import parse_devices as jax_parse
    from duplexumiconsensusreads_torch.serve.daemon import parse_devices

    for v in (None, "1", "4", "2,", "0,1", " 3 , ", "", "0", "-1,", "1,1", "a"):
        def run(fn):
            try:
                return fn(v)
            except ValueError as e:
                return str(e)
        assert run(parse_devices) == run(jax_parse)


def test_second_process_on_one_build_dir_loads_and_builds_nothing(tmp_path):
    """The compile cache's counterpart: the first process pointed at a
    build directory builds the native loader there, the second loads
    that library and builds nothing."""
    build = str(tmp_path / "build")
    code = (
        "import json\n"
        "from duplexumiconsensusreads_torch import native\n"
        "info = native.build()\n"
        "native.get_lib()\n"
        "print(json.dumps({'path': info['path'], 'seconds': info['seconds']}))\n"
    )
    env = {k: v for k, v in ENV.items() if k != "DUT_NO_NATIVE"}
    runs = []
    for _ in range(2):
        r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                           text=True, timeout=300, env=dict(env, DUT_BUILD_DIR=build))
        assert r.returncode == 0, r.stderr
        runs.append(json.loads(r.stdout.strip().splitlines()[-1]))
    first, second = runs
    assert os.path.dirname(first["path"]) == build == os.path.dirname(second["path"])
    assert first["seconds"] > 0 and second["seconds"] == 0.0
    assert first["path"] == second["path"]
    libs = [n for n in os.listdir(build) if n.endswith(".so")]
    assert libs == [os.path.basename(first["path"])]


def test_enable_compile_cache_points_the_kernel_and_native_builds(tmp_path, monkeypatch):
    from duplexumiconsensusreads_torch import native
    from duplexumiconsensusreads_torch.kernels import build
    from duplexumiconsensusreads_torch.utils.compile_cache import ENV_VAR, enable_compile_cache

    monkeypatch.delenv(ENV_VAR, raising=False)
    assert os.path.dirname(native.lib_path()) == native.BUILD_DIR
    assert os.path.dirname(build.lib_path("segment_gemm")) == build.BUILD_DIR
    monkeypatch.setenv(ENV_VAR, "placeholder")  # restored by monkeypatch
    path = enable_compile_cache(str(tmp_path / "kc"))
    assert os.environ[ENV_VAR] == path and os.path.isdir(path)
    assert os.path.dirname(native.lib_path()) == path
    assert os.path.dirname(build.lib_path("cluster_fixpoint")) == path


def test_spec_signature_matches_jax():
    from duplexumiconsensusreads_tpu.serve.job import spec_signature as jax_sig

    for over in ({}, {"config": {**CONFIG, "capacity": 256}},
                 {"config": {**CONFIG, "bucket_ladder": [64, 128]}},
                 {"config": {**CONFIG, "mesh": 1}}):
        assert spec_signature(validate_spec(_spec(**over))) == jax_sig(jax_validate(
            _spec(**over)))
