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
def test_daemon_devices_pin_one_card_and_refuse_more(sim, tmp_path, devices, refusal):
    """--devices takes the JAX daemon's count and index-list forms over
    the device pool (here the CPU's logical lanes) and runs every job on
    a mesh over them (the daemon no longer owns one card only: a job
    submitted to a two-lane daemon reports two devices); a count past
    the pool or an index outside it is refused at start, in the mesh's
    words."""
    from duplexumiconsensusreads_torch.serve import daemon

    spool = str(tmp_path / "spool")
    argv = [spool, "--devices", devices, "--device", "cpu", "--once",
            "--no-trace", "--poll", "0.02"]
    if refusal is None:
        jid = None
        if devices == "0,1":
            jid = client.submit(spool, sim[0], str(tmp_path / "o.bam"), config=dict(CONFIG))
        assert daemon.main(argv) == 0
        if jid is not None:
            st = client.status(spool, jid)
            assert st["state"] == "done" and st["result"]["n_devices"] == 2
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


# ---- the serve kill matrix: the JAX serving suite's registry, lease,
# crash-recovery, deadline, watchdog, quarantine, disk-pressure and
# sharding-kill classes, on the port (every service on the CPU)

# every fault site the serving layer owns; the port's dutlint
# lease-discipline rule reads this tuple, and test_kill_at_each_serve_site
# drives every one of them
SERVE_SITES = (
    "serve.accept", "serve.journal", "serve.preempt",
    "serve.lease", "serve.renew", "serve.expire", "serve.fence",
    "serve.hb", "serve.store",
    "serve.deadline", "serve.watchdog",
    "serve.split", "serve.merge",
)


def test_serve_sites_registered():
    """The serving layer's site registry pin: KNOWN_SITES (the port's and
    the JAX package's) and this suite agree on the sites serve/ owns."""
    from duplexumiconsensusreads_tpu.runtime import faults as jax_faults

    assert set(SERVE_SITES) == {s for s in faults.KNOWN_SITES if s.startswith("serve.")}
    assert set(SERVE_SITES) == {s for s in jax_faults.KNOWN_SITES if s.startswith("serve.")}


def test_one_shot_reference_matches_jax_at_the_parity_bar(sim, tmp_path):
    """The bytes every service output here must equal: the port's
    one-shot run with the serve provenance line, held record by record
    against the JAX package's run of the same job (file bytes are not
    compared across engines: the deflate codecs differ)."""
    import numpy as np

    from duplexumiconsensusreads_tpu.io import read_bam as jax_read_bam
    from duplexumiconsensusreads_tpu.runtime.stream import stream_call_consensus as jax_stream
    from duplexumiconsensusreads_tpu.serve.job import job_params as jax_job_params
    from duplexumiconsensusreads_torch.constants import BASE_N, NO_CALL_QUAL
    from duplexumiconsensusreads_torch.io import read_bam

    in_path, ref_bytes = sim
    ref, jout = str(tmp_path / "ref.bam"), str(tmp_path / "j.bam")
    with open(ref, "wb") as f:
        f.write(ref_bytes)
    spec = jax_validate({"job_id": "ref", "input": in_path, "output": jout, "config": CONFIG})
    gp, cp, kw = jax_job_params(spec)
    kw.pop("mesh", None)
    jax_stream(in_path, jout, gp, cp, n_devices=1, provenance_cl=serve_provenance(CONFIG), **kw)
    (th, a), (jh, b) = read_bam(ref), jax_read_bam(jout)
    # the @PG line names each package; the rest of the header is equal
    assert th.text.replace("duplexumiconsensusreads_torch", "duplexumiconsensusreads_tpu") == jh.text
    assert len(a) == len(b) > 0
    for f in ("names", "flags", "pos", "lengths", "tlen"):
        np.testing.assert_array_equal(np.asarray(getattr(a, f)), np.asarray(getattr(b, f)))
    assert list(a.aux_raw) == list(b.aux_raw)
    sa, sb = np.asarray(a.seq), np.asarray(b.seq)
    qa, qb = np.asarray(a.qual).astype(int), np.asarray(b.qual).astype(int)
    tie = ((sa == BASE_N) | (sb == BASE_N)) & (qa == NO_CALL_QUAL) & (qb == NO_CALL_QUAL)
    assert not ((sa != sb) & ~tie).any() and np.abs(qa - qb).max() <= 2


class TestStateRegistry:
    """serve/states.py is the declared state machine: its derived views,
    a well-formed graph, the queue's re-exports — each equal to the JAX
    package's."""

    def test_derived_views_reproduce_pre_refactor_tuples(self):
        from duplexumiconsensusreads_tpu.serve import states as jax_states
        from duplexumiconsensusreads_torch.serve import states

        assert states.JOB_STATES == (
            "queued", "running", "done", "failed", "rejected",
            "expired", "quarantined", "splitting", "fanned", "merging",
        )
        assert states.CLAIMED_STATES == ("running", "splitting", "merging")
        assert states.OPEN_STATES == ("queued", "fanned", "running", "splitting", "merging")
        assert states.TERMINAL_STATES == ("done", "failed", "rejected", "expired", "quarantined")
        assert states.INITIAL_STATES == ("queued", "rejected")
        for name in ("JOB_STATES", "CLAIMED_STATES", "OPEN_STATES", "TERMINAL_STATES",
                     "INITIAL_STATES", "TRANSITIONS"):
            assert getattr(states, name) == getattr(jax_states, name), name

    def test_transition_graph_is_well_formed(self):
        from duplexumiconsensusreads_torch.serve.states import (
            INITIAL_STATES,
            JOB_STATES,
            TERMINAL_STATES,
            TRANSITIONS,
        )

        assert set(TRANSITIONS) == set(JOB_STATES)
        for src, succs in sorted(TRANSITIONS.items()):
            for dst in succs:
                assert dst in JOB_STATES, f"{src}->{dst}"
            if src in TERMINAL_STATES:
                assert succs == (), src
        seen = set(INITIAL_STATES)
        frontier = list(INITIAL_STATES)
        while frontier:
            for dst in TRANSITIONS[frontier.pop()]:
                if dst not in seen:
                    seen.add(dst)
                    frontier.append(dst)
        assert seen == set(JOB_STATES)

    def test_queue_re_exports_the_registry(self):
        from duplexumiconsensusreads_torch.serve import queue, states

        assert queue.JOB_STATES is states.JOB_STATES
        assert queue.CLAIMED_STATES is states.CLAIMED_STATES
        assert queue.OPEN_STATES is states.OPEN_STATES
        assert queue.TERMINAL_STATES is states.TERMINAL_STATES
        assert queue.TRANSITIONS is states.TRANSITIONS
        assert client.TERMINAL_STATES == states.TERMINAL_STATES + ("unknown",)


# ---- every declared transition, driven on the bare queue of both
# packages: each case puts a job into the edge's source state through
# the queue's own API, then makes the move

def _pkg(name):
    import types

    if name == "jax":
        from duplexumiconsensusreads_tpu.serve import client as c
        return types.SimpleNamespace(Q=JaxQueue, submit=c.submit, validate=jax_validate)
    return types.SimpleNamespace(Q=SpoolQueue, submit=client.submit, validate=validate_spec)


def _children(parent="job-p", k=2):
    return [
        {"job_id": f"{parent}.s{i:03d}", "input": "/i.bam", "output": f"/o.bam.shard{i:03d}.bam",
         "config": dict(CONFIG),
         "shard": {"parent": parent, "idx": i, "k": k, "chunk_base": i, "n_chunks": 1,
                   "key_lo": None, "key_hi": None, "start": None, "first_read": None}}
        for i in range(k)
    ]


def _queued(ns, root, **qkw):
    q = ns.Q(root, **qkw)
    jid = ns.submit(root, __file__, os.path.join(root, "job.bam"), config=dict(CONFIG))
    assert q.accept_one(jid)[0] is not None
    return q, jid


def _running(ns, root, **qkw):
    q, jid = _queued(ns, root, **qkw)
    return q, jid, q.claim(jid, "d1", 60.0)


def _parent(ns, root, **qkw):
    q = ns.Q(root, **qkw)
    q.submit(ns.validate(_spec(job_id="job-p", shards=2)))
    assert q.accept_one("job-p")[1] is None
    return q, "job-p"


def _splitting(ns, root, **qkw):
    q, p = _parent(ns, root, **qkw)
    return q, p, q.claim(p, "d1")


def _fanned(ns, root, **qkw):
    q, p, tok = _splitting(ns, root, **qkw)
    assert q.register_shards(p, "d1", tok, _children()) == 2
    return q, p


def _children_done(q, p):
    for cid in q.jobs[p]["children"]:
        t = q.claim(cid, "d1")
        q.mark_done(cid, {"n_consensus": 1}, "d1", t)


def _merging(ns, root, **qkw):
    q, p = _merge_queued(ns, root, **qkw)
    return q, p, q.claim(p, "d2")


def _dead(q):
    return q.reclaim_dead("d9", is_live=lambda d: False)


def _overdue(q, jid):
    with q._txn():
        q.jobs[jid]["deadline_m"] = round(time.monotonic() - 1, 3)
        q.save()
    return q.expire_deadlines()


def _failed_sibling(ns, root):
    q, p = _fanned(ns, root)
    t = q.claim("job-p.s000", "d1")
    q.mark_failed("job-p.s000", "boom: not a BAM", "d1", t)
    return q, "job-p.s001", lambda: q.advance_parents()


def _failed_parent(ns, root):
    q, _, move = _failed_sibling(ns, root)
    return q, "job-p", move


def _merge_queued(ns, root, **qkw):
    # every child done and the parent sweep run: the parent is queued
    # for its merge
    q, p = _fanned(ns, root, **qkw)
    _children_done(q, p)
    q.advance_parents()
    return q, p


def _with_deadline(ns, root):
    q = ns.Q(root)
    jid = ns.submit(root, __file__, os.path.join(root, "job.bam"), config=dict(CONFIG),
                    deadline_s=60.0)
    q.accept_one(jid)
    return q, jid, lambda: _overdue(q, jid)


def _edge(setup, move):
    """A case from a setup returning (q, job, token?) and a move
    taking (q, job, token)."""
    def drive(ns, root):
        q, jid, *tok = setup(ns, root)
        return q, jid, lambda: move(q, jid, *tok)
    return drive


def _q1(setup):
    # a queue that quarantines on the first unclean abort
    return lambda ns, root: setup(ns, root, max_crashes=1)


EDGES = {
    "queued->running": _edge(_queued, lambda q, j: q.claim(j, "d1", 60.0)),
    "queued->splitting": _edge(_parent, lambda q, j: q.claim(j, "d1")),
    "queued->merging": _edge(_merge_queued, lambda q, p: q.claim(p, "d2")),
    "queued->expired": _with_deadline,
    "queued->failed": _failed_sibling,
    "running->done": _edge(_running, lambda q, j, t: q.mark_done(j, {"ok": 1}, "d1", t)),
    "running->failed": _edge(_running, lambda q, j, t: q.mark_failed(j, "boom", "d1", t)),
    "running->queued": _edge(_running, lambda q, j, t: q.requeue(j, 1, back=True,
                                                                 daemon_id="d1", token=t)),
    "running->expired": _edge(_running, lambda q, j, t: q.mark_expired(
        j, "expired: deadline passed", "d1", t)),
    "running->quarantined": _edge(_q1(_running), lambda q, j, t: _dead(q)),
    "splitting->fanned": _edge(_splitting, lambda q, p, t: q.register_shards(
        p, "d1", t, _children())),
    "splitting->failed": _edge(_splitting, lambda q, p, t: q.mark_failed(
        p, "plan failed", "d1", t)),
    "splitting->queued": _edge(_splitting, lambda q, p, t: _dead(q)),
    "splitting->quarantined": _edge(_q1(_splitting), lambda q, p, t: _dead(q)),
    "fanned->queued": _edge(_fanned, lambda q, p: (_children_done(q, p), q.advance_parents())),
    "fanned->failed": _failed_parent,
    "merging->done": _edge(_merging, lambda q, p, t: q.mark_done(p, {"ok": 2}, "d2", t)),
    "merging->failed": _edge(_merging, lambda q, p, t: q.mark_failed(p, "merge failed", "d2", t)),
    "merging->queued": _edge(_merging, lambda q, p, t: _dead(q)),
    "merging->quarantined": _edge(_q1(_merging), lambda q, p, t: _dead(q)),
}


def test_edge_cases_cover_the_declared_graph():
    from duplexumiconsensusreads_torch.serve.states import TRANSITIONS

    assert set(EDGES) == {f"{s}->{d}" for s, ds in TRANSITIONS.items() for d in ds}


@pytest.mark.parametrize("edge", sorted(EDGES))
def test_each_declared_transition_is_driven_as_in_jax(edge, tmp_path, monkeypatch):
    """Each declared edge, made by the queue's own API on the port's
    queue and on the JAX package's: the job sits in the edge's source
    state before the move and in its destination after, and the two
    journals agree (clock stamps, pids and hosts aside)."""
    src, dst = edge.split("->")
    monkeypatch.setattr(os, "urandom", lambda n: b"\x02" * n)
    entries = []
    for name in ("torch", "jax"):
        root = str(tmp_path / name)
        q, jid, move = EDGES[edge](_pkg(name), root)
        assert q.jobs[jid]["state"] == src, name
        move()
        assert q.jobs[jid]["state"] == dst, name
        # durable: a fresh queue over the spool reads the same state
        fresh = (SpoolQueue if name == "torch" else JaxQueue)(root)
        assert fresh.jobs[jid]["state"] == dst
        entries.append(_journal_view(fresh.jobs, root))
    assert entries[0] == entries[1]


def _journal_view(jobs, root):
    """A journal's entries in admission order, without what names the
    spool, the clock or the process (paths, random job ids, stamps and
    elapsed seconds in messages)."""
    import re

    view = []
    for _, e in sorted(jobs.items(), key=lambda kv: (kv[1].get("seq", 0), kv[0])):
        e = dict(json.loads(re.sub(r"\d+\.\d+s", "Xs", json.dumps(e).replace(root, "ROOT"))))
        e.pop("spec", None)
        view.append(_normalize(e))
    return view


def test_rejected_is_journaled_with_its_reason_as_in_jax(tmp_path):
    """The other initial state: a submission the queue refuses is
    journaled terminal ``rejected`` with the reason, on both queues."""
    out = []
    for name in ("torch", "jax"):
        ns = _pkg(name)
        root = str(tmp_path / name)
        q = ns.Q(root, max_queue=1)
        ids = [ns.submit(root, __file__, os.path.join(root, f"j{i}.bam"), config=dict(CONFIG))
               for i in range(2)]
        q.accept_one(ids[0])
        spec, reason = q.accept_one(ids[1])
        assert spec is None and reason
        st = q.status(ids[1])
        assert st["state"] == "rejected"
        out.append((reason.split(":")[0], st["state"], st.get("shed")))
    assert out[0] == out[1]


class TestLeaseProtocol:
    """The lease/claim state machine on the bare queue: claims bump the
    fencing token, renewal is fenced, expired and dead-owner leases
    reclaim, and every verdict is durable."""

    def _queued(self, tmp_path):
        return _queued(_pkg("torch"), str(tmp_path))

    def test_claim_bumps_token_and_is_exclusive(self, tmp_path):
        q, jid = self._queued(tmp_path)
        assert q.claim(jid, "d1", lease_s=60.0) == 1
        e = q.jobs[jid]
        assert e["state"] == "running" and e["lease"]["owner"] == "d1"
        assert e["lease"]["pid"] == os.getpid()
        assert q.claim(jid, "d2", lease_s=60.0) is None
        assert q.claim(jid, "d1", lease_s=60.0) is None
        assert SpoolQueue(str(tmp_path)).jobs[jid]["lease"]["owner"] == "d1"

    def test_verify_and_renew_are_fenced(self, tmp_path):
        from duplexumiconsensusreads_torch.serve.queue import JobFenced

        q, jid = self._queued(tmp_path)
        token = q.claim(jid, "d1", lease_s=60.0)
        q.verify_lease(jid, "d1", token)
        before = q.jobs[jid]["lease"]["expires_m"]
        q.renew_lease(jid, "d1", token, lease_s=120.0)
        assert q.jobs[jid]["lease"]["expires_m"] > before
        for daemon, tok in (("d2", token), ("d1", token + 1), ("d1", 0)):
            with pytest.raises(JobFenced):
                q.verify_lease(jid, daemon, tok)
            with pytest.raises(JobFenced):
                q.renew_lease(jid, daemon, tok)

    def test_expired_lease_reclaims_and_next_claim_fences_zombie(self, tmp_path):
        from duplexumiconsensusreads_torch.serve.queue import JobFenced

        q, jid = self._queued(tmp_path)
        token = q.claim(jid, "d1", lease_s=0.05)
        time.sleep(0.08)
        rec = q.reclaim_dead("d2")
        assert [r["job_id"] for r in rec] == [jid]
        assert rec[0]["reason"] == "expired" and rec[0]["prev_owner"] == "d1"
        assert q.jobs[jid]["state"] == "queued" and "lease" not in q.jobs[jid]
        assert q.claim(jid, "d2", lease_s=60.0) == token + 1
        with pytest.raises(JobFenced):
            q.verify_lease(jid, "d1", token)
        with pytest.raises(JobFenced):
            q.requeue(jid, 1, back=False, daemon_id="d1", token=token)
        with pytest.raises(JobFenced):
            q.mark_done(jid, {"n": 1}, daemon_id="d1", token=token)
        assert q.jobs[jid]["state"] == "running"
        assert q.jobs[jid]["lease"]["owner"] == "d2"

    def test_live_lease_is_not_reclaimed(self, tmp_path):
        q, jid = self._queued(tmp_path)
        q.claim(jid, "d1", lease_s=60.0)
        assert q.reclaim_dead("d2") == []
        assert q.reclaim_dead("d2", is_live=lambda d: d == "d1") == []
        rec = q.reclaim_dead("d2", is_live=lambda d: False)
        assert rec and rec[0]["reason"] == "dead-owner"

    def test_dead_pid_lease_is_reclaimed_immediately(self, tmp_path):
        q, jid = self._queued(tmp_path)
        q.claim(jid, "d1", lease_s=3600.0)
        child = subprocess.Popen([sys.executable, "-c", "pass"])
        child.wait()
        with q._txn():
            q.jobs[jid]["lease"]["pid"] = child.pid
            q.save()
        rec = q.reclaim_dead("d2")
        assert rec and rec[0]["reason"] == "dead-owner"
        assert q.jobs[jid]["state"] == "queued"

    def test_legacy_running_entry_without_lease_is_reclaimed(self, tmp_path):
        q, jid = self._queued(tmp_path)
        with q._txn():
            q.jobs[jid]["state"] = "running"
            q.save()
        rec = q.reclaim_dead("d1")
        assert rec and rec[0]["reason"] == "no-lease"
        assert q.jobs[jid]["state"] == "queued"

    def test_done_requeue_and_fail_release_the_lease(self, tmp_path):
        q, jid = self._queued(tmp_path)
        token = q.claim(jid, "d1", lease_s=60.0)
        q.requeue(jid, 2, back=True, daemon_id="d1", token=token)
        e = q.jobs[jid]
        assert e["state"] == "queued" and "lease" not in e and e["token"] == token
        token2 = q.claim(jid, "d1", lease_s=60.0)
        assert token2 == token + 1
        q.mark_done(jid, {"ok": 1}, daemon_id="d1", token=token2)
        e = q.jobs[jid]
        assert e["state"] == "done" and "lease" not in e


def _completed(*traces):
    return [e["job"] for t in traces for e in _events(t)[1] if e["name"] == "job_completed"]


class TestCrashRecovery:
    def test_kill_between_accept_and_dispatch_runs_exactly_once(self, sim, tmp_path):
        """A kill at the lease claim lands after the job is durably
        accepted and before any work: the journal still says queued, and
        a restarted service runs it exactly once."""
        in_path, ref_bytes = sim
        spool = str(tmp_path / "spool")
        (jid, out), = _submit_n(spool, in_path, tmp_path, 1)
        faults.install(faults.FaultPlan.parse("serve.lease:1:kill"))
        t1 = str(tmp_path / "svc1.jsonl")
        with pytest.raises(faults.InjectedKill):
            _service(spool, trace_path=t1).run_until_idle()
        assert SpoolQueue(spool).jobs[jid]["state"] == "queued"
        assert not os.path.exists(out)
        assert [e for e in _events(t1)[1] if e["name"] == "job_started"] == []
        faults.uninstall()
        t2 = str(tmp_path / "svc2.jsonl")
        assert _service(spool, trace_path=t2).run_until_idle()["jobs_done"] == 1
        assert _read(out) == ref_bytes
        ev2 = _events(t2)[1]
        assert len([e for e in ev2 if e["name"] == "job_started"]) == 1
        assert _completed(t2) == [jid]

    def test_kill_before_admission_loses_no_submission(self, sim, tmp_path):
        in_path, ref_bytes = sim
        spool = str(tmp_path / "spool")
        (jid, out), = _submit_n(spool, in_path, tmp_path, 1)
        faults.install(faults.FaultPlan.parse("serve.accept:1:kill"))
        with pytest.raises(faults.InjectedKill):
            _service(spool).run_until_idle()
        faults.uninstall()
        assert os.path.exists(os.path.join(spool, "inbox", jid + ".json"))
        snap = _service(spool).run_until_idle()
        assert snap["jobs_done"] == 1 and snap["jobs_accepted"] == 1
        assert _read(out) == ref_bytes

    def test_kill_mid_job_resumes_from_checkpoint(self, sim, tmp_path):
        """A kill inside a running slice leaves the job running under the
        dead daemon's lease; the next service takes it over (token 2)
        and converges to the one-shot bytes."""
        in_path, ref_bytes = sim
        spool = str(tmp_path / "spool")
        (jid, out), = _submit_n(spool, in_path, tmp_path, 1)
        faults.install(faults.FaultPlan.parse("shard.write:3:kill"))
        with pytest.raises(faults.InjectedKill):
            _service(spool, daemon_id="victim").run_until_idle()
        faults.uninstall()
        entry = SpoolQueue(spool).jobs[jid]
        assert entry["state"] == "running"
        assert entry["lease"]["owner"] == "victim" and entry["token"] == 1
        t2 = str(tmp_path / "svc2.jsonl")
        snap = _service(spool, trace_path=t2).run_until_idle()
        assert snap["jobs_done"] == 1 and snap["jobs_recovered"] == 1
        assert _read(out) == ref_bytes
        entry = SpoolQueue(spool).jobs[jid]
        assert entry["token"] == 2 and "lease" not in entry and entry["slices"] == 2
        ev2 = _events(t2)[1]
        tk = [e for e in ev2 if e["name"] == "lease_takeover"]
        assert len(tk) == 1 and tk[0]["job"] == jid and tk[0]["reason"] == "dead-owner"
        assert any(e["name"] == "resume" and e.get("decision") == "requeued_running"
                   for e in ev2)


# a kill at each serve site, nth as in the JAX fleet matrix where it has
# one: where the daemon dies, a successor finishes both jobs (one of
# them sharded, so the split and merge sites are on the path) exactly
# once and byte-identical
SERVE_KILLS = [
    ("serve.accept", 1), ("serve.journal", 2), ("serve.preempt", 1),
    ("serve.lease", 1), ("serve.renew", 1), ("serve.expire", 1), ("serve.fence", 2),
    ("serve.hb", 1), ("serve.store", 1), ("serve.deadline", 1), ("serve.watchdog", 1),
    ("serve.split", 1), ("serve.merge", 1),
]


def test_kill_matrix_covers_every_serve_site():
    assert sorted(s for s, _ in SERVE_KILLS) == sorted(SERVE_SITES)


@pytest.mark.parametrize("site,nth", SERVE_KILLS)
def test_kill_at_each_serve_site_then_restart_exactly_once(site, nth, sim, tmp_path):
    in_path, ref_bytes = sim
    spool = str(tmp_path / "spool")
    plain = client.submit(spool, in_path, str(tmp_path / "a.bam"), config=dict(CONFIG))
    sharded = client.submit(spool, in_path, str(tmp_path / "b.bam"), config=dict(CONFIG),
                            shards=2)
    svc = _service(spool, chunk_budget=1, heartbeat_s=0.05, watchdog_s=30.0,
                   default_deadline_s=3600.0, daemon_id="kill-A")
    if site == "serve.watchdog":
        # outlive the watchdog's first tick inside the first slice
        orig = svc.worker.run_slice

        def slow_run_slice(spec, budget, should_yield, drain_event, lease=None):
            time.sleep(0.6)
            return orig(spec, budget, should_yield, drain_event, lease=lease)

        svc.worker.run_slice = slow_run_slice
    plan = faults.FaultPlan.parse(f"{site}:{nth}:kill")
    faults.install(plan)
    t1 = str(tmp_path / "svc1.jsonl")
    svc.trace_path = t1
    with pytest.raises(faults.InjectedKill):
        svc.run_until_idle()
    faults.uninstall()
    assert plan.n_fired == 1
    if site == "serve.split":
        assert SpoolQueue(spool).jobs[sharded]["state"] == "splitting"
    t2 = str(tmp_path / "svc2.jsonl")
    snap = _service(spool, trace_path=t2, daemon_id="kill-B").run_until_idle()
    assert snap["jobs_failed"] == 0
    for jid, out in ((plain, "a.bam"), (sharded, "b.bam")):
        assert client.status(spool, jid)["state"] == "done"
        assert _read(str(tmp_path / out)) == ref_bytes
    done = [j for j in _completed(t2) if j in (plain, sharded)]
    assert sorted(done) == sorted(
        j for j in (plain, sharded)
        if j not in [e["job"] for e in _events(t1)[1] if e["name"] == "job_completed"])


def test_a_killed_service_leaves_no_thread_of_its_own(sim, tmp_path):
    """run() re-raises a modelled kill only once the service's own
    threads have ended: a heartbeat beat in flight when the daemon dies
    is waited for, not left running past run() into whatever runs next
    in the process. Here the beat is held until the daemon has died."""
    import threading

    in_path, _ = sim
    spool = str(tmp_path / "spool")
    _submit_n(spool, in_path, tmp_path, 1)
    svc = _service(spool, heartbeat_s=0.05, watchdog_s=30.0, daemon_id="leftover-A")
    beat, in_beat = svc.store.beat, threading.Event()

    def held_beat():
        if threading.current_thread().name == "dut-heartbeat":
            in_beat.set()
            time.sleep(0.5)
        else:
            # the worker's own first beat: claim (and die) only once a
            # heartbeat is in flight
            assert in_beat.wait(timeout=60)
        beat()

    svc.store.beat = held_beat
    before = set(threading.enumerate())
    faults.install(faults.FaultPlan.parse("serve.lease:1:kill"))
    with pytest.raises(faults.InjectedKill):
        svc.run_until_idle()
    assert [t.name for t in set(threading.enumerate()) - before if t.is_alive()] == []


class TestDeadlines:
    def test_deadline_stamped_monotonic_and_swept(self, tmp_path):
        q = SpoolQueue(str(tmp_path))
        jid = client.submit(str(tmp_path), __file__, str(tmp_path / "o.bam"),
                            config=dict(CONFIG), deadline_s=60.0)
        assert q.accept_one(jid)[0] is not None
        e = q.jobs[jid]
        assert e["deadline_m"] == pytest.approx(time.monotonic() + 60.0, abs=2.0)
        assert q.expire_deadlines() == []
        assert FairScheduler.pick(q.jobs, now=e["deadline_m"] + 1) is None
        assert FairScheduler.pick(q.jobs, now=e["deadline_m"] - 1) == jid
        assert FairScheduler.pick(q.jobs) == jid
        exp = _overdue(q, jid)
        assert [r["job_id"] for r in exp] == [jid]
        st = SpoolQueue(str(tmp_path)).status(jid)
        assert st["state"] == "expired" and st["result"]["expired"] is True
        assert "deadline passed" in st["error"]

    def test_daemon_default_deadline_applies_at_admission(self, tmp_path):
        q = SpoolQueue(str(tmp_path), default_deadline_s=30.0)
        jid = client.submit(str(tmp_path), __file__, str(tmp_path / "a.bam"),
                            config=dict(CONFIG))
        q.accept_one(jid)
        assert q.jobs[jid]["deadline_m"] == pytest.approx(time.monotonic() + 30.0, abs=2.0)
        jid2 = client.submit(str(tmp_path), __file__, str(tmp_path / "b.bam"),
                             config=dict(CONFIG), deadline_s=300.0)
        q.accept_one(jid2)
        assert q.jobs[jid2]["deadline_m"] == pytest.approx(time.monotonic() + 300.0, abs=2.0)

    @pytest.mark.parametrize("bad", [0, -1, True, "soon"])
    def test_rejects_bad_deadline(self, bad):
        with pytest.raises(ValueError, match="deadline_s") as terr:
            validate_spec(_spec(deadline_s=bad))
        with pytest.raises(ValueError) as jerr:
            jax_validate(_spec(deadline_s=bad))
        assert str(terr.value) == str(jerr.value)

    def test_overdue_queued_job_expires_before_running(self, sim, tmp_path):
        """Job B's 1 ms deadline lapses while job A holds the worker: the
        sweep journals B expired; it is never claimed or started."""
        in_path, ref_bytes = sim
        spool = str(tmp_path / "spool")
        trace = str(tmp_path / "svc.jsonl")
        (jid_a, out_a), = _submit_n(spool, in_path, tmp_path, 1, prefix="a")
        jid_b = client.submit(spool, in_path, str(tmp_path / "b.bam"), config=dict(CONFIG),
                              deadline_s=0.001)
        snap = _service(spool, chunk_budget=0, trace_path=trace).run_until_idle()
        assert snap["jobs_done"] == 1 and snap["jobs_expired"] == 1
        st = client.status(spool, jid_b)
        assert st["state"] == "expired" and "before the job could run" in st["error"]
        assert st["result"]["expired"] is True
        assert not os.path.exists(str(tmp_path / "b.bam"))
        assert _read(out_a) == ref_bytes
        ev = _events(trace)[1]
        assert [e["job"] for e in ev if e["name"] == "job_expired"] == [jid_b]
        assert all(e["job"] != jid_b for e in ev if e["name"] == "job_started")
        assert client.wait(spool, jid_b, timeout_s=5)["state"] == "expired"

    def test_running_job_aborts_at_chunk_boundary_and_resume_skips(self, sim, tmp_path):
        """A slice whose deadline has passed aborts at its next
        checkpoint boundary; the job is expired with its committed prefix
        preserved, and a re-submission resumes it to the one-shot
        bytes."""
        in_path, ref_bytes = sim
        spool = str(tmp_path / "spool")
        (jid, out), = _submit_n(spool, in_path, tmp_path, 1)
        t1 = str(tmp_path / "svc1.jsonl")
        svc = _service(spool, chunk_budget=0, trace_path=t1)
        orig = svc.worker.run_slice

        def expiring_run_slice(spec, budget, should_yield, drain_event, lease=None):
            lease.deadline_m = time.monotonic()
            return orig(spec, budget, should_yield, drain_event, lease=lease)

        svc.worker.run_slice = expiring_run_slice
        snap = svc.run_until_idle()
        assert snap["jobs_expired"] == 1 and snap["jobs_done"] == 0 and snap["jobs_failed"] == 0
        st = client.status(spool, jid)
        assert st["state"] == "expired" and "checkpoint preserved" in st["error"]
        assert not os.path.exists(out)
        with open(out + ".ckpt") as f:
            n_committed = len(json.load(f)["done"])
        assert n_committed >= 1
        exp = [e for e in _events(t1)[1] if e["name"] == "job_expired"]
        assert len(exp) == 1 and exp[0]["chunks_done"] == n_committed
        jid2 = client.submit(spool, in_path, out, config=dict(CONFIG))
        assert _service(spool, chunk_budget=0).run_until_idle()["jobs_done"] == 1
        assert client.status(spool, jid2)["result"]["n_chunks_skipped"] >= n_committed
        assert _read(out) == ref_bytes


def _clock(t):
    """A local lease store whose clock reads ``t`` (set ``.t`` to move it)."""
    from duplexumiconsensusreads_torch.serve.store import LocalLeaseStore

    class Clock(LocalLeaseStore):
        def now(self):
            return self.t

    store = Clock()
    store.t = t
    return store


class TestWatchdog:
    def test_reclaim_stalled_requeues_and_counts_crash(self, tmp_path):
        from duplexumiconsensusreads_torch.serve.queue import JobFenced

        q, jid = _queued(_pkg("torch"), str(tmp_path))
        token = q.claim(jid, "d1", lease_s=3600.0)
        assert q.reclaim_stalled(None) == []
        assert q.reclaim_stalled(60.0) == []
        with q._txn():
            q.jobs[jid]["progress_m"] = round(time.monotonic() - 10, 3)
            q.save()
        rec = q.reclaim_stalled(5.0)
        assert len(rec) == 1 and rec[0]["reason"] == "stalled" and rec[0]["stalled_s"] > 5.0
        assert rec[0]["crash_count"] == 1 and "quarantined" not in rec[0]
        e = q.jobs[jid]
        assert e["state"] == "queued" and "lease" not in e
        assert e["crash_count"] == 1 and e["token"] == token
        assert q.claim(jid, "d2", lease_s=3600.0) == token + 1
        with pytest.raises(JobFenced):
            q.verify_lease(jid, "d1", token)

    @pytest.mark.parametrize("past_s", [0.0, 0.0004])
    def test_stall_record_is_never_shorter_than_its_threshold(self, tmp_path, past_s):
        """The watchdog requeues a job only once its stall is past the
        threshold, and the record says so: a stall 0.4 ms past 1.5 s
        reads above 1.5 s (to the nearest millisecond it would read
        1.5); a stall of exactly the threshold leaves the job alone."""
        clock = _clock(1000.5)
        q, jid = _queued(_pkg("torch"), str(tmp_path), store=clock)
        q.claim(jid, "d1", lease_s=3600.0)
        assert q.jobs[jid]["progress_m"] == 1000.5
        clock.t = 1000.5 + 1.5 + past_s
        rec = q.reclaim_stalled(1.5)
        if past_s == 0.0:
            assert rec == [] and q.jobs[jid]["state"] == "running"
            return
        assert [r["job_id"] for r in rec] == [jid] and q.jobs[jid]["state"] == "queued"
        assert rec[0]["stalled_s"] > 1.5

    def test_threshold_stamps_never_fall_before_their_allowance(self, tmp_path):
        """A stamp a threshold is judged on rounds to its safe side: a
        deadline or a lease expiry never falls before its allowance ends,
        and a progress stamp never makes a stall read longer than it was
        (to the nearest millisecond each could be half a millisecond
        off)."""
        clock = _clock(1000.0004)
        root = str(tmp_path)
        q = SpoolQueue(root, store=clock)
        jid = client.submit(root, __file__, os.path.join(root, "job.bam"),
                            config=dict(CONFIG), deadline_s=60.0)
        assert q.accept_one(jid)[0] is not None
        assert q.jobs[jid]["deadline_m"] >= clock.t + 60.0
        q.claim(jid, "d1", lease_s=30.0)
        e = q.jobs[jid]
        assert e["lease"]["expires_m"] >= clock.t + 30.0 and e["progress_m"] >= clock.t
        clock.t = 1010.0004
        q.renew_lease(jid, "d1", e["token"], lease_s=30.0)
        e = q.jobs[jid]
        assert e["lease"]["expires_m"] >= clock.t + 30.0 and e["progress_m"] >= clock.t
        clock.t = 1020.0004
        assert q.renew_all("d1", lease_s=30.0) == 1
        assert q.jobs[jid]["lease"]["expires_m"] >= clock.t + 30.0

    def test_wedged_slice_is_watchdog_requeued_and_finished_elsewhere(self, sim, tmp_path):
        """Daemon A's slice wedges after its first commit with the lease
        held; A's watchdog requeues the job, daemon B finishes it
        byte-identical, and A's slice, woken, is fenced."""
        import threading

        in_path, ref_bytes = sim
        spool = str(tmp_path / "spool")
        (jid, out), = _submit_n(spool, in_path, tmp_path, 1)
        t_a = str(tmp_path / "svcA.jsonl")
        svc_a = _service(spool, chunk_budget=1, trace_path=t_a, lease_s=3600.0,
                         watchdog_s=1.5, daemon_id="wd-A")
        wedged, resume = threading.Event(), threading.Event()
        orig = svc_a.worker.run_slice

        def wedging_run_slice(spec, budget, should_yield, drain_event, lease=None):
            def wedge_then_no_yield():
                wedged.set()
                resume.wait(timeout=120)
                return False

            return orig(spec, 1, wedge_then_no_yield, drain_event, lease=lease)

        svc_a.worker.run_slice = wedging_run_slice
        box = {}
        th = threading.Thread(target=lambda: box.setdefault("snap", svc_a.run_until_idle()),
                              daemon=True)
        th.start()
        assert wedged.wait(timeout=120), "daemon A never wedged"
        _wait_for(lambda: SpoolQueue(spool).jobs.get(jid, {}).get("state") == "queued", 60,
                  "the watchdog")
        # A's watchdog has fired; from here on it would fire again on B's
        # claim of the job whenever B took longer than 1.5 s to commit a
        # chunk, as it may on a loaded host
        svc_a.watchdog_s = 0
        assert SpoolQueue(spool).jobs[jid].get("crash_count") == 1
        t_b = str(tmp_path / "svcB.jsonl")
        snap_b = _service(spool, trace_path=t_b, watchdog_s=0, daemon_id="wd-B").run_until_idle()
        assert snap_b["jobs_done"] == 1
        resume.set()
        th.join(timeout=120)
        assert not th.is_alive() and "snap" in box
        snap_a = box["snap"]
        assert snap_a["watchdog_fired"] == 1
        assert snap_a["jobs_fenced"] == 1 and snap_a["jobs_done"] == 0
        assert _read(out) == ref_bytes
        entry = SpoolQueue(spool).jobs[jid]
        assert entry["state"] == "done" and entry["token"] == 2
        ev_a = _events(t_a)[1]
        wd = [e for e in ev_a if e["name"] == "watchdog_fired"]
        assert len(wd) == 1 and wd[0]["job"] == jid and wd[0]["stalled_s"] > 1.5
        assert any(e["name"] == "job_fenced" for e in ev_a)
        assert _completed(t_a, t_b) == [jid]

    def test_sigstopped_worker_subprocess_is_watchdog_requeued(self, sim, tmp_path):
        """Daemon A (a subprocess) claims the job and is SIGSTOPped
        mid-slice: its pid lives and its 3600 s lease never expires, so
        only daemon B's --watchdog frees the job; B finishes it
        byte-identical and A is fenced by the token bump."""
        import fcntl

        in_path, ref_bytes = sim
        spool = str(tmp_path / "spool")
        (jid, out), = _submit_n(spool, in_path, tmp_path, 1)
        proc = subprocess.Popen(
            DAEMON + [spool, "--device", "cpu", "--poll", "0.05", "--heartbeat", "0.2",
                      "--lease", "3600", "--watchdog", "0", "--daemon-id", "stop-A"],
            env=ENV, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

        def flock_free(timeout_s=2.0):
            # a stopped process keeps any flock it holds
            fd = os.open(os.path.join(spool, "journal.lock"), os.O_CREAT | os.O_RDWR, 0o644)
            try:
                t_end = time.monotonic() + timeout_s
                while time.monotonic() < t_end:
                    try:
                        fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
                        fcntl.flock(fd, fcntl.LOCK_UN)
                        return True
                    except OSError:
                        time.sleep(0.02)
                return False
            finally:
                os.close(fd)

        try:
            _wait_for(lambda: client.status(spool, jid).get("state") == "running"
                      and client.status(spool, jid).get("lease"), 120, "the claim", proc)
            for _ in range(20):
                proc.send_signal(signal.SIGSTOP)
                if flock_free():
                    break
                proc.send_signal(signal.SIGCONT)
                time.sleep(0.05)
            else:
                pytest.fail("could not stop daemon A outside a journal txn")
            p2 = subprocess.run(
                DAEMON + [spool, "--device", "cpu", "--once", "--poll", "0.05",
                          "--heartbeat", "0", "--watchdog", "4.0", "--max-crashes", "50",
                          "--daemon-id", "stop-B"],
                env=ENV, cwd=REPO, capture_output=True, text=True, timeout=120)
            assert p2.returncode == 0, p2.stderr
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        st = client.status(spool, jid)
        assert st["state"] == "done" and st["token"] >= 2 and st["crash_count"] >= 1
        assert _read(out) == ref_bytes
        recs, ev = _events(os.path.join(spool, "service.stop-B.trace.jsonl"))
        assert trace_report.validate_service_trace(recs) == []
        wd = [e for e in ev if e["name"] == "watchdog_fired"]
        assert len(wd) >= 1 and wd[0]["job"] == jid
        assert len([e for e in ev if e["name"] == "job_completed"]) == 1


class TestPoisonQuarantine:
    def test_poison_job_quarantined_after_exactly_max_crashes(self, sim, tmp_path):
        """A job that kills its daemon at its first shard write every
        time is quarantined after exactly max_crashes (3) deaths, with a
        durable diagnosis; the healthy job beside it finishes
        byte-identical, and a fresh daemon starts nothing."""
        in_path, ref_bytes = sim
        spool = str(tmp_path / "spool")
        poison_out = str(tmp_path / "poison.bam")
        poison = client.submit(spool, in_path, poison_out, config=dict(CONFIG),
                               chaos="shard.write:1:kill",
                               trace=str(tmp_path / "poison.trace.jsonl"))
        (healthy, healthy_out), = _submit_n(spool, in_path, tmp_path, 1, prefix="healthy")
        deaths, final_snap, final_trace = 0, None, None
        for i in range(8):
            # daemons that will run the poison slice get no service
            # capture, so the job's own recorder sees the fault
            t = str(tmp_path / f"svc{i}.jsonl") if deaths >= 3 else None
            try:
                final_snap = _service(spool, chunk_budget=0, trace_path=t,
                                      daemon_id=f"pd-{i}").run_until_idle()
                final_trace = t
                break
            except faults.InjectedKill:
                deaths += 1
        else:
            pytest.fail("fleet never converged past the poison job")
        assert deaths == 3
        st = client.status(spool, poison)
        assert st["state"] == "quarantined"
        assert "quarantined after 3 crashed runs" in st["error"]
        diag = st["result"]["diagnosis"]
        assert diag["crash_count"] == 3 and diag["max_crashes"] == 3
        assert diag["last_abort"] == "dead-owner"
        assert [h["owner"] for h in diag["lease_history"]] == ["pd-0", "pd-1", "pd-2"]
        assert diag["last_fault_site"] == "shard.write" and diag["trace_tail"]
        assert client.wait(spool, poison, timeout_s=5)["state"] == "quarantined"
        assert not os.path.exists(poison_out)
        assert final_snap["jobs_done"] == 1 and final_snap["jobs_quarantined"] == 1
        assert client.status(spool, healthy)["state"] == "done"
        assert _read(healthy_out) == ref_bytes
        assert SpoolQueue(spool).jobs[poison]["slices"] == 3
        q_ev = [e for e in _events(final_trace)[1] if e["name"] == "job_quarantined"]
        assert len(q_ev) == 1 and q_ev[0]["job"] == poison and q_ev[0]["crash_count"] == 3
        t_after = str(tmp_path / "after.jsonl")
        snap = _service(spool, trace_path=t_after, daemon_id="pd-after").run_until_idle()
        assert snap["jobs_quarantined"] == 1
        assert [e for e in _events(t_after)[1] if e["name"] == "job_started"] == []

    def test_clean_preemptions_never_count_toward_quarantine(self, sim, tmp_path):
        in_path, ref_bytes = sim
        spool = str(tmp_path / "spool")
        jobs = _submit_n(spool, in_path, tmp_path, 2)
        snap = _service(spool, chunk_budget=1).run_until_idle()
        assert snap["preemptions"] >= 2 and snap["jobs_quarantined"] == 0
        for jid, out in jobs:
            assert SpoolQueue(spool).jobs[jid].get("crash_count", 0) == 0
            assert _read(out) == ref_bytes


class TestDiskPressure:
    def _queued_terminal_with_litter(self, tmp_path):
        q = SpoolQueue(str(tmp_path))
        jid = client.submit(str(tmp_path), __file__, str(tmp_path / "t0.bam"),
                            config=dict(CONFIG))
        q.accept_one(jid)
        q.mark_failed(jid, "boom")
        out = q.jobs[jid]["spec"]["output"]
        with open(out + ".ckpt", "w") as f:
            f.write('{"done": {}}')
        os.makedirs(out + ".shards", exist_ok=True)
        with open(os.path.join(out + ".shards", "chunk000000.recs"), "wb") as f:
            f.write(b"x" * 4096)
        with open(out + ".tmp", "wb") as f:
            f.write(b"y" * 2048)
        return q, out

    def test_low_water_sheds_with_disk_reason(self, tmp_path, monkeypatch):
        from duplexumiconsensusreads_torch.serve import queue as queue_mod

        q = SpoolQueue(str(tmp_path), min_free_bytes=64 << 20)
        jid = client.submit(str(tmp_path), __file__, str(tmp_path / "o.bam"),
                            config=dict(CONFIG))
        monkeypatch.setattr(queue_mod, "free_bytes", lambda p: 1 << 20)
        spec, reason = q.accept_one(jid)
        assert spec is None and reason.startswith("shed: disk")
        st = q.status(jid)
        assert st["state"] == "rejected" and st["shed"] is True and "low-water" in st["error"]

    def test_grace_gc_frees_terminal_litter_then_admits(self, tmp_path, monkeypatch):
        from duplexumiconsensusreads_torch.serve import queue as queue_mod

        q, out = self._queued_terminal_with_litter(tmp_path)
        q.min_free_bytes = 64 << 20
        probes = iter([1 << 20, 1 << 30])
        monkeypatch.setattr(queue_mod, "free_bytes", lambda p: next(probes, 1 << 30))
        jid = client.submit(str(tmp_path), __file__, str(tmp_path / "new.bam"),
                            config=dict(CONFIG))
        spec, reason = q.accept_one(jid)
        assert spec is not None and reason is None
        for suffix in (".ckpt", ".shards", ".tmp"):
            assert not os.path.exists(out + suffix)

    def test_gc_only_touches_terminal_jobs_litter(self, tmp_path):
        q, out = self._queued_terminal_with_litter(tmp_path)
        live = client.submit(str(tmp_path), __file__, str(tmp_path / "live.bam"),
                             config=dict(CONFIG))
        q.accept_one(live)
        live_out = q.jobs[live]["spec"]["output"]
        with open(live_out + ".ckpt", "w") as f:
            f.write('{"done": {}}')
        with open(out, "wb") as f:
            f.write(b"published bytes")
        assert q.gc_terminal_litter() >= 4096 + 2048
        assert not os.path.exists(out + ".ckpt")
        assert os.path.exists(out) and os.path.exists(live_out + ".ckpt")

    def test_probe_disabled_never_sheds(self, tmp_path, monkeypatch):
        from duplexumiconsensusreads_torch.serve import queue as queue_mod

        q = SpoolQueue(str(tmp_path), min_free_bytes=0)
        monkeypatch.setattr(queue_mod, "free_bytes", lambda p: 0)
        jid = client.submit(str(tmp_path), __file__, str(tmp_path / "o.bam"),
                            config=dict(CONFIG))
        assert q.accept_one(jid)[0] is not None

    def test_free_bytes_probe_answers_on_real_fs(self, tmp_path):
        from duplexumiconsensusreads_tpu.io.durable import free_bytes as jax_free_bytes
        from duplexumiconsensusreads_torch.io.durable import free_bytes

        free = free_bytes(str(tmp_path))
        assert isinstance(free, int) and free > 0
        assert free_bytes(str(tmp_path / "nope" / "deeper")) is None
        assert jax_free_bytes(str(tmp_path / "nope" / "deeper")) is None


class TestShardingKills:
    """The kill cases of the JAX suite's sharding class: wherever a
    daemon dies on a sharded job (committing the plan, in the parent
    sweep, between merge splices, mid child slice), a successor
    converges to the unsharded bytes with exactly one completion."""

    def _submit(self, spool, in_path, out):
        return client.submit(spool, in_path, out, config=dict(CONFIG), shards=3)

    @pytest.mark.parametrize("site,nth", [("serve.split", 1), ("serve.merge", 1)])
    def test_kill_at_shard_site_then_restart_byte_identical(self, site, nth, sim, tmp_path):
        in_path, ref_bytes = sim
        spool = str(tmp_path / "spool")
        out = str(tmp_path / "out.bam")
        jid = self._submit(spool, in_path, out)
        faults.install(faults.FaultPlan.parse(f"{site}:{nth}:kill"))
        with pytest.raises(faults.InjectedKill):
            _service(spool).run_until_idle()
        faults.uninstall()
        if site == "serve.split":
            assert SpoolQueue(spool).jobs[jid]["state"] == "splitting"
        t2 = str(tmp_path / "svc2.jsonl")
        _service(spool, trace_path=t2).run_until_idle()
        st = client.status(spool, jid)
        assert st["state"] == "done"
        assert st["shards"]["done"] == st["shards"]["n_shards"] == 3
        assert _read(out) == ref_bytes
        assert [j for j in _completed(t2) if j == jid] == [jid]

    def test_kill_mid_splice_then_takeover_remerges_exactly_once(self, sim, tmp_path):
        in_path, ref_bytes = sim
        spool = str(tmp_path / "spool")
        out = str(tmp_path / "out.bam")
        jid = self._submit(spool, in_path, out)
        t_a = str(tmp_path / "svcA.jsonl")
        svc_a = _service(spool, trace_path=t_a, daemon_id="merge-victim")
        orig = svc_a._fenced_renew
        fences = [0]

        def dying_fence(job_id, token):
            # fence 1 = the split's pre-registration renewal; 2.. = the
            # merge splice guards: die on the second merge fence
            if job_id == jid:
                fences[0] += 1
                if fences[0] == 3:
                    raise faults.InjectedKill("die mid-splice")
            orig(job_id, token)

        svc_a._fenced_renew = dying_fence
        with pytest.raises(faults.InjectedKill):
            svc_a.run_until_idle()
        assert SpoolQueue(spool).jobs[jid]["state"] == "merging"
        t_b = str(tmp_path / "svcB.jsonl")
        snap_b = _service(spool, trace_path=t_b, daemon_id="merge-b").run_until_idle()
        assert snap_b["jobs_merged"] == 1
        assert client.status(spool, jid)["state"] == "done"
        assert _read(out) == ref_bytes
        assert [j for j in _completed(t_a, t_b) if j == jid] == [jid]

    def test_mid_shard_sigkill_takeover_byte_identical(self, sim, tmp_path):
        in_path, ref_bytes = sim
        spool = str(tmp_path / "spool")
        out = str(tmp_path / "out.bam")
        jid = self._submit(spool, in_path, out)
        t_a = str(tmp_path / "svcA.jsonl")
        svc_a = _service(spool, chunk_budget=0, trace_path=t_a, daemon_id="shard-victim")
        orig = svc_a.worker.run_slice

        def dying_run_slice(spec, budget, should_yield, drain_event, lease=None):
            if spec.shard is None:
                return orig(spec, budget, should_yield, drain_event, lease=lease)

            def die():
                raise faults.InjectedKill("mid-shard daemon death")

            return orig(spec, 1, die, drain_event, lease=lease)

        svc_a.worker.run_slice = dying_run_slice
        with pytest.raises(faults.InjectedKill):
            svc_a.run_until_idle()
        t_b = str(tmp_path / "svcB.jsonl")
        snap_b = _service(spool, trace_path=t_b, daemon_id="shard-b").run_until_idle()
        assert snap_b["jobs_recovered"] >= 1 and snap_b["jobs_merged"] == 1
        assert client.status(spool, jid)["state"] == "done"
        assert _read(out) == ref_bytes
        assert sorted(_completed(t_a, t_b)) == sorted([jid] + [f"{jid}.s{i:03d}"
                                                               for i in range(3)])


_SIGNAL_SCRIPT = r"""
import json, signal, sys, threading
from duplexumiconsensusreads_torch.serve import ConsensusService
svc = ConsensusService(sys.argv[1], device="cpu", poll_s=0.02, chunk_budget=0)
ran = threading.Event()
signal.signal(signal.SIGUSR1, lambda s, f: (ran.set(), svc.request_drain()))
orig = svc.worker.run_slice

def held_slice(spec, budget, should_yield, drain_event, lease=None):
    # the kernel hands the signal to this worker thread; the slice
    # starts only once the drain was requested (or 20 s pass)
    signal.pthread_kill(threading.get_ident(), signal.SIGUSR1)
    drain_event.wait(timeout=20)
    return orig(spec, budget, should_yield, drain_event, lease=lease)

svc.worker.run_slice = held_slice
snap = svc.run()
print(json.dumps({"handler_ran": ran.is_set(), "done": snap["jobs_done"],
                  "preemptions": snap["preemptions"]}))
"""


def test_a_drain_signal_taken_by_a_worker_thread_still_drains(sim, tmp_path):
    """A process signal may land on any thread. The daemon's SIGTERM
    drain is a Python handler, which runs on the main thread only when
    it executes bytecode: with the workers joined without a timeout it
    waited for the whole job. Here the signal is sent to the worker
    thread itself while its slice waits for the drain: the handler runs
    and the job yields at its first chunk boundary (a JAX daemon under
    load lost SIGTERM this way: ROADMAP Faults 17)."""
    in_path, ref_bytes = sim
    spool = str(tmp_path / "spool")
    (jid, out), = _submit_n(spool, in_path, tmp_path, 1)
    r = subprocess.run([sys.executable, "-c", _SIGNAL_SCRIPT, spool], env=ENV, cwd=REPO,
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == 0, r.stderr[-2000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert got == {"handler_ran": True, "done": 0, "preemptions": 1}
    assert SpoolQueue(spool).jobs[jid]["state"] == "queued"
    assert _service(spool).run_until_idle()["jobs_done"] == 1
    assert _read(out) == ref_bytes
