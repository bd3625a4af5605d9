"""The port's chaos suite: deterministic fault injection against the
port's streaming executor, follow mode and serving layer
(``duplexumiconsensusreads_torch/runtime/faults.py``), case for case
with the JAX package's ``tests/test_chaos.py``. Every run is on the CPU.

What each case holds:

- the port's faulted output bytes equal the port's own fault-free bytes
  (after a kill, a resume converges to them);
- the port's fault-free run equals the JAX package's fault-free run of
  the same input at the parity bar, record by record (file bytes are
  not compared across engines: the deflate codecs differ);
- for each stream-site plan, the port's ``plan.n_fired``, the exception
  type raised and ``n_chunks_skipped`` on resume equal those of the JAX
  run of the same plan on the same input.

The out-of-order drain cases order the drain workers with events, not
with sleeps, so no assertion depends on timing.

This file is a dutlint test anchor (the port's fault-registry rule reads
its literals): ``SITES`` lists every registered site, and the per-site
case is parametrized over it, so dropping a site from the tuple is a
lint finding as well as a failed registry pin.
"""

from __future__ import annotations

import json
import os
import threading
import zlib

import numpy as np
import pytest

from duplexumiconsensusreads_tpu.io import read_bam as jax_read_bam
from duplexumiconsensusreads_tpu.io import simulated_bam
from duplexumiconsensusreads_tpu.runtime import faults as jax_faults
from duplexumiconsensusreads_tpu.runtime.stream import stream_call_consensus as jax_stream
from duplexumiconsensusreads_tpu.simulate import SimConfig
from duplexumiconsensusreads_tpu.types import ConsensusParams as JC
from duplexumiconsensusreads_tpu.types import GroupingParams as JG
from duplexumiconsensusreads_torch.constants import BASE_N, NO_CALL_QUAL
from duplexumiconsensusreads_torch.io import read_bam
from duplexumiconsensusreads_torch.runtime import faults
from duplexumiconsensusreads_torch.runtime.stream import stream_call_consensus
from duplexumiconsensusreads_torch.types import ConsensusParams, GroupingParams

pytestmark = pytest.mark.chaos

GP = GroupingParams(strategy="adjacency", paired=True)
CP = ConsensusParams(mode="duplex")
KW = dict(capacity=128, chunk_reads=90)
CONFIG = dict(grouping="adjacency", mode="duplex", capacity=128, chunk_reads=90)

# every registered fault site, in registry order; pinned equal to
# faults.KNOWN_SITES below
SITES = (
    "ingest.read", "bgzf.inflate", "ingest.queue", "dispatch.device_put",
    "dispatch.pack", "fetch.result", "fetch.unpack", "drain.scatter",
    "shard.write", "ckpt.save", "finalise.write",
    "serve.accept", "serve.journal", "serve.preempt",
    "serve.lease", "serve.renew", "serve.expire", "serve.fence",
    "serve.hb", "serve.store", "serve.deadline", "serve.watchdog",
    "serve.split", "serve.merge",
    "live.poll", "live.snapshot",
)


def _run_port(path, out, **kw):
    return stream_call_consensus(path, out, GP, CP, device="cpu", **{**KW, **kw})


def _run_jax(path, out, **kw):
    return jax_stream(path, out, JG(**vars(GP)), JC(**vars(CP)), n_devices=1, **{**KW, **kw})


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def sim(tmp_path_factory):
    """(input path, the port's fault-free output bytes, the JAX
    fault-free output path) — computed once; every chaos run of the
    port must reproduce the port's bytes exactly."""
    d = tmp_path_factory.mktemp("torch_chaos")
    path = str(d / "in.bam")
    simulated_bam(SimConfig(n_molecules=70, n_positions=9, umi_error=0.02, seed=31),
                  path=path, sort=True)
    ref, jref = str(d / "ref.bam"), str(d / "jref.bam")
    rep = _run_port(path, ref)
    assert rep.n_chunks >= 3  # enough phase-boundary hits for every nth below
    _run_jax(path, jref)
    return path, _read(ref), jref


@pytest.fixture(scope="module")
def serve_ref(sim, tmp_path_factory):
    """The port's fault-free bytes for a SERVICE-run job: the same input
    and params as ``sim`` with the canonical serve provenance line."""
    from duplexumiconsensusreads_torch.serve.job import serve_provenance

    path, _, _ = sim
    ref = str(tmp_path_factory.mktemp("torch_chaos_serve") / "serve_ref.bam")
    _run_port(path, ref, provenance_cl=serve_provenance(CONFIG))
    return _read(ref)


@pytest.fixture(autouse=True)
def _no_sleep_and_clean_plan(monkeypatch):
    # retries back off through each executor's time.sleep; spend no wall
    # time on it
    for mod in ("duplexumiconsensusreads_torch.runtime.stream",
                "duplexumiconsensusreads_tpu.runtime.stream"):
        monkeypatch.setattr(f"{mod}.time.sleep", lambda s: None)
    yield
    faults.uninstall()
    jax_faults.uninstall()


def _compare(a, b):
    """Port records against JAX records at the parity bar (duplex): equal
    but for quals within 2 and the duplex strand tie (a base on one
    engine, N on the other, both at NO_CALL_QUAL)."""
    assert len(a) == len(b) > 0
    for f in ("names", "flags", "ref_id", "pos", "mapq", "next_ref_id", "next_pos",
              "tlen", "lengths"):
        np.testing.assert_array_equal(np.asarray(getattr(a, f)), np.asarray(getattr(b, f)),
                                      err_msg=f)
    assert list(a.cigars) == list(b.cigars)
    assert list(a.aux_raw) == list(b.aux_raw)
    sa, sb = np.asarray(a.seq), np.asarray(b.seq)
    qa, qb = np.asarray(a.qual).astype(int), np.asarray(b.qual).astype(int)
    tie = ((sa == BASE_N) | (sb == BASE_N)) & (qa == NO_CALL_QUAL) & (qb == NO_CALL_QUAL)
    assert not ((sa != sb) & ~tie).any()
    assert np.abs(qa - qb).max() <= 2


def test_fault_free_run_matches_jax_at_the_parity_bar(sim, tmp_path):
    path, ref_bytes, jref = sim
    out = str(tmp_path / "ref.bam")
    with open(out, "wb") as f:
        f.write(ref_bytes)
    _compare(read_bam(out)[1], jax_read_bam(jref)[1])


def test_sites_are_the_registry():
    assert SITES == faults.KNOWN_SITES == jax_faults.KNOWN_SITES


class TestPlanParsing:
    def test_parse_and_seeded_replay(self):
        p1 = faults.FaultPlan.parse("seed:1234:6")
        p2 = faults.FaultPlan.parse("seed:1234:6")
        assert p1.schedule == p2.schedule  # seeded schedules replay identically
        assert p1.schedule == jax_faults.FaultPlan.parse("seed:1234:6").schedule
        p3 = faults.FaultPlan.parse("shard.write:2:enospc,ckpt.save:1:kill")
        assert p3.schedule["shard.write"][2] == "enospc"
        assert p3.schedule["ckpt.save"][1] == "kill"

    @pytest.mark.parametrize("bad", [
        "bogus.site:1:oserror", "shard.write:0:oserror",
        "shard.write:1:frobnicate", "shard.write:1",
    ])
    def test_parse_rejects_garbage_with_the_jax_words(self, bad):
        with pytest.raises(ValueError) as jerr:
            jax_faults.FaultPlan.parse(bad)
        with pytest.raises(ValueError) as terr:
            faults.FaultPlan.parse(bad)
        assert str(terr.value) == str(jerr.value)

    def test_env_malformed_spec_names_the_var(self, monkeypatch):
        monkeypatch.setenv("DUT_FAULTS", "shard.write:1")
        faults.uninstall()
        with pytest.raises(ValueError, match="DUT_FAULTS"):
            faults.install_from_env()

    def test_fault_point_is_noop_when_uninstalled(self):
        faults.uninstall()
        faults.fault_point("shard.write")  # must not raise or count

    def test_fires_exactly_once_per_entry(self):
        plan = faults.FaultPlan.parse("shard.write:2:oserror")
        faults.install(plan)
        faults.fault_point("shard.write")
        with pytest.raises(faults.InjectedFault):
            faults.fault_point("shard.write")
        faults.fault_point("shard.write")  # hit 3: schedule exhausted
        assert plan.n_fired == 1 and plan.hits("shard.write") == 3


def _seeded(mod, site):
    return mod.FaultPlan.seeded(zlib.crc32(site.encode()), sites=(site,), n_faults=1, max_nth=1)


@pytest.mark.parametrize("site", SITES)
def test_transient_fault_at_each_site_byte_identical(site, sim, serve_ref, tmp_path):
    """One seeded transient fault at each named site: the run absorbs
    it through its retry/isolation ladders and the final BAM is
    byte-identical to the fault-free run. Stream sites take a stream
    pass (and the JAX run of the same plan fires as often); ``live.*``
    a follow pass over the finished input with a snapshot every chunk;
    ``serve.*`` a two-job service pass (equal priorities and
    chunk_budget=1 preempt every slice; the second job is sharded, so
    serve.split and serve.merge fire in every pass)."""
    path, ref_bytes, _ = sim
    plan = _seeded(faults, site)
    faults.install(plan)
    if site.startswith("serve."):
        from duplexumiconsensusreads_torch.serve import ConsensusService, client

        spool = str(tmp_path / "spool")
        outs = [str(tmp_path / f"out{i}.bam") for i in (1, 2)]
        client.submit(spool, path, outs[0], config=dict(CONFIG))
        client.submit(spool, path, outs[1], config=dict(CONFIG), shards=2)
        ConsensusService(spool, chunk_budget=1, device="cpu").run_until_idle()
        assert plan.n_fired >= 1  # the schedule really injected
        for o in outs:
            assert _read(o) == serve_ref
        return
    kw = dict(follow=True, live_poll_s=0.01, snapshot_chunks=1) if site.startswith("live.") else {}
    out = str(tmp_path / "out.bam")
    _run_port(path, out, **kw)
    assert plan.n_fired >= 1  # the schedule really injected
    assert _read(out) == ref_bytes
    jplan = _seeded(jax_faults, site)
    jax_faults.install(jplan)
    _run_jax(path, str(tmp_path / "jout.bam"), **kw)
    assert plan.schedule == jplan.schedule
    assert plan.n_fired == jplan.n_fired


def test_seeded_multi_fault_schedule_byte_identical(sim, tmp_path):
    """A seeded schedule spraying several transient faults across sites
    mid-run still converges to the fault-free bytes, and fires as often
    as the JAX run of the same schedule."""
    path, ref_bytes, _ = sim
    plan = faults.FaultPlan.seeded(20260803, n_faults=8)
    faults.install(plan)
    out = str(tmp_path / "multi.bam")
    _run_port(path, out)
    assert plan.n_fired >= 1
    assert _read(out) == ref_bytes
    jplan = jax_faults.FaultPlan.seeded(20260803, n_faults=8)
    jax_faults.install(jplan)
    _run_jax(path, str(tmp_path / "jmulti.bam"))
    assert plan.n_fired == jplan.n_fired


# the phase boundaries of the write/recover spine (the JAX suite's
# table): a shard write on a drain worker, the pre-mark checkpoint save,
# the incremental finalise's header and a later append, the H2D pack on
# an xfer worker, the packed-D2H unpack on a drain worker, the ingest
# producer's second handoff, and the first live snapshot publish
BOUNDARY_KILLS = [
    ("shard.write", 1),
    ("ckpt.save", 2),
    ("finalise.write", 1),
    ("finalise.write", 2),
    ("dispatch.pack", 2),
    ("fetch.unpack", 2),
    ("ingest.queue", 2),
    ("live.snapshot", 1),
]

# per-site kwargs that make a boundary site reachable at all (applied to
# the kill run AND the resume, which must also clean the artefacts up)
_BOUNDARY_KILL_KW = {
    "live.snapshot": {"snapshot_chunks": 1},
}


def _kill_then_resume(run, mod, path, out, spec, kw):
    """(exception type, n_fired, resume report) of one kill-then-resume."""
    plan = mod.FaultPlan.parse(spec)
    mod.install(plan)
    with pytest.raises(mod.InjectedKill) as exc:
        run(path, out, **kw)
    mod.uninstall()
    # atomic finalise: no half-written BAM at the real path after a kill
    assert not os.path.exists(out)
    return type(exc.value).__name__, plan.n_fired, run(path, out, resume=True, **kw)


# the serial window: one drain worker, one chunk in flight. In the
# default window the chunk a worker-thread kill lands on depends on
# which of two drain workers reaches the site first — on both engines —
# so the resume's skip count is compared where the order is fixed
SERIAL_KW = dict(drain_workers=1, max_inflight=1)


@pytest.mark.parametrize("site,nth", BOUNDARY_KILLS)
def test_kill_at_phase_boundary_then_resume_converges(site, nth, sim, tmp_path):
    path, ref_bytes, _ = sim
    kw = _BOUNDARY_KILL_KW.get(site, {})
    spec = f"{site}:{nth}:kill"
    out = str(tmp_path / "k.bam")
    rep = _kill_then_resume(_run_port, faults, path, out, spec, kw)[2]
    if site == "finalise.write":
        # the commit marks BEFORE it appends: the frontier chunk was
        # durable and resume skips it
        assert rep.n_chunks_skipped >= 1
    assert _read(out) == ref_bytes
    assert not os.path.exists(out + ".ckpt")  # auto-ckpt cleaned on success
    if site == "live.snapshot":
        assert not os.path.exists(out + ".snapshot.bam")
        assert not os.path.exists(out + ".snapshot.bam.bai")
    # the same plan in the serial window, on both engines
    skw = {**kw, **SERIAL_KW}
    sout, jout = str(tmp_path / "sk.bam"), str(tmp_path / "jk.bam")
    exc, fired, srep = _kill_then_resume(_run_port, faults, path, sout, spec, skw)
    jexc, jfired, jrep = _kill_then_resume(_run_jax, jax_faults, path, jout, spec, skw)
    assert (exc, fired, srep.n_chunks_skipped) == (jexc, jfired, jrep.n_chunks_skipped)
    assert _read(sout) == ref_bytes


def test_resume_refuses_runtime_codec_fallback_shards(sim, tmp_path, monkeypatch):
    """Native and pure-Python BGZF deflate emit different (both valid)
    bytes. The JAX package's ``compress_fast`` falls back to Python
    silently when the native compress fails at run time; the port's
    raises instead, so no python-deflate shard is ever written under a
    native run. The manifest still records each shard's codec, and a
    resume refuses a shard whose tag is not the run's codec: a manifest
    whose shards claim python deflate (what a silent fallback would have
    left) is recomputed, never spliced."""
    from duplexumiconsensusreads_torch import native
    from duplexumiconsensusreads_torch.io import bgzf

    path, ref_bytes, _ = sim
    monkeypatch.delenv("DUT_NO_NATIVE", raising=False)
    assert bgzf.deflate_flavor() == "native"
    out = str(tmp_path / "codec.bam")

    def failing(*a, **k):
        raise OSError("native deflate failed")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "bgzf_compress_native", failing)
        with pytest.raises(OSError, match="native deflate failed"):
            _run_port(path, out)
    assert not os.path.exists(out)
    faults.install(faults.FaultPlan.parse("ckpt.save:3:kill"))
    with pytest.raises(faults.InjectedKill):
        _run_port(path, out)
    faults.uninstall()
    with open(out + ".ckpt") as f:
        manifest = json.load(f)
    assert manifest["done"], "kill must land after at least one mark"
    assert {e["codec"] for e in manifest["done"].values()} == {"native"}
    for e in manifest["done"].values():
        e["codec"] = "python"
    with open(out + ".ckpt", "w") as f:
        json.dump(manifest, f)
    rep = _run_port(path, out, resume=True)
    assert rep.n_chunks_skipped == 0
    assert _read(out) == ref_bytes


@pytest.mark.parametrize("damage", ["flip", "truncate"])
def test_corrupted_shard_detected_and_recomputed(damage, sim, tmp_path):
    """Resume against a deliberately corrupted shard: the manifest's
    size+CRC check drops the entry and recomputes the chunk."""
    path, ref_bytes, _ = sim
    out = str(tmp_path / "c.bam")
    ck = str(tmp_path / "ck.json")  # explicit checkpoint: shards survive
    _run_port(path, out, checkpoint_path=ck)
    with open(ck) as f:
        entry = json.load(f)["done"]["0"]
    assert {"path", "size", "crc32"} <= set(entry) and entry["size"] > 0
    with open(entry["path"], "r+b") as f:
        if damage == "flip":  # size unchanged: only the CRC can catch it
            f.seek(entry["size"] // 2)
            b = f.read(1)
            f.seek(entry["size"] // 2)
            f.write(bytes([b[0] ^ 0xFF]))
        else:
            f.truncate(entry["size"] // 2)
    rep = _run_port(path, out, checkpoint_path=ck, resume=True)
    assert rep.n_chunks_skipped == rep.n_chunks - 1  # only chunk 0 recomputed
    assert _read(out) == ref_bytes


@pytest.mark.parametrize(
    "garbage", ['{"fingerprint": "x", "done"', "[1, 2]", "", '{"done": null}'],
)
def test_torn_manifest_discarded_not_fatal(garbage, sim, tmp_path):
    """A torn or garbage checkpoint manifest is discarded and the run
    recomputed, never a JSON traceback."""
    path, ref_bytes, _ = sim
    out = str(tmp_path / "t.bam")
    ck = str(tmp_path / "ck.json")
    with open(ck, "w") as f:
        f.write(garbage)
    rep = _run_port(path, out, checkpoint_path=ck, resume=True)
    assert rep.n_chunks_skipped == 0  # nothing trustworthy to skip
    assert _read(out) == ref_bytes
    with open(ck) as f:
        assert len(json.load(f)["done"]) == rep.n_chunks  # manifest healed


def test_env_var_activates_schedule(sim, tmp_path, monkeypatch):
    """DUT_FAULTS installs a fresh plan (fresh counters) per run."""
    path, ref_bytes, _ = sim
    monkeypatch.setenv("DUT_FAULTS", "shard.write:1:enospc")
    out = str(tmp_path / "env.bam")
    _run_port(path, out)
    plan = faults.get_active()
    assert plan is not None and plan.n_fired == 1
    assert _read(out) == ref_bytes


def test_cli_chaos_flag(sim, tmp_path, monkeypatch):
    """``call --chaos`` wires a schedule through the CLI (an explicit
    flag beats a stale env schedule); a bad schedule, or the flag on the
    whole-file path, is a clean CLI error."""
    from duplexumiconsensusreads_torch.cli.main import main

    path, ref_bytes, _ = sim
    out = str(tmp_path / "cli.bam")
    monkeypatch.setenv("DUT_FAULTS", "shard.write:1:kill")
    # the port's CLI uninstalls its plan when the run ends: keep a handle
    installed = []
    real_install = faults.install
    monkeypatch.setattr(faults, "install", lambda p: (installed.append(p), real_install(p)))
    rc = main(["call", path, "-o", out, "--config", "config3", "--capacity", "128",
               "--chunk-reads", "90", "--device", "cpu", "--chaos", "fetch.result:1:oserror"])
    assert rc == 0
    plan = [p for p in installed if p is not None][-1]
    assert plan.n_fired == 1
    assert plan.spec == "fetch.result:1:oserror"
    # config3 is this suite's adjacency + duplex; only @PG CL differs
    ref = str(tmp_path / "ref.bam")
    with open(ref, "wb") as f:
        f.write(ref_bytes)
    (_, a), (_, b) = read_bam(out), read_bam(ref)
    np.testing.assert_array_equal(np.asarray(a.qual), np.asarray(b.qual))
    np.testing.assert_array_equal(np.asarray(a.seq), np.asarray(b.seq))
    with pytest.raises(SystemExit, match="--chaos"):
        main(["call", path, "-o", out, "--chunk-reads", "90", "--device", "cpu",
              "--chaos", "nope:1:oserror"])
    with pytest.raises(SystemExit, match="--chunk-reads"):
        main(["call", path, "-o", out, "--device", "cpu", "--chaos", "fetch.result:1:oserror"])


def _force_reverse_drain(monkeypatch, n_chunks, order_log=None, killed=None):
    """Hold each drain worker's ``_finish_chunk`` until every later chunk
    has finished, so completion order is exactly the reverse of chunk
    order and the ordered frontier is what must restore it. Events, not
    sleeps: chunk k waits on the event of chunk k + 1 — or on ``killed``
    (set when an injected kill fires: the chunk it lands on never
    finishes, and the ones before it are released instead)."""
    import duplexumiconsensusreads_torch.runtime.stream as stream_mod

    real = stream_mod._finish_chunk
    done = [threading.Event() for _ in range(n_chunks)]
    killed = killed or threading.Event()

    def reordering(k, *a, **kw):
        if k + 1 < n_chunks:
            while not (done[k + 1].is_set() or killed.is_set()):
                done[k + 1].wait(timeout=0.01)
        try:
            res = real(k, *a, **kw)
            if order_log is not None:
                order_log.append(k)
            return res
        finally:
            done[k].set()

    monkeypatch.setattr(stream_mod, "_finish_chunk", reordering)


class _SignallingPlan(faults.FaultPlan):
    """A fault plan that sets ``killed`` as it raises an injected kill."""

    killed: threading.Event

    def hit(self, site):
        try:
            super().hit(site)
        except faults.InjectedKill:
            self.killed.set()
            raise


def test_out_of_order_drain_byte_identical_marks_in_order(sim, tmp_path, monkeypatch):
    """Drain workers finish chunks in reverse order: the output is
    byte-identical and checkpoint marks still commit strictly in chunk
    order, gap-free (the ordered-completion frontier)."""
    import duplexumiconsensusreads_torch.runtime.stream as stream_mod

    path, ref_bytes, _ = sim
    n = _run_port(path, str(tmp_path / "count.bam")).n_chunks
    # a window as wide as the run: every chunk is in flight before the
    # first one may finish
    kw = dict(drain_workers=n, max_inflight=n)
    done_order: list = []
    _force_reverse_drain(monkeypatch, n, done_order)
    marks: list = []
    real_mark = stream_mod.Checkpoint.mark

    def recording_mark(self, chunk, *a, **k):
        marks.append(chunk)
        return real_mark(self, chunk, *a, **k)

    monkeypatch.setattr(stream_mod.Checkpoint, "mark", recording_mark)
    out = str(tmp_path / "ooo.bam")
    rep = _run_port(path, out, **kw)
    assert rep.n_chunks == n >= 3
    assert done_order == list(range(n))[::-1]
    assert marks == list(range(n))
    assert _read(out) == ref_bytes


def test_kill_mid_out_of_order_drain_then_resume_converges(sim, tmp_path, monkeypatch):
    """A hard kill at drain.scatter while workers complete out of order:
    on disk is whatever prefix the frontier made durable, and a resume
    converges to the fault-free bytes."""
    path, ref_bytes, _ = sim
    n = _run_port(path, str(tmp_path / "count.bam")).n_chunks
    kw = dict(drain_workers=n, max_inflight=n)
    out = str(tmp_path / "oookill.bam")
    plan = _SignallingPlan.parse("drain.scatter:2:kill")
    plan.killed = threading.Event()
    with pytest.MonkeyPatch.context() as mp:
        _force_reverse_drain(mp, n, killed=plan.killed)
        faults.install(plan)
        with pytest.raises(faults.InjectedKill):
            _run_port(path, out, **kw)
    faults.uninstall()
    assert plan.killed.is_set()
    assert not os.path.exists(out)  # rename is still terminal-only
    rep = _run_port(path, out, resume=True, **kw)
    assert rep.n_chunks >= 3
    assert _read(out) == ref_bytes
    assert not os.path.exists(out + ".ckpt")


def test_enospc_fails_only_the_victim_job_service_survives(sim, serve_ref, tmp_path):
    """A real ENOSPC from a durable write inside one job (every retry of
    its first shard write) fails THAT job with a durable reason while
    the daemon stays up and the other job completes byte-identical."""
    from duplexumiconsensusreads_torch.serve import ConsensusService, client

    path, _, _ = sim
    spool = str(tmp_path / "spool")
    # one past the host-I/O retry budget; one drain worker keeps every
    # hit on one chunk's ladder
    schedule = ",".join(f"shard.write:{n}:enospc" for n in range(1, 6))
    victim = client.submit(spool, path, str(tmp_path / "victim.bam"),
                           config={**CONFIG, "drain_workers": 1}, chaos=schedule)
    client.submit(spool, path, str(tmp_path / "healthy.bam"), config=dict(CONFIG))
    snap = ConsensusService(spool, chunk_budget=0, device="cpu").run_until_idle()
    assert snap["jobs_failed"] == 1 and snap["jobs_done"] == 1
    st = client.status(spool, victim)
    assert st["state"] == "failed"
    assert "enospc" in st["error"].lower()
    with open(os.path.join(spool, "results", victim + ".json")) as f:
        assert "enospc" in json.load(f)["error"].lower()
    assert not os.path.exists(str(tmp_path / "victim.bam"))
    assert _read(str(tmp_path / "healthy.bam")) == serve_ref


def test_ingest_retry_is_bounded(sim, tmp_path):
    """More consecutive transient failures than the retry budget at one
    site surface the error (as in the JAX run), not loop forever."""
    path, _, _ = sim
    spec = ",".join(f"ingest.read:{n}:oserror" for n in range(1, 6))
    faults.install(faults.FaultPlan.parse(spec))
    with pytest.raises(OSError, match="injected") as terr:
        _run_port(path, str(tmp_path / "x.bam"))
    jax_faults.install(jax_faults.FaultPlan.parse(spec))
    with pytest.raises(OSError, match="injected") as jerr:
        _run_jax(path, str(tmp_path / "jx.bam"))
    assert type(terr.value).__name__ == type(jerr.value).__name__
    assert faults.get_active().n_fired == jax_faults.get_active().n_fired
