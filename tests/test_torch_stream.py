"""The port's streaming executor against the JAX package's.

- Reader: ``iter_record_chunks`` cuts the same chunks as JAX's.
- Port vs JAX: ``stream_call_consensus(device="cpu")`` against the JAX
  ``stream_call_consensus(n_devices=1)`` with the same chunk_reads and
  capacity (the same chunks and buckets), for config1, config3 and
  config5, single-end and with mates: every RunReport counter equal
  (``device_flops`` excepted: the two engines run different ssc
  methods, whose cost models differ), records equal — names, flags,
  positions, CIGARs, aux tags and bases — with quals within 1 (2 for a
  duplex qual, the sum of two strand quals). The one exception to equal
  bases is the parity bar's tie: a duplex cycle whose two strand quals
  are one apart on one engine and tie on the other is a base there and
  N here, at NO_CALL_QUAL (2) on both sides. File bytes are not
  compared across engines: the deflate codecs differ.
- Invariance: output bytes of the port do not move with drain_workers,
  prefetch_depth, ingest_overlap, packed or d2h_packed.
- Resume: a run killed at a commit site converges, resumed, to the
  uninterrupted run's bytes; transient faults are retried; a manifest
  the JAX package wrote is never resumed here.
- Refusals, the device rule, the CLI and the trace sum-check.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from duplexumiconsensusreads_tpu.io import read_bam as jax_read_bam
from duplexumiconsensusreads_tpu.io import simulated_bam
from duplexumiconsensusreads_tpu.runtime.stream import iter_record_chunks as jax_chunks
from duplexumiconsensusreads_tpu.runtime.stream import stream_call_consensus as jax_stream
from duplexumiconsensusreads_tpu.simulate import SimConfig
from duplexumiconsensusreads_tpu.types import ConsensusParams as JC
from duplexumiconsensusreads_tpu.types import GroupingParams as JG
from duplexumiconsensusreads_torch.cli.main import params_for
from duplexumiconsensusreads_torch.constants import BASE_N, NO_CALL_QUAL
from duplexumiconsensusreads_torch.io import read_bam
from duplexumiconsensusreads_torch.runtime import faults, stream
from duplexumiconsensusreads_torch.runtime.stream import stream_call_consensus

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(capacity=128, chunk_reads=150)
COUNTERS = (
    "n_records", "n_valid_reads", "n_dropped", "n_buckets", "n_families",
    "n_molecules", "n_consensus", "n_consensus_pairs", "n_chunks",
    "n_chunks_skipped", "n_pipeline_compiles", "n_retries", "n_devices",
    "n_mixed_mate_families", "n_downsampled_reads", "mate_aware",
    "ingest_overlap", "n_drain_workers", "bytes_h2d", "bytes_d2h",
    "n_rows_real", "n_rows_padded", "n_mesh_pad_buckets",
)


@pytest.fixture(scope="module")
def bams(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_stream")
    out = {}
    for name, paired in (("single", False), ("mates", True)):
        p = str(d / f"{name}.bam")
        simulated_bam(
            SimConfig(n_molecules=120, read_len=40, n_positions=8, umi_error=0.02,
                      cycle_error_slope=0.003, duplex=True, paired_reads=paired,
                      indel_error=0.02, seed=11),
            path=p, sort=True,
        )
        out[name] = p
    return d, out


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _compare(a, b, duplex: bool):
    assert len(a) == len(b) > 0
    for f in ("names", "flags", "ref_id", "pos", "mapq", "next_ref_id", "next_pos",
              "tlen", "lengths"):
        np.testing.assert_array_equal(np.asarray(getattr(a, f)), np.asarray(getattr(b, f)), err_msg=f)
    assert list(a.cigars) == list(b.cigars)
    assert list(a.aux_raw) == list(b.aux_raw)
    sa, sb = np.asarray(a.seq), np.asarray(b.seq)
    qa, qb = np.asarray(a.qual).astype(int), np.asarray(b.qual).astype(int)
    diff = sa != sb
    # the only base difference allowed: a duplex strand tie (see above)
    tie = ((sa == BASE_N) | (sb == BASE_N)) & (qa == NO_CALL_QUAL) & (qb == NO_CALL_QUAL)
    assert duplex or not diff.any()
    assert not (diff & ~tie).any()
    assert np.abs(qa - qb).max() <= (2 if duplex else 1)


@pytest.mark.parametrize("config, which, opts", [
    ("config1", "single", {}), ("config1", "mates", {}),
    ("config3", "single", {}), ("config3", "mates", {}),
    ("config5", "single", {}), ("config5", "mates", {}),
    # the record-shaping options: family downsampling, the consensus
    # name tag, the @RG id, the provenance line
    ("config5", "mates", dict(max_reads=2, name_tag="h1", read_group="B",
                              provenance_cl="duplexumi call in.bam")),
], ids=lambda v: v if isinstance(v, str) else "-".join(v) or "defaults")
def test_stream_matches_jax_record_by_record(bams, config, which, opts):
    d, paths = bams
    gp, cp, _ = params_for(config)
    tag = f"{config}_{which}_{len(opts)}"
    jout, tout = str(d / f"j_{tag}.bam"), str(d / f"t_{tag}.bam")
    jrep = jax_stream(paths[which], jout, JG(**vars(gp)), JC(**vars(cp)), n_devices=1,
                      **opts, **KW)
    trep = stream_call_consensus(paths[which], tout, gp, cp, device="cpu", **opts, **KW)
    assert trep.n_downsampled_reads == jrep.n_downsampled_reads > 0 or "max_reads" not in opts
    for f in COUNTERS:
        assert getattr(trep, f) == getattr(jrep, f), f
    assert trep.n_chunks >= 3 and trep.mate_aware == (which == "mates")
    jh, jr = jax_read_bam(jout)
    th, tr = read_bam(tout)
    _compare(jr, tr, duplex=cp.mode == "duplex")
    assert th.text.replace("duplexumiconsensusreads_torch", "duplexumiconsensusreads_tpu") == jh.text


@pytest.mark.parametrize("which", ["single", "mates"])
@pytest.mark.parametrize("chunk_reads", [37, 150, 100_000])
def test_record_chunks_match_jax(bams, which, chunk_reads):
    _, paths = bams
    ours = list(stream.iter_record_chunks(paths[which], chunk_reads))
    theirs = list(jax_chunks(paths[which], chunk_reads))
    assert [len(r) for _, r in ours] == [len(r) for _, r in theirs]
    for (_, a), (_, b) in zip(ours, theirs):
        assert a.names == b.names
        np.testing.assert_array_equal(a.pos, b.pos)
        np.testing.assert_array_equal(a.seq, b.seq)


# ---- invariance: scheduling and wire knobs never move output bytes

@pytest.fixture(scope="module")
def reference(bams):
    d, paths = bams
    gp, cp, _ = params_for("config5")
    out = str(d / "ref.bam")
    rep = stream_call_consensus(
        paths["mates"], out, gp, cp, device="cpu", packed="off", d2h_packed="off",
        drain_workers=1, prefetch_depth=1, ingest_overlap="off", max_inflight=1, **KW,
    )
    assert rep.n_chunks >= 3
    return paths["mates"], gp, cp, _read(out), rep


@pytest.mark.parametrize("knobs", [
    dict(drain_workers=3),
    dict(drain_workers=2, max_inflight=8),
    dict(prefetch_depth=2),
    dict(prefetch_depth=3, ingest_overlap="on"),
    dict(ingest_overlap="on"),
    dict(ingest_overlap="auto", drain_workers=2),
    dict(packed="byte"),
    dict(packed="auto"),
    dict(packed="byte", d2h_packed="auto"),
    dict(packed="auto", d2h_packed="auto"),
    dict(packed="auto", d2h_packed="auto", drain_workers=3, prefetch_depth=2,
         ingest_overlap="on", max_inflight=4),
], ids=lambda k: "-".join(f"{a}={b}" for a, b in k.items()))
def test_output_bytes_are_invariant(reference, tmp_path, knobs):
    path, gp, cp, ref_bytes, ref_rep = reference
    base = dict(packed="off", d2h_packed="off", drain_workers=1, prefetch_depth=1,
                ingest_overlap="off", max_inflight=1)
    out = str(tmp_path / "o.bam")
    rep = stream_call_consensus(path, out, gp, cp, device="cpu", **{**base, **knobs}, **KW)
    assert _read(out) == ref_bytes
    assert rep.n_consensus == ref_rep.n_consensus
    assert rep.ingest_overlap is (knobs.get("ingest_overlap", "off") != "off")
    assert rep.n_drain_workers == knobs.get("drain_workers", 1)
    # the wire knobs really move bytes; results never change
    packed = knobs.get("packed", "off")
    assert (rep.bytes_h2d < ref_rep.bytes_h2d) is (packed != "off")
    assert (rep.bytes_d2h < ref_rep.bytes_d2h) is (
        packed != "off" and knobs.get("d2h_packed", "off") != "off")


def test_subbyte_rung_moves_fewer_bytes_than_byte_rung(reference, tmp_path):
    path, gp, cp, ref_bytes, _ = reference
    reps = {}
    for packed in ("byte", "auto"):
        out = str(tmp_path / f"{packed}.bam")
        reps[packed] = stream_call_consensus(path, out, gp, cp, device="cpu",
                                             packed=packed, **KW)
        assert _read(out) == ref_bytes
    assert reps["auto"].bytes_h2d < reps["byte"].bytes_h2d


# ---- checkpoint / resume and fault recovery

@pytest.mark.parametrize("site, nth", [
    ("ckpt.save", 3),  # the fresh-manifest save, then chunk 0's mark
    ("finalise.write", 3),  # header, chunk 0's append, then chunk 1's
    ("shard.write", 3),
])
def test_resume_after_injected_kill_converges(reference, tmp_path, site, nth):
    path, gp, cp, ref_bytes, _ = reference
    out = str(tmp_path / "k.bam")
    faults.install(faults.FaultPlan.parse(f"{site}:{nth}:kill"))
    try:
        with pytest.raises(faults.InjectedKill):
            stream_call_consensus(path, out, gp, cp, device="cpu", **KW)
    finally:
        faults.uninstall()
    assert not os.path.exists(out) and os.path.exists(out + ".ckpt")
    done = json.load(open(out + ".ckpt"))["done"]
    assert len(done) >= 1  # at least one chunk was committed
    rep = stream_call_consensus(path, out, gp, cp, device="cpu", resume=True, **KW)
    assert rep.n_chunks_skipped >= 1
    assert _read(out) == ref_bytes
    assert not os.path.exists(out + ".ckpt") and not os.path.exists(out + ".shards")


def test_transient_faults_are_retried(reference, tmp_path):
    path, gp, cp, ref_bytes, _ = reference
    out = str(tmp_path / "t.bam")
    faults.install(faults.FaultPlan.parse(
        "dispatch.device_put:2:oserror,fetch.result:3:oserror,"
        "drain.scatter:1:io,ingest.read:2:io,fetch.unpack:1:enospc"
    ))
    try:
        rep = stream_call_consensus(path, out, gp, cp, device="cpu", **KW)
    finally:
        faults.uninstall()
    assert rep.n_retries >= 2  # the two device-side faults re-dispatched
    assert _read(out) == ref_bytes


def test_non_retryable_device_error_is_raised_at_once(reference, tmp_path, monkeypatch):
    from duplexumiconsensusreads_torch.ops import pipeline

    path, gp, cp, _, _ = reference
    calls = []

    def broken(*a, **k):
        calls.append(1)
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    def no_backoff(s):
        raise AssertionError(f"a retry backed off {s} s")

    monkeypatch.setattr(pipeline, "fused_pipeline", broken)
    monkeypatch.setattr(stream.time, "sleep", no_backoff)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        stream_call_consensus(path, str(tmp_path / "x.bam"), gp, cp, device="cpu",
                              prefetch_depth=1, max_inflight=1, **KW)
    # chunk 0's classes only: no retry, no per-bucket isolation
    assert 1 <= len(calls) <= 4


def test_jax_manifest_is_not_resumed(bams, tmp_path, monkeypatch):
    _, paths = bams
    gp, cp, _ = params_for("config5")
    ckpt = str(tmp_path / "m.ckpt")
    # same codec on both sides, so only the engine element differs
    monkeypatch.setenv("DUT_NO_NATIVE", "1")
    jax_stream(paths["single"], str(tmp_path / "j.bam"), JG(**vars(gp)), JC(**vars(cp)),
               n_devices=1, checkpoint_path=ckpt, **KW)
    jfp = json.load(open(ckpt))["fingerprint"]
    assert json.load(open(ckpt))["done"]
    out = str(tmp_path / "t.bam")
    rep = stream_call_consensus(paths["single"], out, gp, cp, device="cpu",
                                checkpoint_path=ckpt, resume=True, **KW)
    assert rep.n_chunks_skipped == 0 and rep.n_chunks >= 3
    assert json.load(open(ckpt))["fingerprint"] != jfp
    fresh = str(tmp_path / "f.bam")
    stream_call_consensus(paths["single"], fresh, gp, cp, device="cpu", **KW)
    assert _read(out) == _read(fresh)


# ---- refusals, the device rule, the CLI, the trace

@pytest.mark.parametrize("name, value", [
    ("input_range", (0, 0, None)), ("chunk_base", 4), ("first_read", 10),
    ("follow", True), ("finalize_on", "idle:5"),
    ("live_poll_s", 1.0), ("snapshot_chunks", 2),
    ("devices", (0,)), ("cycle_shards", 2), ("n_devices", 2),
])
def test_unported_options_raise_by_name(bams, tmp_path, name, value):
    _, paths = bams
    gp, cp, _ = params_for("config5")
    with pytest.raises(NotImplementedError, match=name):
        stream_call_consensus(paths["single"], str(tmp_path / "o.bam"), gp, cp,
                              device="cpu", **{name: value})


@pytest.mark.parametrize("knobs, match", [
    (dict(drain_workers=0), "drain_workers"), (dict(prefetch_depth=0), "prefetch_depth"),
    (dict(packed="subbyte"), "packed"), (dict(d2h_packed="on"), "d2h_packed"),
    (dict(ingest_overlap="bg"), "ingest_overlap"), (dict(max_inflight=0), "max_inflight"),
])
def test_invalid_knobs_raise(bams, tmp_path, knobs, match):
    _, paths = bams
    gp, cp, _ = params_for("config5")
    with pytest.raises(ValueError, match=match):
        stream_call_consensus(paths["single"], str(tmp_path / "o.bam"), gp, cp,
                              device="cpu", **knobs)


def test_cuda_default_raises_without_a_card(bams, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, paths = bams
    gp, cp, _ = params_for("config5")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stream_call_consensus(paths["single"], str(tmp_path / "o.bam"), gp, cp, **KW)


def test_trace_spans_sum_to_the_report_and_profile_is_written(reference, tmp_path):
    path, gp, cp, ref_bytes, _ = reference
    out, tr, prof = str(tmp_path / "o.bam"), str(tmp_path / "t.jsonl"), str(tmp_path / "prof")
    rep = stream_call_consensus(path, out, gp, cp, device="cpu", trace_path=tr,
                                profile_dir=prof, heartbeat_s=0.05, **KW)
    assert _read(out) == ref_bytes
    recs = [json.loads(line) for line in open(tr)]
    assert recs[0]["type"] == "meta" and recs[-1]["type"] == "summary"
    sums: dict = {}
    for r in recs:
        if r["type"] == "span":
            sums[r["stage"]] = sums.get(r["stage"], 0.0) + r["dur"]
    for stage, v in sums.items():
        # spans carry 6 decimals, the report 3
        assert abs(v - rep.seconds[stage]) <= 0.0005 + 1e-6 * len(recs), stage
    assert {"ingest", "bucketing", "dispatch", "device_wait_fetch", "scatter",
            "deflate", "shard_write", "ckpt", "finalise"} <= set(sums)
    xfer = [r for r in recs if r["type"] == "xfer"]
    assert sum(r["wire"] for r in xfer if r["dir"] == "h2d") == rep.bytes_h2d
    assert sum(r["wire"] for r in xfer if r["dir"] == "d2h") == rep.bytes_d2h
    assert len([r for r in recs if r["type"] == "dev"]) >= rep.n_chunks
    assert any(r.get("name") == "profile_written" for r in recs)
    assert os.path.exists(os.path.join(prof, "trace.json"))


def test_cli_streams_and_refuses(bams, tmp_path):
    _, paths = bams
    env = dict(os.environ, PYTHONPATH=REPO)
    out = str(tmp_path / "cli.bam")
    cmd = [sys.executable, "-m", "duplexumiconsensusreads_torch", "call", paths["mates"],
           "-o", out, "--config", "config5", "--capacity", "128", "--device", "cpu"]
    r = subprocess.run(cmd + ["--chunk-reads", "150", "--drain-workers", "1",
                              "--packed", "byte", "--report", "-"],
                       capture_output=True, text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stderr
    rep = json.loads(r.stdout)
    assert rep["backend"] == "torch-stream" and rep["n_chunks"] >= 3
    assert rep["n_consensus"] == len(read_bam(out)[1]) > 0
    for extra, what in ((["--resume"], "--resume"), (["--follow"], "--follow")):
        r = subprocess.run(cmd + extra, capture_output=True, text=True, env=env, timeout=120)
        assert r.returncode != 0 and what in r.stderr and "not supported" in r.stderr


def test_config3_stream_matches_the_whole_file_call(bams, tmp_path):
    """Where the reference asserts it (config3, no error model, whose
    per-bucket results do not depend on how chunks cut the buckets):
    the streamed consensus equals the whole-file one per (pos, UMI)."""
    from duplexumiconsensusreads_torch.runtime.executor import call_consensus_file

    _, paths = bams
    gp, cp, _ = params_for("config3")
    s_out, w_out = str(tmp_path / "s.bam"), str(tmp_path / "w.bam")
    rep = stream_call_consensus(paths["single"], s_out, gp, cp, device="cpu", capacity=256,
                                chunk_reads=150)
    call_consensus_file(paths["single"], w_out, gp, cp, capacity=256, device="cpu")
    rs, rw = read_bam(s_out)[1], read_bam(w_out)[1]
    assert rep.n_chunks >= 3 and len(rs) == len(rw) > 0
    key_s = {(int(rs.pos[i]), rs.umi[i]): i for i in range(len(rs))}
    for j in range(len(rw)):
        i = key_s[(int(rw.pos[j]), rw.umi[j])]
        np.testing.assert_array_equal(rs.seq[i], rw.seq[j])
        np.testing.assert_array_equal(rs.qual[i], rw.qual[j])


def test_commit_guard_and_progress_see_chunks_in_order(reference, tmp_path):
    path, gp, cp, ref_bytes, _ = reference
    guarded, progressed = [], []
    rep = stream_call_consensus(
        path, str(tmp_path / "o.bam"), gp, cp, device="cpu", drain_workers=3,
        commit_guard=guarded.append, progress=lambda k, r: progressed.append(k), **KW,
    )
    assert guarded == progressed == list(range(rep.n_chunks))
    assert _read(str(tmp_path / "o.bam")) == ref_bytes

    def fence(k):
        if k == 1:
            raise PermissionError("lease lost")

    out = str(tmp_path / "f.bam")
    with pytest.raises(PermissionError):
        stream_call_consensus(path, out, gp, cp, device="cpu", commit_guard=fence, **KW)
    assert not os.path.exists(out)
    assert list(json.load(open(out + ".ckpt"))["done"]) == ["0"]
