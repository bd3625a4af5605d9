"""The port's tuning/ and the bucket ladder against the JAX package's.

- Every tuner function on the same group-size sequences: identical
  dicts, verdicts and ValueError texts.
- The verdict store round trip, read by the other package too.
- build_buckets(ladder=...) keeps the read set, on the JAX package's
  bucket geometry.
- The streaming call with the ladder off, on auto and explicit: byte
  identical on the CPU where the output does not depend on the bucket
  composition (single-end reads, no error model), record-equal to the
  JAX streaming call (n_devices=1) under the same ladder for config3 and
  config5, the same tuner_verdict event, and a resume under another
  ladder gives the same bytes. Two ways the output does move with the
  ladder, in both packages alike, are pinned as the faults they are:
  the per-bucket cycle-model fit and the mate-pair numbering.
- The CLI: the streaming call takes --bucket-ladder, the whole-file
  call and a bad value are refused in the JAX CLI's words.
- race_ssc_methods(device="cpu") returns the JAX race's schema, and
  tools/tune_ssc's JSON contract is the JAX tool's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import io
import json
import os
import re

import numpy as np
import pytest

from duplexumiconsensusreads_tpu import tuning as jt
from duplexumiconsensusreads_tpu.bucketing import build_buckets as jax_build_buckets
from duplexumiconsensusreads_tpu.cli.main import main as jax_main
from duplexumiconsensusreads_tpu.io import read_bam as jax_read_bam
from duplexumiconsensusreads_tpu.runtime.stream import stream_call_consensus as jax_stream
from duplexumiconsensusreads_tpu.simulate import SimConfig, simulate_batch
from duplexumiconsensusreads_tpu.types import ConsensusParams as JC
from duplexumiconsensusreads_tpu.types import GroupingParams as JG
from duplexumiconsensusreads_torch import tuning as pt
from duplexumiconsensusreads_torch.bucketing import build_buckets
from duplexumiconsensusreads_torch.cli.main import main as cli_main
from duplexumiconsensusreads_torch.cli.main import params_for
from duplexumiconsensusreads_torch.constants import BASE_N, NO_CALL_QUAL
from duplexumiconsensusreads_torch.io import read_bam, simulated_bam
from duplexumiconsensusreads_torch.runtime import faults
from duplexumiconsensusreads_torch.runtime.stream import stream_call_consensus
from duplexumiconsensusreads_torch.types import GroupingParams

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GP = GroupingParams(strategy="adjacency", paired=True)


def _sequences():
    rng = np.random.default_rng(11)
    tail = np.concatenate([rng.integers(20, 90, 400), rng.integers(900, 1800, 30)])
    rng.shuffle(tail)
    return {
        "long_tail": tail,
        "uniform": np.full(2000, 16),
        "mixed": np.array([40] * 50 + [700] * 4 + [25] * 30),
        "random": rng.integers(1, 512, 200),
        "coalesce": np.full(6000, 5),
        "oversized": np.array([10, 3000, 12, 40, 5000, 7]),
        "empty": np.zeros(0, np.int64),
    }


SEQS = _sequences()


# ---- the tuner functions

@pytest.mark.parametrize("value", [
    "auto", "off", None, "AUTO", " off ", "256,1024", "32, 64 ,128", [64, 512], (2048,),
    "7,13", "512,256", "8", "32,64,128,256,512", "", ",", 12, [64, 64], "a,b", 3.5,
])
def test_normalize_bucket_ladder_equals_jax(value):
    def run(mod):
        try:
            return "ok", mod.normalize_bucket_ladder(value)
        except ValueError as e:
            # "a,b" reaches the message as a generator's repr in both
            # packages (ROADMAP Faults found): its address differs
            return "err", re.sub(r" at 0x[0-9a-f]+", "", str(e))

    assert run(pt) == run(jt)


@pytest.mark.parametrize("ladder", [(64, 256), (256, 64), (24,), (), (32,) * 5, "ab", None])
def test_validate_ladder_equals_jax(ladder):
    def run(mod):
        try:
            return "ok", mod.validate_ladder(ladder)
        except (ValueError, TypeError) as e:
            return type(e).__name__, str(e)

    assert run(pt) == run(jt)


@pytest.mark.parametrize("name", sorted(SEQS))
@pytest.mark.parametrize("pack_mult", [1, 2])
def test_costs_and_verdicts_equal_jax(name, pack_mult):
    sizes = SEQS[name]
    for cap in (256, 1024, 2048):
        assert pt.single_capacity_cost(sizes, cap, pack_mult) == jt.single_capacity_cost(
            sizes, cap, pack_mult)
        assert pt.candidate_ladders(cap) == jt.candidate_ladders(cap)
        for lad in pt.candidate_ladders(cap):
            assert pt.ladder_cost(sizes, lad, pack_mult) == jt.ladder_cost(sizes, lad, pack_mult)
        v = pt.choose_ladder(sizes, cap, pack_mult=pack_mult)
        assert v.to_dict() == jt.choose_ladder(sizes, cap, pack_mult=pack_mult).to_dict()
        assert pt.TunerVerdict.from_dict(v.to_dict()) == v
        assert jt.TunerVerdict.from_dict(v.to_dict()).to_dict() == v.to_dict()
    assert (pt.MAX_RUNGS, pt.MIN_RUNG) == (jt.MAX_RUNGS, jt.MIN_RUNG)


def test_long_tail_picks_a_ladder_and_uniform_keeps_one():
    v = pt.choose_ladder(SEQS["long_tail"], 2048)
    assert len(v.ladder) >= 2 and v.fill_factor > v.fill_factor_off
    assert v.predicted_speedup > 1.0
    u = pt.choose_ladder(SEQS["uniform"], 1024)
    assert u.ladder == (1024,) and u.predicted_speedup == 1.0


@pytest.mark.parametrize("seed", [3, 8])
def test_group_sizes_equal_jax(seed):
    batch, _ = simulate_batch(SimConfig(n_molecules=200, n_positions=30, umi_error=0.02,
                                        duplex=True, seed=seed))
    got = pt.group_sizes(batch)
    np.testing.assert_array_equal(got, jt.group_sizes(batch))
    assert got.sum() == int(np.asarray(batch.valid).sum())


def test_profile_key_equals_jax(tmp_path):
    p = tmp_path / "a.bam"
    p.write_bytes(b"x" * 10)
    for sig in ("sig", "other"):
        assert pt.profile_key(str(p), sig) == jt.profile_key(str(p), sig)
    assert pt.profile_key(str(tmp_path / "missing"), "s") == jt.profile_key(
        str(tmp_path / "missing"), "s")


# ---- the verdict store

def test_verdict_store_round_trip(tmp_path):
    from duplexumiconsensusreads_tpu.tuning import VerdictStore as JaxStore

    path = str(tmp_path / "v.json")
    store = pt.VerdictStore(path)
    assert store.get("k") is None
    v = pt.choose_ladder(SEQS["long_tail"], 2048).to_dict()
    store.put("k", v)
    assert store.get("k") == v and len(store) == 1
    assert JaxStore(path).get("k") == v  # one file format
    with open(path, "w") as f:
        f.write("{not json")
    assert store.get("k") is None
    store.put("k2", {"ladder": [128]})
    assert store.get("k2") == {"ladder": [128]}


def test_verdict_store_is_bounded(tmp_path, monkeypatch):
    from duplexumiconsensusreads_torch.tuning import store as store_mod

    monkeypatch.setattr(store_mod, "MAX_VERDICTS_KEPT", 3)
    store = pt.VerdictStore(str(tmp_path / "v.json"))
    for i in range(5):
        store.put(f"k{i}", {"ladder": [64]})
    assert len(store) == 3 and store.get("k0") is None and store.get("k4") is not None


# ---- build_buckets(ladder=...)

@pytest.mark.parametrize("ladder", [None, (64, 512), (32, 128, 512)])
def test_build_buckets_ladder_keeps_the_read_set(ladder):
    batch, _ = simulate_batch(SimConfig(n_molecules=300, n_positions=40, umi_error=0.02,
                                        duplex=True, seed=3))
    bks = build_buckets(batch, capacity=512, grouping=GP, ladder=ladder)
    jbks = jax_build_buckets(batch, capacity=512, grouping=JG(**vars(GP)), ladder=ladder)
    idx = np.concatenate([b.read_index[b.read_index >= 0] for b in bks])
    assert len(idx) == len(set(idx.tolist())) == int(np.asarray(batch.valid).sum())
    assert [b.capacity for b in bks] == [b.capacity for b in jbks]
    for a, b in zip(bks, jbks):
        np.testing.assert_array_equal(a.read_index, b.read_index)
        if ladder is not None and a.capacity <= 512:
            assert a.capacity in ladder


# ---- the streaming call

@pytest.fixture(scope="module")
def stream_input(tmp_path_factory):
    """Single-end duplex reads at many positions (small position
    groups, so a ladder changes which groups share a bucket), and the
    ladder-off output of the model-free duplex config (config3)."""
    d = tmp_path_factory.mktemp("torch_tuning")
    path = str(d / "in.bam")
    simulated_bam(SimConfig(n_molecules=90, read_len=36, n_positions=40, umi_error=0.02,
                            cycle_error_slope=0.003, duplex=True, seed=31),
                  path=path, sort=True)
    gp, cp, _ = params_for("config3")
    kw = dict(capacity=256, chunk_reads=150)
    ref = str(d / "ref.bam")
    rep = stream_call_consensus(path, ref, gp, cp, device="cpu", drain_workers=1,
                                bucket_ladder="off", **kw)
    assert rep.n_chunks >= 3 and rep.bucket_ladder == []
    with open(ref, "rb") as f:
        return d, path, gp, cp, kw, f.read(), rep


def _compare_jax(jpath, tpath):
    (jh, jr), (th, tr) = jax_read_bam(jpath), read_bam(tpath)
    assert len(jr) == len(tr) > 0
    for f in ("names", "flags", "ref_id", "pos", "lengths"):
        np.testing.assert_array_equal(np.asarray(getattr(jr, f)), np.asarray(getattr(tr, f)))
    assert list(jr.aux_raw) == list(tr.aux_raw)
    sa, sb = np.asarray(jr.seq), np.asarray(tr.seq)
    qa, qb = np.asarray(jr.qual).astype(int), np.asarray(tr.qual).astype(int)
    tie = ((sa == BASE_N) | (sb == BASE_N)) & (qa == NO_CALL_QUAL) & (qb == NO_CALL_QUAL)
    assert not ((sa != sb) & ~tie).any()
    assert np.abs(qa - qb).max() <= 2


def _both(path, d, tag, config, ladder, kw):
    """The port's and the JAX package's streaming call under one ladder:
    (port report, port output, JAX report, JAX output)."""
    gp, cp, _ = params_for(config)
    out, jout = str(d / f"p_{tag}.bam"), str(d / f"j_{tag}.bam")
    rep = stream_call_consensus(path, out, gp, cp, device="cpu", bucket_ladder=ladder, **kw)
    jrep = jax_stream(path, jout, JG(**vars(gp)), JC(**vars(cp)), n_devices=1,
                      bucket_ladder=ladder, **kw)
    assert rep.bucket_ladder == jrep.bucket_ladder
    for f in ("n_rows_real", "n_rows_padded", "n_buckets", "n_consensus", "n_chunks"):
        assert getattr(rep, f) == getattr(jrep, f), f
    _compare_jax(jout, out)
    return rep, out, jrep, jout


@pytest.mark.parametrize("ladder", ["off", "auto", "64,256", (32, 64, 256)])
def test_stream_ladder_byte_identity_and_jax_parity(stream_input, ladder):
    d, path, _, _, kw, ref_bytes, ref_rep = stream_input
    tag = "c3_" + str(ladder).replace(",", "_").replace(" ", "").strip("()")
    rep, out, _, _ = _both(path, d, tag, "config3", ladder, kw)
    with open(out, "rb") as f:
        assert f.read() == ref_bytes
    if ladder == "off":
        assert rep.n_rows_padded == ref_rep.n_rows_padded
    elif ladder == "auto":
        assert rep.bucket_ladder and rep.bucket_ladder[-1] == 256
    else:
        want = [int(x) for x in (ladder.split(",") if isinstance(ladder, str) else ladder)]
        # the ladder really regrouped the buckets
        assert rep.bucket_ladder == want and rep.n_rows_padded < ref_rep.n_rows_padded


@pytest.mark.parametrize("ladder", ["auto", "32,64,256"])
def test_config5_ladder_matches_jax(stream_input, ladder):
    d, path, _, _, kw, _, _ = stream_input
    _both(path, d, "c5_" + ladder.replace(",", "_"), "config5", ladder, kw)


def test_cycle_model_output_moves_with_the_ladder_in_both_packages(stream_input):
    # the cycle error model is fit per bucket in both packages (ROADMAP
    # Faults found): a ladder that regroups the buckets moves config5's
    # quals, the same way on both sides
    d, path, _, _, kw, _, _ = stream_input
    runs = {lad: _both(path, d, "c5m_" + lad.replace(",", "_"), "config5", lad, kw)
            for lad in ("off", "32,64,256")}
    (_, p_off, _, j_off), (_, p_lad, _, j_lad) = runs["off"], runs["32,64,256"]
    for a, b in ((p_off, p_lad), (j_off, j_lad)):
        ra, rb = read_bam(a)[1], read_bam(b)[1]
        assert ra.names == rb.names
        assert not np.array_equal(np.asarray(ra.qual), np.asarray(rb.qual))


def test_mate_pair_names_move_with_the_ladder_in_both_packages(tmp_path):
    # mate-aware runs number consensus pairs in dispatch-class order in
    # both packages (ROADMAP Faults found): a ladder renames pairs
    path = str(tmp_path / "mates.bam")
    simulated_bam(SimConfig(n_molecules=20, read_len=36, n_positions=10, umi_error=0.02,
                            duplex=True, paired_reads=True, seed=31), path=path, sort=True)
    kw = dict(capacity=256, chunk_reads=150)
    names = {}
    for lad in ("off", "32,64,256"):
        _, out, _, jout = _both(path, tmp_path, "m_" + lad.replace(",", "_"), "config3", lad, kw)
        names[lad] = read_bam(out)[1].names
        assert names[lad] == jax_read_bam(jout)[1].names
    assert names["off"] != names["32,64,256"]


def test_explicit_top_rung_replaces_capacity(stream_input):
    # the top rung IS the bucket capacity: a (32, 128) ladder under
    # capacity 256 gives the bytes of the single capacity 128
    d, path, gp, cp, kw, _, _ = stream_input
    out, single = str(d / "top.bam"), str(d / "cap128.bam")
    rep = stream_call_consensus(path, out, gp, cp, device="cpu", bucket_ladder=(32, 128), **kw)
    stream_call_consensus(path, single, gp, cp, device="cpu", **{**kw, "capacity": 128})
    with open(out, "rb") as f, open(single, "rb") as g:
        assert f.read() == g.read()
    assert rep.bucket_ladder == [32, 128]


def test_tuner_verdict_event_equals_jax(stream_input):
    d, path, _, _, kw, _, _ = stream_input
    gp, cp, _ = params_for("config5")
    events = []
    for name, run in (("port", lambda o, t: stream_call_consensus(
            path, o, gp, cp, device="cpu", bucket_ladder="auto", trace_path=t, **kw)),
                      ("jax", lambda o, t: jax_stream(
            path, o, JG(**vars(gp)), JC(**vars(cp)), n_devices=1, bucket_ladder="auto",
            trace_path=t, **kw))):
        trace = str(d / f"v_{name}.jsonl")
        run(str(d / f"v_{name}.bam"), trace)
        evs = [json.loads(line) for line in open(trace)]
        evs = [r for r in evs if r.get("type") == "event" and r.get("name") == "tuner_verdict"]
        assert len(evs) == 1
        events.append({k: v for k, v in evs[0].items() if k not in ("t", "lane")})
    assert events[0] == events[1]
    assert events[0]["chunk"] == 0 and events[0]["ladder"][-1] == 256


def test_resume_under_another_ladder(stream_input):
    d, path, gp, cp, kw, ref_bytes, _ = stream_input
    out = str(d / "killed.bam")
    faults.install(faults.FaultPlan.parse("ckpt.save:3:kill"))
    try:
        with pytest.raises(faults.InjectedKill):
            stream_call_consensus(path, out, gp, cp, device="cpu", bucket_ladder="auto", **kw)
    finally:
        faults.uninstall()
    with open(out + ".ckpt") as f:
        assert len(json.load(f)["done"]) >= 1
    rep = stream_call_consensus(path, out, gp, cp, device="cpu", bucket_ladder="64,256",
                                resume=True, **kw)
    assert rep.n_chunks_skipped >= 1
    with open(out, "rb") as f:
        assert f.read() == ref_bytes


# ---- the CLI

def _exit_message(fn, argv) -> str:
    with pytest.raises(SystemExit) as e:
        fn(argv)
    return str(e.value)


def test_cli_streaming_takes_the_ladder(stream_input):
    d, path, *_ = stream_input
    outs = {}
    for name, extra in (("ladder", ["--bucket-ladder", "32,256"]), ("off", [])):
        outs[name] = str(d / f"cli_{name}.bam")
        assert cli_main(["call", path, "-o", outs[name], "--config", "config3", "--capacity",
                         "256", "--chunk-reads", "150", "--device", "cpu", *extra]) == 0
    a, b = read_bam(outs["ladder"])[1], read_bam(outs["off"])[1]
    assert a.names == b.names and np.array_equal(a.seq, b.seq) and np.array_equal(a.qual, b.qual)


def test_cli_config_file_ladder(stream_input, tmp_path):
    _, path, *_ = stream_input
    conf = tmp_path / "c.json"
    conf.write_text(json.dumps({"config": "config5", "bucket_ladder": "auto",
                                "chunk_reads": 150, "capacity": 256}))
    out = str(tmp_path / "o.bam")
    assert cli_main(["call", path, "-o", out, "--config-file", str(conf), "--device", "cpu",
                     "--report", str(tmp_path / "r.json")]) == 0
    assert json.load(open(tmp_path / "r.json"))["bucket_ladder"][-1] == 256


@pytest.mark.parametrize("argv, conf", [
    (["--bucket-ladder", "auto"], {}),
    (["--bucket-ladder", "256,2048"], {}),
    ([], {"bucket_ladder": "64,2048"}),
    (["--chunk-reads", "90", "--bucket-ladder", "7,9"], {}),
    (["--chunk-reads", "90", "--bucket-ladder", "512,256"], {}),
    ([], {"bucket_ladder": "bogus"}),
])
def test_cli_refusals_in_jax_words(stream_input, tmp_path, argv, conf):
    _, path, *_ = stream_input
    c = tmp_path / "c.json"
    c.write_text(json.dumps(conf))
    out = str(tmp_path / "o.bam")
    full = ["call", path, "-o", out, "--config-file", str(c), *argv]
    # a bad value reaches the message as a generator's repr in both
    # packages (ROADMAP Faults found): its address differs
    theirs = re.sub(r" at 0x[0-9a-f]+", "", _exit_message(jax_main, full))
    assert "bucket-ladder" in theirs
    assert re.sub(r" at 0x[0-9a-f]+", "",
                  _exit_message(cli_main, full + ["--device", "cpu"])) == theirs
    assert not os.path.exists(out)


def test_cli_cosmetic_off_is_not_refused(stream_input, tmp_path):
    # the whole-file gate reads the NORMALISED value: a config-file
    # " OFF " is off (an explicit flag is refused whatever its value,
    # as by the JAX CLI)
    _, path, *_ = stream_input
    conf = tmp_path / "c.json"
    conf.write_text(json.dumps({"bucket_ladder": " OFF "}))
    out = str(tmp_path / "o.bam")
    argv = ["call", path, "-o", out, "--config", "config3", "--capacity", "256",
            "--config-file", str(conf)]
    assert cli_main(argv + ["--device", "cpu"]) == 0 and os.path.exists(out)
    flag = argv[:-2] + ["--bucket-ladder", "off"]
    assert _exit_message(cli_main, flag + ["--device", "cpu"]) == _exit_message(jax_main, flag)


# ---- the race and tune_ssc

def test_race_ssc_methods_on_cpu_returns_the_jax_schema():
    kw = dict(blockseg_ts=(32,), reps=1, n_molecules=60, read_len=24, n_positions=4,
              capacity=64)
    ours = pt.race_ssc_methods(methods=("segment_gemm", "matmul", "blockseg", "runsum"),
                               device="cpu", **kw)
    theirs = jt.race_ssc_methods(methods=("matmul", "blockseg"), **kw)
    assert set(ours) == set(theirs)
    assert ours["backend"] == "cpu" and ours["n_reads"] == theirs["n_reads"]
    assert set(ours["methods"]) == {"segment_gemm", "matmul", "blockseg(T=32)", "runsum"}
    for row in ours["methods"].values():
        assert set(row) == set(next(iter(theirs["methods"].values())))
        assert row["step_s"] > 0 and row["reads_per_sec"] > 0
    assert ours["winner"] in ours["methods"]
    assert ours["winner_method"] == ours["methods"][ours["winner"]]["method"]


def test_race_defaults_leave_out_the_plain_version():
    import inspect

    default = inspect.signature(pt.race_ssc_methods).parameters["methods"].default
    assert default == ("segment_gemm", "matmul", "blockseg", "runsum")
    assert inspect.signature(pt.race_ssc_methods).parameters["device"].default == "cuda"


def test_race_without_a_card_raises(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.race_ssc_methods(n_molecules=10)


def _jax_tune_ssc():
    spec = importlib.util.spec_from_file_location("_jax_tune_ssc",
                                                  os.path.join(REPO, "tools", "tune_ssc.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_tune_ssc_build_result_equals_jax():
    from duplexumiconsensusreads_torch.tools import tune_ssc

    race = {
        "backend": "cuda", "n_reads": 100, "capacity": 128, "reps": 1,
        "methods": {
            "matmul": {"method": "matmul", "blockseg_t": None, "step_s": 0.2,
                       "reads_per_sec": 500.0},
            "blockseg(T=64)": {"method": "blockseg", "blockseg_t": 64, "step_s": 0.1,
                               "reads_per_sec": 1000.0},
        },
        "winner": "blockseg(T=64)", "winner_method": "blockseg",
    }
    assert tune_ssc.build_result(race) == _jax_tune_ssc().build_result(race)


def test_tune_ssc_main_on_cpu(tmp_path):
    from duplexumiconsensusreads_torch.tools import tune_ssc

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = tune_ssc.main(["--device", "cpu", "--methods", "segment_gemm,blockseg",
                            "--blockseg-t", "16,32", "--reps", "1", "--molecules", "40",
                            "--capacity", "64", "--json", str(tmp_path / "r.json")])
    last = json.loads(out.getvalue().strip().splitlines()[-1])
    assert rc == 0 and last == json.load(open(tmp_path / "r.json"))
    assert last["backend"] == "cpu" and last["tool"] == "tune_ssc"
    assert set(last["methods"]) == {"segment_gemm", "blockseg(T=16)", "blockseg(T=32)"}
    assert "winner:" in err.getvalue()


def test_partition_buckets_passes_blockseg_t():
    from duplexumiconsensusreads_torch.runtime.executor import partition_buckets
    from duplexumiconsensusreads_torch.types import ConsensusParams

    batch, _ = simulate_batch(SimConfig(n_molecules=60, n_positions=6, duplex=True, seed=2))
    bks = build_buckets(batch, capacity=128, grouping=GP)
    cp = ConsensusParams(mode="duplex")
    for t, want in ((None, 128), (32, 32)):
        specs = [s for _, s in partition_buckets(bks, GP, cp, "blockseg", blockseg_t=t)]
        assert specs and all(s.blockseg_t == want and s.ssc_method == "blockseg" for s in specs)
    assert dataclasses.replace(specs[0], blockseg_t=8).blockseg_t == 8
