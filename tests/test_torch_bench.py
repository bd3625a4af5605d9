"""The torch port's bench against the JAX package's: ``run_bucket``,
the tuner leg, ``benchhist`` and its gate, the ``bench_history`` and
``profile_phases --report`` tools and the profile tools' ablations.
The slow runs of the bench and its tools on the CPU have files of their
own, so that test workers share them: ``test_torch_bench_tiny.py``,
``test_torch_bench_legs.py``, ``test_torch_profile_tools.py`` and
``test_torch_ab_checkouts.py``.

Tolerances are the parity bar's: integer outputs bit-identical, bases
identical except at counted evidence ties (under 1 in 10,000 cycles),
quals within 1 per single-strand consensus and 2 per duplex qual (the
sum of two strand quals). Host-only pieces (the tuner leg, benchhist,
the tools' text) must be equal.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from duplexumiconsensusreads_tpu import benchhist as jax_benchhist
from duplexumiconsensusreads_tpu.bucketing import build_buckets as jax_build_buckets
from duplexumiconsensusreads_tpu.ops import run_bucket as jax_run_bucket
from duplexumiconsensusreads_tpu.runtime.executor import partition_buckets as jax_partition
from duplexumiconsensusreads_tpu.simulate import SimConfig as JaxSimConfig
from duplexumiconsensusreads_tpu.simulate import simulate_batch as jax_simulate
from duplexumiconsensusreads_tpu.types import ConsensusParams as JaxCP
from duplexumiconsensusreads_tpu.types import GroupingParams as JaxGP
from duplexumiconsensusreads_torch import benchhist
from duplexumiconsensusreads_torch.bucketing import build_buckets
from duplexumiconsensusreads_torch.interop import spec_from_fields
from duplexumiconsensusreads_torch.ops import run_bucket
from duplexumiconsensusreads_torch.simulate import SimConfig, simulate_batch
from duplexumiconsensusreads_torch.types import ConsensusParams, GroupingParams

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROUNDS = [os.path.join(REPO, f"BENCH_r0{i}.json") for i in range(1, 6)]
TIE_QUAL = 3  # a strand call at an evidence tie has qual <= 3 (err >= 0.5)
BUCKET_KEYS = ("pos", "umi", "strand_ab", "frag_end", "valid", "bases", "quals", "read_index")


def _fields(spec, **over) -> dict:
    d = {f.name: getattr(spec, f.name) for f in dataclasses.fields(spec)}
    d.update(over)
    return d


def _buckets(config: str):
    """The same simulated batch (numpy seed) bucketed by both packages."""
    duplex_em = {"config3": None, "config5": "cycle"}[config]
    sim = dict(n_molecules=120, read_len=40, n_positions=12, umi_error=0.02,
               cycle_error_slope=0.003, duplex=True, n_frac=0.01, seed=int(config[-1]) + 40)
    gp_kw = dict(strategy="adjacency", paired=True)
    cp_kw = dict(mode="duplex", error_model=duplex_em)
    jb, _ = jax_simulate(JaxSimConfig(**sim))
    pb, _ = simulate_batch(SimConfig(**sim))
    jbk = jax_build_buckets(jb, capacity=256, grouping=JaxGP(**gp_kw))
    pbk = build_buckets(pb, capacity=256, grouping=GroupingParams(**gp_kw))
    assert len(jbk) == len(pbk) >= 3
    for a, b in zip(jbk, pbk):
        for k in BUCKET_KEYS:
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k), err_msg=k)
    return jbk, pbk, JaxGP(**gp_kw), JaxCP(**cp_kw)


@pytest.mark.parametrize("method", ["segment_gemm", "blockseg"])
@pytest.mark.parametrize("config", ["config3", "config5"])
def test_run_bucket_matches_jax(config, method):
    """One host bucket through JAX ``run_bucket`` (dense one-hot
    reduction) and the port's on the CPU (the executors' default
    method, and the CPU's, which the vec-CPU leg runs)."""
    jbk, pbk, gp, cp = _buckets(config)
    n_cyc = n_tie = 0
    ran = 0
    for cbuckets, spec in jax_partition(jbk, gp, cp, ssc_method="matmul"):
        pspec = spec_from_fields(**_fields(spec, ssc_method=method))
        for jb in cbuckets[:2]:
            pb = pbk[next(i for i, b in enumerate(jbk) if b is jb)]
            want = {k: np.asarray(v) for k, v in jax_run_bucket(jb, spec).items()}
            got = run_bucket(pb, pspec, device="cpu")
            assert set(got) == set(want)
            for key, w in want.items():
                g = got[key]
                assert isinstance(g, torch.Tensor) and g.device.type == "cpu", key
                g = g.numpy()
                assert g.shape == w.shape and g.dtype == w.dtype, key
                if key in ("cons_base", "cons_qual"):
                    continue
                np.testing.assert_array_equal(g, w, err_msg=key)
            sa, sb = got["cons_base"].numpy(), want["cons_base"]
            qa, qb = got["cons_qual"].numpy().astype(int), want["cons_qual"].astype(int)
            tie = (sa != sb) & (qa <= 2 * TIE_QUAL) & (qb <= 2 * TIE_QUAL)
            assert not ((sa != sb) & ~tie).any(), "bases differ off an evidence tie"
            assert np.where(tie, 0, np.abs(qa - qb)).max(initial=0) <= 2
            n_tie += int(tie.sum())
            n_cyc += sa.size
            ran += 1
    assert ran >= 2 and n_tie * 10_000 <= n_cyc


def test_run_bucket_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, pbk, gp, cp = _buckets("config3")
    spec = spec_from_fields(grouping=gp, consensus=cp)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_bucket(pbk[0], spec)


def test_default_ssc_method_keys_on_the_device(monkeypatch):
    from duplexumiconsensusreads_torch.runtime import executor

    assert executor.default_ssc_method("cpu") == executor.DEFAULT_SSC_METHOD_CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert executor.default_ssc_method("cuda") == executor.DEFAULT_SSC_METHOD == "segment_gemm"
    _, pbk, gp, cp = _buckets("config3")
    gp, cp = GroupingParams(**vars(gp)), ConsensusParams(**vars(cp))
    # one rule: partition_buckets takes the default of the run's device
    # unless a method is asked for, as the JAX package's does
    for device, want in (("cpu", "blockseg"), ("cuda", "segment_gemm")):
        part = executor.partition_buckets(pbk, gp, cp, device=device)
        assert {spec.ssc_method for _, spec in part} == {want}, device
    part = executor.partition_buckets(pbk, gp, cp, "matmul", device="cpu")
    assert {spec.ssc_method for _, spec in part} == {"matmul"}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        executor.default_ssc_method()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        executor.partition_buckets(pbk, gp, cp)


def test_compute_leg_maps_the_jax_method_names(monkeypatch):
    from duplexumiconsensusreads_torch.benchmark import compute_ssc_method

    dev = torch.device("cpu")
    for jax_name, port_name in (("pallas", "segment_gemm"), ("matmul", "matmul"),
                                ("blockseg", "blockseg"), ("runsum", "runsum")):
        monkeypatch.setenv("DUT_SSC_METHOD", jax_name)
        assert compute_ssc_method(dev) == port_name
    monkeypatch.setenv("DUT_SSC_METHOD", "bogus")
    with pytest.raises(SystemExit, match="unknown method 'bogus'"):
        compute_ssc_method(dev)
    monkeypatch.delenv("DUT_SSC_METHOD")
    assert compute_ssc_method(dev) == "blockseg"


@pytest.mark.parametrize("molecules", ["1500", "4000"])
def test_tuner_leg_equals_jax(monkeypatch, molecules):
    """Host only and deterministic: the dict must be JAX's exactly."""
    from duplexumiconsensusreads_tpu.benchmark import run_bucket_tuner_bench as jax_leg
    from duplexumiconsensusreads_torch.benchmark import run_bucket_tuner_bench

    monkeypatch.setenv("DUT_BENCH_TUNER_MOLECULES", molecules)
    monkeypatch.setenv("DUT_BENCH_CAPACITY", "2048")
    got, want = run_bucket_tuner_bench(), jax_leg()
    assert got == want
    assert got["e2e_fill_factor"] >= got["bucket_tuner_fill_factor_off"]


def test_compact_keys_are_jax_and_each_skip_names_its_item():
    from duplexumiconsensusreads_tpu.benchmark import COMPACT_KEYS as JAX_KEYS
    from duplexumiconsensusreads_torch import benchmark

    assert benchmark.COMPACT_KEYS == JAX_KEYS
    assert benchhist.CANONICAL_METRICS == jax_benchhist.CANONICAL_METRICS
    # every JAX leg runs: no skipped-leg table is left, and the mesh
    # leg's canonical keys are the JAX bench's
    assert not hasattr(benchmark, "SKIPPED_LEGS")
    assert {"e2e_mesh_devices", "e2e_mesh_scaling"} <= set(benchmark.COMPACT_KEYS)


# ---- benchhist against the JAX copy


@pytest.mark.parametrize("tail", [
    'noise\n{"value": 2.5, "mfu": 0.05}\n# journal\n',
    '3.2, "e2e_wire_floor_frac": [0.63, 0.72], "e2e_packed_speedup": 1.163, '
    '"label": "x"}\n# reads=5 journal line\n',
    '{"value": 1}\n"value": 3, "e2e_wall_s": -1.5e2\n{"broken": [1, 2,\n',
    "",
])
def test_salvage_matches_jax(tail):
    assert benchhist.salvage_metrics(tail) == jax_benchhist.salvage_metrics(tail)


@pytest.mark.parametrize("path", ROUNDS, ids=os.path.basename)
def test_load_round_matches_jax_on_the_recorded_rounds(path):
    """Parsing only: the TPU rounds are never a trajectory of the port."""
    assert benchhist.load_round(path) == jax_benchhist.load_round(path)


def _synthetic(tmp_path) -> list[str]:
    docs = [
        {"n": 1, "rc": 0, "tail": "x", "parsed": {"value": 100.0, "e2e_reads_per_sec": 10.0,
                                                 "e2e_wire_floor_frac": [0.2, 0.4]}},
        {"n": 2, "rc": 0, "tail": '12.5, "e2e_reads_per_sec": 4.0, "mfu": 0.01}', "parsed": None},
        {"value": 30.0, "e2e_wall_s": 9.0},
    ]
    paths = []
    for i, d in enumerate(docs, 1):
        p = tmp_path / f"BENCH_torch_r0{i}.json"
        p.write_text(json.dumps(d))
        paths.append(str(p))
    return paths


@pytest.mark.parametrize("threshold", [0.5, 0.8])
def test_trajectory_and_gate_match_jax(tmp_path, threshold):
    paths = _synthetic(tmp_path) + ROUNDS
    for sel in (paths[:3], paths, ROUNDS):
        ours = [benchhist.load_round(p) for p in sel]
        theirs = [jax_benchhist.load_round(p) for p in sel]
        assert benchhist.trajectory(ours) == jax_benchhist.trajectory(theirs)
        assert benchhist.render_table(ours) == jax_benchhist.render_table(theirs)
        for metrics in (None, ["value", "mfu", "e2e_wall_s"]):
            assert (benchhist.check_regression(ours, threshold, metrics)
                    == jax_benchhist.check_regression(theirs, threshold, metrics))
    with pytest.raises(ValueError):
        benchhist.check_regression([], threshold=0)


def test_default_paths_glob_only_the_port_rounds(tmp_path):
    for name in ("BENCH_r01.json", "BENCH_r02.json", "BENCH_torch_r02.json",
                 "BENCH_torch_r01.json", "BENCH_torch_rx.json"):
        (tmp_path / name).write_text("{}")
    assert [os.path.basename(p) for p in benchhist.default_paths(str(tmp_path))] == [
        "BENCH_torch_r01.json", "BENCH_torch_r02.json"]
    assert len(jax_benchhist.default_paths(str(tmp_path))) == 2


def test_bench_gate_ignores_the_tpu_rounds(tmp_path, monkeypatch):
    """A TPU round in the cwd never gates a port run; a port round does."""
    from duplexumiconsensusreads_torch.benchmark import run_bench_gate

    monkeypatch.chdir(tmp_path)
    shutil.copy(ROUNDS[0], tmp_path / "BENCH_r01.json")
    (tmp_path / "BENCH_r02.json").write_text(json.dumps({"value": 1e12}))
    assert run_bench_gate({"value": 1.0}) == (True, [])
    (tmp_path / "BENCH_torch_r01.json").write_text(json.dumps({"value": 100.0}))
    ok, problems = run_bench_gate({"value": 1.0})
    assert not ok and problems[0].startswith("value: current = 1 regressed 99%")
    monkeypatch.setenv("DUT_BENCH_GATE_THRESHOLD", "0.995")
    assert run_bench_gate({"value": 1.0}) == (True, [])


# ---- the tools against the JAX tools


def _jax_tool(name: str):
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        return __import__(name)
    finally:
        sys.path.pop(0)


@pytest.mark.parametrize("flags", [[], ["--json"], ["--check"], ["--check", "--json"],
                                   ["--check", "--threshold", "0.9"],
                                   ["--check", "--metric", "mfu", "--metric", "e2e_wall_s"]],
                         ids=lambda f: " ".join(f) or "table")
def test_bench_history_matches_the_jax_tool(tmp_path, capsys, flags):
    from duplexumiconsensusreads_torch.tools import bench_history

    jax_tool = _jax_tool("bench_history")
    for paths in (ROUNDS, _synthetic(tmp_path), ROUNDS[:2] + ["--candidate", ROUNDS[4]]):
        rc = bench_history.main(paths + flags)
        ours = capsys.readouterr()
        assert rc == jax_tool.main(paths + flags)
        theirs = capsys.readouterr()
        assert ours.out == theirs.out
        assert ours.err == theirs.err


def test_bench_history_usage_errors_match_the_jax_tool(tmp_path, capsys):
    from duplexumiconsensusreads_torch.tools import bench_history

    jax_tool = _jax_tool("bench_history")
    bad = tmp_path / "bad.json"
    bad.write_text("[1, 2]")
    for argv in (["--dir", str(tmp_path)], [str(bad)], [str(tmp_path / "missing.json")]):
        assert bench_history.main(argv) == jax_tool.main(argv) == 2
    capsys.readouterr()
    # the default glob: the port's rounds, never the TPU ones
    shutil.copy(ROUNDS[0], tmp_path / "BENCH_r01.json")
    assert bench_history.main(["--dir", str(tmp_path)]) == 2
    assert "no BENCH_torch_rNN.json files found" in capsys.readouterr().err
    shutil.copy(ROUNDS[0], tmp_path / "BENCH_torch_r01.json")
    assert bench_history.main(["--dir", str(tmp_path), "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["trajectory"]["rounds"] == ["torch_r01"]


@pytest.mark.parametrize("report, rc", [
    ({"seconds": {"ingest": 4.3, "bucketing": 6.7, "dispatch": 28.1, "device_wait_fetch": 22.6,
                 "scatter": 3.0, "deflate": 1.1, "shard_write": 0.4, "ckpt": 0.2,
                 "finalise": 0.3, "total": 21.0, "drain_utilization": 0.81,
                 "main_loop_stall": 3.9, "prefetch_stall": 5.5, "ingest_stall": 10.3,
                 "ingest_backpressure": 0.5}, "n_drain_workers": 2}, 0),
    ({"seconds": {"read_input": 1.2, "bucketing": 0.3, "device_dispatch": 0.8,
                  "write_output": 0.5}}, 0),
    ({"seconds": {"ingest": 1.0, "total": "n/a", "main_loop_stall": None}}, 0),
    ({"seconds": {"ingest": 12.0, "total": 10.0}, "n_drain_workers": True}, 1),
    (["not", "a", "report"], 1),
], ids=["stream", "whole_file", "non_numeric", "busy_over_wall", "not_a_report"])
def test_profile_phases_report_matches_the_jax_tool(tmp_path, capsys, report, rc):
    from duplexumiconsensusreads_torch.tools import profile_phases

    p = tmp_path / "report.json"
    p.write_text(json.dumps(report))
    assert profile_phases.main(["--report", str(p)]) == rc
    ours = capsys.readouterr()
    assert _jax_tool("profile_phases").report_busy_wall(str(p)) == rc
    theirs = capsys.readouterr()
    assert (ours.out, ours.err) == (theirs.out, theirs.err)


def _jax_ablations(spec) -> list:
    """The JAX tools/profile_components.py variants, as its lambdas
    build them."""
    rep = dataclasses.replace
    return [
        ("full", spec),
        ("no_errmodel", rep(spec, consensus=rep(spec.consensus, error_model="none"))),
        ("exact_group", rep(spec, grouping=rep(spec.grouping, strategy="exact"))),
        ("ss_mode", rep(spec, consensus=rep(spec.consensus, mode="single_strand"))),
    ]


def test_profile_component_ablations_are_the_jax_specs():
    """Spec equality through interop, class by class; the one planned
    difference: JAX's "none" (read as no model by its pipeline, refused
    by the port's) is None here."""
    from duplexumiconsensusreads_torch.tools.profile_components import ablations

    jbk, _, gp, cp = _buckets("config5")
    for _, spec in jax_partition(jbk, gp, cp, ssc_method="matmul"):
        ours = ablations(spec_from_fields(**_fields(spec)))
        theirs = _jax_ablations(spec)
        assert [label for label, _ in ours] == [label for label, _ in theirs]
        for (label, o), (_, t) in zip(ours, theirs):
            tf = _fields(t)
            if label == "no_errmodel":
                assert tf["consensus"].error_model == "none" and o.consensus.error_model is None
                tf["consensus"] = dataclasses.replace(tf["consensus"], error_model=None)
            assert o == spec_from_fields(**tf), label


def test_profile_phase_variants_are_the_jax_tools():
    from duplexumiconsensusreads_torch.tools.profile_phases import variants

    adj, exact = JaxGP(strategy="adjacency", paired=True), JaxGP(strategy="exact", paired=True)
    cyc = JaxCP(mode="duplex", error_model="cycle", min_duplex_reads=1)
    none = JaxCP(mode="duplex", error_model=None, min_duplex_reads=1)
    want = [("full config5 (adj+cycle)", adj, cyc), ("no error model (adj)", adj, none),
            ("exact grouping + cycle", exact, cyc), ("exact, no error model", exact, none)]
    got = variants()
    assert [n for n, _, _ in got] == [n for n, _, _ in want]
    for (_, g, c), (_, wg, wc) in zip(got, want):
        assert dataclasses.asdict(g) == dataclasses.asdict(wg)
        assert dataclasses.asdict(c) == dataclasses.asdict(wc)
