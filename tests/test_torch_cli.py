"""The torch port's CLI against the JAX package's, on the CPU.

Both CLIs run in process on the same simulated inputs
(``JAX_PLATFORMS=cpu``; the port at ``--device cpu`` or ``--backend
cpu``). Outputs are compared record by record, and the header less its
@PG lines (the program names differ):
- ``runtime/knobs.py``: the table, its order and every accessor equal;
- ``call --backend cpu``: the same NumPy oracle on both sides, so the
  records are identical; ``call`` on ``--device cpu`` with every
  parameter flag is held at the parity bar against the JAX default
  backend;
- ``--config-file``: the precedence flag > file > preset > default
  resolves the same parameters; bad keys and values, and the whole-file
  refusals driven by the knob table, fail with the JAX CLI's words;
  the mesh knobs (``--devices``, ``--mesh``, ``--cycle-shards``) do
  what the JAX CLI does with the same argv, on CPU lanes;
- ``simulate`` (records and truth npz), ``filter`` (each threshold, the
  warning counters, the malformed-record exit), ``validate`` and
  ``stats`` (JSON), and ``group`` (MI tags on both backends): equal.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from chip_smoke import tie_kinds
from duplexumiconsensusreads_tpu.cli.main import main as jax_main
from duplexumiconsensusreads_tpu.io import simulated_bam
from duplexumiconsensusreads_tpu.runtime import executor as jax_executor
from duplexumiconsensusreads_tpu.runtime import knobs as jax_knobs
from duplexumiconsensusreads_tpu.simulate import SimConfig
from duplexumiconsensusreads_torch.cli.main import main as cli_main
from duplexumiconsensusreads_torch.io import read_bam, write_bam
from duplexumiconsensusreads_torch.runtime import executor, knobs


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_cli")
    out = {}
    for name, paired in (("single", False), ("mates", True)):
        p = str(d / f"{name}.bam")
        simulated_bam(
            SimConfig(n_molecules=90, read_len=36, n_positions=8, umi_error=0.02,
                      cycle_error_slope=0.003, duplex=True, paired_reads=paired, seed=11),
            path=p, sort=True,
        )
        out[name] = p
    # a per-base-tag consensus BAM (the oracle's: identical on both sides)
    # and one without the per-base tags, for filter and validate
    for name, extra in (("cons_pb", ["--per-base-tags"]), ("cons", [])):
        out[name] = str(d / f"{name}.bam")
        cli_main(["call", out["single"], "-o", out[name], "--config", "config5",
                  "--backend", "cpu", *extra])
    return d, out


def _strip_pg(header) -> list:
    return [line for line in header.text.splitlines() if not line.startswith("@PG")]


def assert_same_bam(a: str, b: str) -> None:
    ha, ra = read_bam(a)
    hb, rb = read_bam(b)
    assert _strip_pg(ha) == _strip_pg(hb)
    assert (ha.ref_names, ha.ref_lengths) == (hb.ref_names, hb.ref_lengths)
    assert len(ra) == len(rb)
    for f in dataclasses.fields(ra):
        x, y = getattr(ra, f.name), getattr(rb, f.name)
        if isinstance(x, list):
            assert list(x) == list(y), f.name
        else:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=f.name)


def assert_parity(a: str, b: str, duplex: bool) -> int:
    """The parity bar between the JAX output (a) and the port's (b):
    every field identical but seq/qual, bases identical except at ties
    (chip_smoke.tie_kinds: strand evidence ties, ROADMAP Faults 4, and
    strand quals one apart at the Phred floor, Faults 20), quals within
    1 per strand; at most 1 tie cycle in 1,000. Returns the tie
    cycles."""
    ha, ra = read_bam(a)
    hb, rb = read_bam(b)
    assert _strip_pg(ha) == _strip_pg(hb)
    assert len(ra) == len(rb) > 0
    for f in dataclasses.fields(ra):
        if f.name not in ("seq", "qual"):
            x, y = getattr(ra, f.name), getattr(rb, f.name)
            if isinstance(x, list):
                assert list(x) == list(y), f.name
            else:
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=f.name)
    sa, sb = np.asarray(ra.seq), np.asarray(rb.seq)
    qa, qb = np.asarray(ra.qual).astype(int), np.asarray(rb.qual).astype(int)
    tol = 2 if duplex else 1
    dq = np.abs(qa - qb)
    tie = np.logical_or.reduce(list(tie_kinds(sa, sb, qa, qb, tol, duplex).values()))
    assert not ((sa != sb) & ~tie).any(), "bases differ outside a tie"
    assert (np.where(tie, 0, dq) <= tol).all()
    assert tie.sum() * 1000 <= sa.size
    return int(tie.sum())


def _exit_message(fn, argv) -> str:
    with pytest.raises(SystemExit) as e:
        fn(argv)
    return str(e.value)


# ---- runtime/knobs.py

@pytest.mark.parametrize("name", [
    "SURFACES", "KNOB_TABLE", "KNOBS", "knobs_on", "job_config_defaults", "job_choice_map",
    "job_min_int_keys", "streaming_only_keys", "config_file_keys",
])
def test_knobs_equal_jax(name):
    ours, theirs = getattr(knobs, name), getattr(jax_knobs, name)
    if name == "knobs_on":
        for s in knobs.SURFACES:
            assert ours(s) == theirs(s)
        with pytest.raises(ValueError):
            ours("nowhere")
        return
    if callable(ours):
        ours, theirs = ours(), theirs()
    if name == "KNOBS":
        ours = {k: dataclasses.asdict(v) for k, v in ours.items()}
        theirs = {k: dataclasses.asdict(v) for k, v in theirs.items()}
    assert ours == theirs
    if isinstance(ours, dict):
        assert list(ours) == list(theirs)  # the order carries meaning


# ---- simulate

@pytest.mark.parametrize("flags", [
    ["--molecules", "60", "--read-len", "30", "--positions", "6", "--umi-error", "0.02",
     "--sorted", "--seed", "4"],
    ["--molecules", "40", "--read-len", "30", "--paired-reads", "--paired-end",
     "--indel-error", "0.05", "--cycle-error-slope", "0.003", "--umi-len", "8",
     "--family-size", "3", "--max-family-size", "6", "--base-error", "0.02", "--seed", "2"],
    ["--molecules", "30", "--read-len", "24", "--single-strand", "--seed", "9"],
], ids=["duplex-sorted", "paired-reads", "single-strand"])
def test_simulate_equals_jax(tmp_path, flags):
    paths = {}
    for side, fn in (("jax", jax_main), ("port", cli_main)):
        bam, truth = str(tmp_path / f"{side}.bam"), str(tmp_path / f"{side}.npz")
        assert fn(["simulate", "-o", bam, "--truth", truth, *flags]) == 0
        paths[side] = (bam, truth)
    assert_same_bam(paths["jax"][0], paths["port"][0])
    with np.load(paths["jax"][1]) as a, np.load(paths["port"][1]) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ---- call

@pytest.mark.parametrize("which, flags", [
    ("single", ["--config", "config5", "--per-base-tags"]),
    ("mates", ["--config", "config1"]),
    ("mates", ["--config", "config3", "--mate-aware", "on", "--min-input-qual", "10",
               "--min-reads", "2"]),
], ids=["config5-per-base", "config1-mates", "config3-mate-aware"])
def test_call_backend_cpu_equals_jax_exactly(inputs, tmp_path, which, flags):
    """Both CLIs run the same NumPy oracle: identical records."""
    _, paths = inputs
    jout, pout = str(tmp_path / "j.bam"), str(tmp_path / "p.bam")
    argv = ["call", paths[which], *flags, "--backend", "cpu"]
    assert jax_main(argv + ["-o", jout]) == 0
    assert cli_main(argv + ["-o", pout, "--report", str(tmp_path / "r.json")]) == 0
    assert_same_bam(jout, pout)
    rep = json.load(open(tmp_path / "r.json"))
    assert rep["backend"] == "cpu" and rep["device"] == "cpu" and rep["n_buckets"] == 0


@pytest.mark.parametrize("which, flags", [
    ("single", ["--grouping", "cluster", "--mode", "duplex", "--error-model", "cycle",
                "--max-hamming", "2", "--count-ratio", "3", "--min-reads", "2",
                "--min-duplex-reads", "2", "--max-qual", "60", "--max-input-qual", "40",
                "--min-input-qual", "5", "--read-group-id", "RG7", "--capacity", "64"]),
    ("mates", ["--config", "config3", "--mode", "ss", "--grouping", "exact",
               "--per-base-tags", "--max-reads", "5", "--mate-aware", "off"]),
], ids=["every-parameter-flag", "preset-overridden"])
def test_call_flags_within_parity_bar(inputs, tmp_path, which, flags):
    _, paths = inputs
    jout, pout = str(tmp_path / "j.bam"), str(tmp_path / "p.bam")
    argv = ["call", paths[which], *flags]
    assert jax_main(argv + ["-o", jout]) == 0
    assert cli_main(argv + ["-o", pout, "--device", "cpu"]) == 0
    assert_parity(jout, pout, duplex="duplex" in flags)


def _captured_call(monkeypatch, module, fn, argv) -> dict:
    """The parameters a CLI hands its whole-file call (the call itself is
    replaced by a recorder)."""
    seen = {}

    def fake(in_path, out_path, gp, cp, **kw):
        seen.update(kw, grouping=dataclasses.asdict(gp), consensus=dataclasses.asdict(cp))
        return module.RunReport()

    monkeypatch.setattr(module, "call_consensus_file", fake)
    assert fn(argv) == 0
    return {k: seen[k] for k in ("grouping", "consensus", "capacity", "mate_aware",
                                 "max_reads", "per_base_tags", "read_group", "write_index",
                                 "ref_projected", "umi_max_mismatches")}


@pytest.mark.parametrize("conf, flags", [
    ({"config": "config1", "grouping": "cluster", "mode": "duplex", "max_qual": 70,
      "capacity": 64}, []),
    ({"config": "config1", "grouping": "cluster", "mode": "duplex", "max_qual": 70},
     ["--max-qual", "40", "--grouping", "exact", "--config", "config5"]),
    ({"error_model": "none", "min_input_qual": 20, "per_base_tags": True,
      "read_group_id": "Z9", "max_reads": 3}, ["--config", "config5", "--min-input-qual", "0"]),
    ({"count_ratio": 4, "max_hamming": 2, "min_duplex_reads": 2, "max_input_qual": 30,
      "mate_aware": "on", "write_index": True, "umi_max_mismatches": 2}, ["--mode", "duplex"]),
    ("toml", ["--min-reads", "3"]),
], ids=["file-over-preset", "flag-over-file", "falsy-values", "every-other-key", "toml"])
def test_config_file_precedence_equals_jax(inputs, tmp_path, monkeypatch, conf, flags):
    _, paths = inputs
    if conf == "toml":
        path = tmp_path / "c.toml"
        path.write_text('config = "config5"\nmin_reads = 2\nmax_qual = 55\n'
                        'grouping = "exact"\nbackend = "cpu"\n')
    else:
        path = tmp_path / "c.json"
        path.write_text(json.dumps(conf))
    argv = ["call", paths["single"], "-o", str(tmp_path / "o.bam"),
            "--config-file", str(path), *flags]
    theirs = _captured_call(monkeypatch, jax_executor, jax_main, argv)
    ours = _captured_call(monkeypatch, executor, cli_main, argv)
    assert ours == theirs


@pytest.mark.parametrize("conf, flags", [
    ({"gruping": "exact"}, []), ({"grouping": "adjacent"}, []), ({"mode": "dup"}, []),
    ({"error_model": "cycles"}, []), ({"mate_aware": "yes"}, []), ({"config": "config9"}, []),
    ({"capacity": 0}, []), ({"drain_workers": 0}, []), ({"packed": "bits"}, []),
    ({"prefetch_depth": 0}, []), ({"ingest_overlap": "bg"}, []),
    ({"read_group_id": "a b"}, []), ({"max_reads": -1}, []), ({"mesh": "x"}, []),
    ({"mesh": 1, "devices": 2}, []),
    # the whole-file refusals, driven by the table (resolved values)
    ({"packed": "byte"}, []), ({"prefetch_depth": 3}, []), ({"ingest_overlap": "on"}, []),
    ({"mesh": 1}, []), ({}, ["--packed", "off"]), ({}, ["--trace", "t.jsonl"]),
    ({}, ["--heartbeat", "1"]), ({}, ["--heartbeat", "-1"]),
    ({}, ["--chaos", "ckpt.save:1:kill"]), ({}, ["--chunk-reads", "100", "--chaos", "x:y"]),
    ({"ref_projected": True, "chunk_reads": 100}, []),
], ids=lambda v: json.dumps(v) if isinstance(v, dict) else " ".join(v))
def test_config_file_and_flag_refusals_use_the_jax_words(inputs, tmp_path, conf, flags):
    _, paths = inputs
    path = tmp_path / "c.json"
    path.write_text(json.dumps(conf))
    out = str(tmp_path / "o.bam")
    argv = ["call", paths["single"], "-o", out, "--config-file", str(path), *flags]
    theirs = _exit_message(jax_main, argv)
    assert _exit_message(cli_main, argv + ["--device", "cpu"]) == theirs != ""
    assert not os.path.exists(out)


@pytest.mark.parametrize("conf, flags", [
    ({}, ["--devices", "2"]), ({}, ["--mesh", "2", "--chunk-reads", "99"]),
    ({}, ["--devices", "2", "--cycle-shards", "2"]),
    ({"mesh": 4}, []),
    ({"devices": 8}, []),
], ids=lambda v: json.dumps(v) if isinstance(v, dict) else " ".join(v))
def test_mesh_knobs_do_what_the_jax_cli_does(inputs, tmp_path, conf, flags):
    """The mesh knobs, by flag and by config file, with the JAX CLI's
    argv: where the JAX CLI refuses, the port refuses in its words;
    where it runs (on the suite's two virtual devices), the port runs
    the same mesh on CPU lanes and the outputs meet the parity bar.
    ``devices`` 8 is past the JAX suite's two devices (JAX raises
    "requested 8 devices, have 2"), inside the port's 8 CPU lanes: the
    port's output is held against JAX's on its whole pool, and the port
    raises the same words one lane past its own pool."""
    import re

    _, paths = inputs
    path = tmp_path / "c.json"
    path.write_text(json.dumps(conf))
    jout, tout = str(tmp_path / "j.bam"), str(tmp_path / "t.bam")
    argv = ["call", paths["single"], "--config-file", str(path), *flags]
    try:
        jrc = jax_main(argv[:2] + ["-o", jout] + argv[2:])
    except SystemExit as e:
        assert _exit_message(cli_main, argv[:2] + ["-o", tout] + argv[2:]
                             + ["--device", "cpu"]) == str(e) != ""
        assert not os.path.exists(tout)
        return
    except ValueError as e:
        m = re.fullmatch(r"requested (\d+) devices, have (\d+)", str(e))
        assert m, e
        path.write_text(json.dumps({**conf, "devices": int(m.group(2))}))
        jrc = jax_main(argv[:2] + ["-o", jout] + argv[2:])
        past = dict(conf, devices=int(m.group(1)) + 1)
        (tmp_path / "past.json").write_text(json.dumps(past))
        with pytest.raises(ValueError, match=f"requested {past['devices']} devices, have 8"):
            cli_main(["call", paths["single"], "-o", tout, "--config-file",
                      str(tmp_path / "past.json"), "--device", "cpu"])
        path.write_text(json.dumps(conf))
    assert jrc == 0
    assert cli_main(argv[:2] + ["-o", tout] + argv[2:] + ["--device", "cpu"]) == 0
    assert_parity(jout, tout, duplex=False)


@pytest.mark.parametrize("conf, flags, words", [
    ({"backend": "tpu"}, [], "--backend cuda"), ({}, ["--backend", "tpu"], "--backend cuda"),
    ({}, ["--backend", "cpu", "--chunk-reads", "50"], "requires --backend=cuda"),
    ({}, ["--backend", "cpu", "--device", "cuda"], "--device applies to --backend cuda"),
    ({}, ["--resume"], "--resume"), ({"drain_workers": 3}, [], "--drain-workers"),
    ({}, ["--checkpoint", "m.json", "--max-inflight", "4"], "--checkpoint, --max-inflight"),
], ids=lambda v: json.dumps(v) if isinstance(v, dict) else " ".join(v))
def test_unported_and_port_only_refusals_name_the_flag(inputs, tmp_path, conf, flags, words):
    _, paths = inputs
    path = tmp_path / "c.json"
    path.write_text(json.dumps(conf))
    out = str(tmp_path / "o.bam")
    msg = _exit_message(cli_main, ["call", paths["single"], "-o", out, "--config-file",
                                   str(path), *flags])
    assert words in msg
    if "--backend" not in msg and "--device" not in msg:
        assert "not supported by the torch port" in msg
    assert not os.path.exists(out)


@pytest.mark.parametrize("flags", [
    ["--n-hosts", "2", "--host-id", "0"],
    ["--n-hosts", "2", "--host-id", "0", "--index", "x"],
], ids=" ".join)
def test_multihost_flags_refuse_as_the_jax_cli_does(inputs, tmp_path, flags):
    """--n-hosts without --chunk-reads: the JAX CLI's own refusal (the
    multi-host call is parallel/distributed.py's, tests/
    test_torch_distributed.py)."""
    _, paths = inputs
    out = str(tmp_path / "o.bam")
    argv = ["call", paths["single"], "-o", out, *flags]
    theirs = _exit_message(jax_main, argv)
    assert _exit_message(cli_main, argv + ["--device", "cpu"]) == theirs
    assert theirs == "multi-host mode streams: pass --chunk-reads"
    assert not os.path.exists(out)


def test_index_flag_alone_runs_the_call_as_the_jax_cli_does(inputs, tmp_path):
    """--index without --n-hosts is inert on the JAX CLI (only the
    multi-host call reads it): the port runs the same call."""
    from duplexumiconsensusreads_torch.io import read_bam

    _, paths = inputs
    outs = {}
    for name, fn, extra in (("jax", jax_main, []), ("port", cli_main, ["--device", "cpu"])):
        outs[name] = str(tmp_path / f"{name}.bam")
        argv = ["call", paths["single"], "-o", outs[name], "--config", "config3",
                "--index", str(tmp_path / "unused.dlix"), *extra]
        assert fn(argv) == 0
    assert not os.path.exists(str(tmp_path / "unused.dlix"))
    assert len(read_bam(outs["port"])[1]) == len(read_bam(outs["jax"])[1]) > 0


def test_chaos_kills_the_stream_and_resume_finishes_it(inputs, tmp_path):
    """--chaos reaches the streaming executor's fault sites (and is
    uninstalled after the run); --resume then completes the output."""
    from duplexumiconsensusreads_torch.runtime import faults

    _, paths = inputs
    out, ckpt = str(tmp_path / "o.bam"), str(tmp_path / "m.json")
    argv = ["call", paths["single"], "-o", out, "--config", "config5", "--device", "cpu",
            "--chunk-reads", "150", "--checkpoint", ckpt, "--capacity", "128"]
    with pytest.raises(faults.InjectedKill):
        cli_main(argv + ["--chaos", "ckpt.save:3:kill"])
    assert faults.get_active() is None and not os.path.exists(out)
    assert cli_main(argv + ["--resume", "--report", str(tmp_path / "r.json")]) == 0
    rep = json.load(open(tmp_path / "r.json"))
    assert rep["n_chunks_skipped"] >= 1 and rep["n_consensus"] == len(read_bam(out)[1]) > 0


@pytest.mark.parametrize("backend", ["cuda", "cpu"])
def test_whole_file_profile_writes_a_torch_profiler_trace(inputs, tmp_path, backend):
    _, paths = inputs
    prof, rp = tmp_path / "prof", str(tmp_path / "r.json")
    extra = ["--device", "cpu"] if backend == "cuda" else []
    assert cli_main(["call", paths["single"], "-o", str(tmp_path / "o.bam"), "--config",
                     "config3", "--backend", backend, "--profile", str(prof), "--report", rp,
                     *extra]) == 0
    assert json.load(open(prof / "trace.json"))["traceEvents"]
    assert json.load(open(rp))["backend"] == backend


def test_bench_needs_a_card_unless_the_cpu_is_asked_for(monkeypatch):
    """``bench`` runs on the card; without one it raises before any
    work unless ``--device cpu`` asks for the CPU (test_torch_bench.py
    runs that)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("DUT_BENCH_READS", "0")  # restored after the CLI sets it
    for argv in (["bench"], ["bench", "--device", "cuda", "--reads", "100"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli_main(argv)


def test_call_needs_a_card_unless_the_cpu_is_asked_for(inputs, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, paths = inputs
    argv = ["call", paths["single"], "--config", "config1", "-o"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_main(argv + [str(tmp_path / "a.bam")])
    for i, extra in enumerate((["--device", "cpu"], ["--backend", "cpu"])):
        assert cli_main(argv + [str(tmp_path / f"{i}.bam"), *extra]) == 0
    # the f32 pipeline against the f64 oracle: the parity bar
    assert_parity(str(tmp_path / "1.bam"), str(tmp_path / "0.bam"), duplex=False)


# ---- filter

@pytest.mark.parametrize("src, flags", [
    ("cons_pb", ["--min-depth", "6"]), ("cons_pb", ["--min-min-depth", "3"]),
    ("cons_pb", ["--min-mean-qual", "60"]), ("cons_pb", ["--mask-qual", "50"]),
    ("cons_pb", ["--min-base-depth", "4"]),
    ("cons_pb", ["--mask-qual", "40", "--max-n-frac", "0.02"]),
    ("cons_pb", ["--max-base-error-rate", "0.1"]),
    ("cons_pb", ["--max-read-error-rate", "0.005", "--chunk-records", "7"]),
    ("cons", ["--min-base-depth", "2", "--max-base-error-rate", "0.1"]),
], ids=lambda v: v if isinstance(v, str) else " ".join(v))
def test_filter_equals_jax(inputs, tmp_path, capsys, src, flags):
    _, paths = inputs
    outs, errs = {}, {}
    for side, fn in (("jax", jax_main), ("port", cli_main)):
        outs[side] = str(tmp_path / f"{side}.bam")
        capsys.readouterr()
        assert fn(["filter", paths[src], "-o", outs[side], *flags]) == 0
        errs[side] = [line.split("] ", 1)[1] for line in capsys.readouterr().err.splitlines()
                      if "filter:" in line]
    assert_same_bam(outs["jax"], outs["port"])
    # the same counters and warnings (the tool names differ)
    norm = [e.replace("`duplexumi call`", "`call`") for e in errs["jax"]]
    assert norm == errs["port"] and errs["port"]


def test_filter_malformed_record_exits_and_removes_the_output(inputs, tmp_path):
    _, paths = inputs
    header, recs = read_bam(paths["cons"])
    # record 3's cD becomes a float: a non-integer value under the tag
    a = recs.aux_raw[3]
    i = a.index(b"cDi")
    recs.aux_raw[3] = a[:i] + b"cDf" + a[i + 3:]
    bad = str(tmp_path / "bad.bam")
    write_bam(bad, header, recs)
    msgs = []
    for side, fn in (("jax", jax_main), ("port", cli_main)):
        out = str(tmp_path / f"{side}.bam")
        msgs.append(_exit_message(fn, ["filter", bad, "-o", out, "--min-depth", "1"]))
        assert not os.path.exists(out)
    assert msgs[0].split("] ", 1)[1] == msgs[1].split("] ", 1)[1]
    assert "non-integer type 'f'" in msgs[1]


# ---- validate, stats

@pytest.mark.parametrize("argv", [
    ["validate", "CONS", "--truth", "TRUTH", "--json"],
    ["validate", "FILTERED", "--truth", "TRUTH", "--json", "--pos-window", "3"],
    ["stats", "single", "--json", "--grouping", "exact"],
    ["stats", "single", "--json", "--duplex"],
    ["stats", "mates", "--json", "--duplex", "--grouping", "cluster"],
], ids=["validate", "validate-filtered", "stats-exact", "stats-duplex", "stats-cluster-mates"])
def test_validate_and_stats_json_equal_jax(inputs, tmp_path, capsys, argv):
    _, paths = inputs
    if argv[0] == "validate":
        sim, truth = str(tmp_path / "sim.bam"), str(tmp_path / "truth.npz")
        cli_main(["simulate", "-o", sim, "--truth", truth, "--molecules", "60", "--read-len",
                  "30", "--positions", "6", "--umi-error", "0.02", "--sorted", "--seed", "5"])
        cons, filt = str(tmp_path / "c.bam"), str(tmp_path / "f.bam")
        cli_main(["call", sim, "-o", cons, "--config", "config5", "--per-base-tags",
                  "--device", "cpu"])
        cli_main(["filter", cons, "-o", filt, "--min-base-depth", "2",
                  "--max-base-error-rate", "0.1"])
        argv = [{"CONS": cons, "FILTERED": filt, "TRUTH": truth}.get(x, x) for x in argv]
    else:
        argv = [argv[0], paths[argv[1]], *argv[2:]]
    got = []
    for fn in (jax_main, cli_main):
        capsys.readouterr()
        assert fn(argv) == 0
        got.append(json.loads(capsys.readouterr().out.strip().splitlines()[-1]))
    assert got[0] == got[1]
    if argv[0] == "validate":
        assert got[1]["n_matched_to_truth"] > 0 and got[1]["error_rate"] < 0.001


# ---- group

@pytest.mark.parametrize("backend", ["cuda", "cpu"])
@pytest.mark.parametrize("which, flags", [
    ("single", ["--duplex", "--capacity", "64"]),
    ("single", ["--grouping", "exact", "--capacity", "48"]),
    ("single", ["--grouping", "cluster", "--duplex", "--capacity", "64"]),
    ("mates", ["--duplex", "--mate-aware", "on", "--count-ratio", "3", "--capacity", "64"]),
], ids=["adjacency-duplex", "exact", "cluster-duplex", "adjacency-duplex-mates"])
def test_group_mi_equals_jax(inputs, tmp_path, capsys, backend, which, flags):
    _, paths = inputs
    jout, pout = str(tmp_path / "j.bam"), str(tmp_path / "p.bam")
    argv = ["group", paths[which], *flags, "--json"]
    capsys.readouterr()
    assert jax_main(argv + ["-o", jout, "--backend", "tpu" if backend == "cuda" else "cpu"]) == 0
    theirs = json.loads(capsys.readouterr().out)
    extra = ["--device", "cpu"] if backend == "cuda" else []
    assert cli_main(argv + ["-o", pout, "--backend", backend, *extra]) == 0
    ours = json.loads(capsys.readouterr().out)
    assert_same_bam(jout, pout)
    assert any(b"MI" in a for a in read_bam(pout)[1].aux_raw)
    for k in ("n_records", "n_tagged", "n_molecules", "n_families", "grouping", "mate_aware"):
        assert ours[k] == theirs[k], k
    if backend == "cuda":
        assert 0 < ours["group_kernel_launches"] < ours["buckets"]
    # a second pass over the tagged output strips the stale MI first
    again = str(tmp_path / "again.bam")
    assert cli_main(argv + ["-o", again, "--backend", backend, *extra]) == 0
    capsys.readouterr()
    assert cli_main(["group", pout, "-o", str(tmp_path / "a2.bam"), *flags, "--backend",
                     backend, *extra]) == 0
    assert read_bam(str(tmp_path / "a2.bam"))[1].aux_raw == read_bam(again)[1].aux_raw
