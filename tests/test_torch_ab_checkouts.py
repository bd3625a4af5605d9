"""The A/B scripts on the CPU: ``scripts/ab_checkouts.py`` (two
checkouts' bytes in turns) and ``scripts/first_run_split.py`` (a first
streaming run's host split per checkout)."""

from __future__ import annotations

import json
import os
import shutil

import torch


def test_ab_checkouts_compares_two_checkouts_bytes_on_the_cpu(tmp_path, capsys):
    """scripts/ab_checkouts.py on the CPU, this checkout against a copy of
    its port: four turns, identical whole-file and stream bytes (the @PG
    command line included), and no device times; without a card the
    device mode refuses."""
    import importlib.util

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "ab_checkouts", os.path.join(repo, "scripts", "ab_checkouts.py"))
    ab_checkouts = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ab_checkouts)
    shutil.copytree(os.path.join(repo, "duplexumiconsensusreads_torch"),
                    tmp_path / "duplexumiconsensusreads_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    out = tmp_path / "ab.json"
    rc = ab_checkouts.main(["--other", str(tmp_path), "--reads", "4000", "--chunk-reads", "1500",
                            "--device", "cpu", "--json", str(out)])
    assert rc == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["checkout"] for x in lines[:4]] == ["other", "this", "this", "other"]
    summary = json.load(open(out))["summary"]
    assert summary == lines[-1] and summary["outputs_identical"]
    assert "group_kernel_ms" not in summary["this"]
    if not torch.cuda.is_available():
        assert ab_checkouts.main(["--other", str(tmp_path)]) == 2


def test_first_run_split_times_each_checkouts_first_stream_on_the_cpu(tmp_path, capsys):
    """scripts/first_run_split.py on the CPU, this checkout and a copy of
    its port in one round: one turn each, the host split of its first
    streaming run (staging, the step by mode, the fetch; no slots on the
    CPU) and each root's medians."""
    import importlib.util
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, os.path.join(repo, "scripts"))
    try:
        spec = importlib.util.spec_from_file_location(
            "first_run_split", os.path.join(repo, "scripts", "first_run_split.py"))
        split = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(split)
        other = tmp_path / "other"
        shutil.copytree(os.path.join(repo, "duplexumiconsensusreads_torch"),
                        other / "duplexumiconsensusreads_torch",
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        out = tmp_path / "split.json"
        rc = split.main([repo, str(other), "--reads", "3000", "--chunk-reads", "1000",
                         "--rounds", "1", "--device", "cpu", "--json", str(out)])
    finally:
        sys.path.remove(os.path.join(repo, "scripts"))
    assert rc == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["root"] for x in lines[:2]] == [repo, str(other)]
    summary = json.load(open(out))["summary"]
    assert summary == lines[-1] and summary["device"] == "cpu"
    for turn in lines[:2]:
        assert turn["stream_s"] > 0 and turn["stage_s"] > 0 and turn["pipeline_s"] > 0
        assert turn["steps_eager"] >= 3 and "slot_wait_s" not in turn
        assert summary[turn["root"]]["stream_s_turns"] == [turn["stream_s"]]


def test_mesh_profile_summarizes_each_cards_busy_and_idle_time():
    """scripts/mesh_profile.py's reading of a profiler trace: a card's
    busy time is the union of its kernel intervals (overlaps counted
    once), its idle share is over the window from the first to the last
    kernel on any card; a trace with no kernel fails."""
    import importlib.util

    import pytest

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "mesh_profile", os.path.join(repo, "scripts", "mesh_profile.py"))
    mp = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mp)

    def kernel(dev, ts, dur):
        return {"ph": "X", "cat": "kernel", "name": "k", "ts": ts, "dur": dur,
                "args": {"device": dev}}

    trace = {"traceEvents": [
        kernel(0, 0, 100), kernel(0, 50, 100), kernel(0, 400, 100),
        kernel(1, 200, 800),
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 0, "dur": 30},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 40, "dur": 20},
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 5},
    ]}
    got = mp.summarize(trace)
    assert got["window_ms"] == 1.0
    assert got["cards"]["cuda:0"] == {"kernels": 3, "busy_ms": 0.25, "idle_share": 0.75,
                                      "longest_gap_ms": 0.25}
    assert got["cards"]["cuda:1"]["busy_ms"] == 0.8
    assert got["host_ops_ms"] == {"aten::copy_": 0.05}
    with pytest.raises(RuntimeError, match="no device kernel"):
        mp.summarize({"traceEvents": trace["traceEvents"][4:]})
