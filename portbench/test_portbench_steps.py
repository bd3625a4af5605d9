"""The readers of the program's step clock (lib/step_clock.py and the
six metrics over it), on synthetic read-outs in the form of
``telemetry/steps.py:read()``."""

from __future__ import annotations

import json
import os
import sys
from types import SimpleNamespace

import pytest

from portbench.lib import cell, step_clock

STAGE_METRICS = ("evidence_ms_per_mread", "reduce_ms_per_mread", "consensus_math_ms_per_mread",
                 "cycle_cap_ms_per_mread", "duplex_merge_ms_per_mread")
DUPLEX_ONLY = {"cycle_cap_ms_per_mread", "duplex_merge_ms_per_mread"}


def _entry(mode="replayed", kind="step", calls=10, samples=10, stage_s=None, marked_s=0.0,
           marked_span_s=0.0, cls="duplex/cycle 280x2048x150"):
    return {"kind": kind, "class": cls, "lane": "0:1", "mode": mode, "calls": calls,
            "timed": calls, "span_s": marked_span_s, "samples": samples,
            "stage_s": stage_s or {}, "marked_s": marked_s, "marked_span_s": marked_span_s,
            "stages": list(stage_s or ())}


def _ctx(calls, n_classes=2, lanes=1, pass_reads=2_000_000):
    readout = {"calls": calls, "replays": {"0:1": {"step": 1}}, "pending": 0}
    return SimpleNamespace(state={"step_clock": readout, "classes": [{}] * n_classes,
                                  "mesh": SimpleNamespace(size=lanes), "pass_reads": pass_reads})


def _read(name, ctx):
    return cell.read_metric({"name": name}, ctx)


def test_stage_ms_per_mread_is_stage_time_a_replay_times_replays_over_their_reads():
    a = _entry(calls=10, samples=10, stage_s={"evidence": 1.0, "reduce": 0.2})
    # a class whose replays were half sampled: its sample mean stands for all ten
    b = _entry(calls=10, samples=5, stage_s={"evidence": 0.25, "reduce": 0.05},
               cls="duplex/cycle 12x2048x150")
    eager = _entry(mode="eager", calls=1, samples=1, stage_s={"evidence": 50.0})
    epilogue = _entry(kind="epilogue", calls=10, samples=0)
    ctx = _ctx([a, b, eager, epilogue])
    # 20 replayed calls over 2 calls a pass: 10 passes of 2M reads
    assert _read("evidence_ms_per_mread", ctx) == pytest.approx(
        (1.0 + 0.05 * 10) * 1e3 / (10 * 2.0))
    assert _read("reduce_ms_per_mread", ctx) == pytest.approx((0.2 + 0.01 * 10) * 1e3 / 20)
    # a graph replayed twice a pass (two classes of one key) counts twice
    c = _entry(calls=20, samples=20, stage_s={"evidence": 2.0})
    assert _read("evidence_ms_per_mread", _ctx([c], n_classes=2)) == pytest.approx(
        2.0 * 1e3 / (10 * 2.0))
    # every lane of a class is a call of the pass
    assert _read("evidence_ms_per_mread", _ctx([c], n_classes=1, lanes=2)) == pytest.approx(
        2.0 * 1e3 / (10 * 2.0))


def test_coverage_is_first_to_last_mark_over_the_sampled_spans():
    a = _entry(marked_s=0.9, marked_span_s=1.0, stage_s={"evidence": 0.9})
    b = _entry(marked_s=2.9, marked_span_s=3.0, stage_s={"evidence": 2.9})
    eager = _entry(mode="eager", marked_s=0.1, marked_span_s=1.0, stage_s={"evidence": 0.1})
    assert _read("step_stage_coverage", _ctx([a, b, eager])) == pytest.approx(3.8 / 4.0)


@pytest.mark.parametrize("name", STAGE_METRICS + ("step_stage_coverage",))
def test_nothing_without_a_replayed_step_or_a_stage_sample(name):
    stages = {m.replace("_ms_per_mread", ""): 1.0 for m in STAGE_METRICS}
    ok = _entry(stage_s=stages, marked_s=1.0, marked_span_s=1.0)
    assert _read(name, _ctx([ok])) is not None
    # only eager and captured calls: no replay
    early = [_entry(mode=m, stage_s=stages, marked_s=1.0, marked_span_s=1.0)
             for m in ("eager", "captured")]
    assert _read(name, _ctx(early)) is None
    # a replayed class without a stage sample
    unsampled = _entry(samples=0, cls="duplex/cycle 1x2048x150")
    assert _read(name, _ctx([ok, unsampled])) is None
    # no read-out at all
    assert _read(name, _ctx([])) is None


def test_nothing_from_a_program_without_a_step_clock(monkeypatch):
    # an older checkout of the program: the module is not there
    import duplexumiconsensusreads_torch.telemetry as telemetry

    monkeypatch.setitem(sys.modules, "duplexumiconsensusreads_torch.telemetry.steps", None)
    monkeypatch.delattr(telemetry, "steps", raising=False)
    ctx = SimpleNamespace(state={"classes": [{}], "mesh": SimpleNamespace(size=1),
                                 "pass_reads": 10})
    for name in STAGE_METRICS + ("step_stage_coverage",):
        assert _read(name, ctx) is None
    assert ctx.state["step_clock"] is None


def test_the_read_out_is_read_once_a_run(monkeypatch):
    from duplexumiconsensusreads_torch.telemetry import steps

    reads = []
    monkeypatch.setattr(steps, "read", lambda: reads.append(1) or {"calls": [], "replays": {},
                                                                    "pending": 0})
    ctx = SimpleNamespace(state={})
    for name in STAGE_METRICS:
        assert _read(name, ctx) is None
    assert len(reads) == 1 and step_clock.readout(ctx) == {"calls": [], "replays": {},
                                                           "pending": 0}


def test_the_duplex_only_stages_are_absent_for_the_single_strand_cell():
    with open(os.path.join(cell.CHECKOUT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    ss = {m["name"] for m in cell.metrics_of(bench, "amplicon_ss.resident", True)}
    dx = {m["name"] for m in cell.metrics_of(bench, "ctdna_duplex.resident", True)}
    assert set(STAGE_METRICS) - DUPLEX_ONLY | {"step_stage_coverage"} <= ss
    assert not DUPLEX_ONLY & ss and set(STAGE_METRICS) <= dx
    # and a single-strand read-out has no such stage to read
    single = _entry(cls="single_strand/none 257x2048x150", marked_s=1.0, marked_span_s=1.0,
                    stage_s={"decode": 0.1, "group": 0.1, "evidence": 0.3, "reduce": 0.1,
                             "consensus_math": 0.3, "row_stats": 0.1})
    ctx = _ctx([single], n_classes=1)
    for name in DUPLEX_ONLY:
        assert _read(name, ctx) is None
    for name in set(STAGE_METRICS) - DUPLEX_ONLY:
        assert _read(name, ctx) > 0
    new = [m for m in bench["per_layer"] if m["name"] in DUPLEX_ONLY | set(STAGE_METRICS)
           | {"step_stage_coverage"}]
    assert all(m["layer"] == "fused step" and m["moves"] == "resident_reads_per_s"
               and m["source"] == "program_counter" for m in new) and len(new) == 6
