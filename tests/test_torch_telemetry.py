"""The port's capture analysers and tools against the JAX package's.

Every analyser of telemetry/ (report, ledger, devledger, chrome) runs in
both packages on the same captures — the committed fixture
``tests/data/run.fixture.trace.jsonl`` and a capture of the port's
streaming call on the CPU — and must give equal results (the device
ledger with ``peak_flops`` passed explicitly: the two packages' tables
hold different devices). The JAX validator accepts the port's capture.
The device table maps the H100's names and holds no TPU entry. Each
tool (trace_report, check_trace, wirestat, devstat) exits as the JAX
tool of its name does on good and tampered captures, with the same
output.
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys

import pytest
import torch

from duplexumiconsensusreads_tpu.telemetry import chrome as j_chrome
from duplexumiconsensusreads_tpu.telemetry import device as j_device
from duplexumiconsensusreads_tpu.telemetry import devledger as j_devledger
from duplexumiconsensusreads_tpu.telemetry import ledger as j_ledger
from duplexumiconsensusreads_tpu.telemetry import report as j_report
from duplexumiconsensusreads_torch.cli.main import params_for
from duplexumiconsensusreads_torch.io import simulated_bam
from duplexumiconsensusreads_torch.runtime.stream import stream_call_consensus
from duplexumiconsensusreads_torch.simulate import SimConfig
from duplexumiconsensusreads_torch.telemetry import chrome, devledger, ledger, report
from duplexumiconsensusreads_torch.telemetry import device as p_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "data", "run.fixture.trace.jsonl")
PEAK = 66.9e12  # passed to both packages' device ledgers


@pytest.fixture(scope="module")
def port_capture(tmp_path_factory):
    """A traced streaming call of the port on the CPU (config5, the
    ladder on auto, so the capture carries a tuner_verdict event)."""
    d = tmp_path_factory.mktemp("torch_telemetry")
    bam, out, trace = str(d / "in.bam"), str(d / "out.bam"), str(d / "t.jsonl")
    simulated_bam(SimConfig(n_molecules=120, read_len=40, n_positions=8, umi_error=0.02,
                            duplex=True, paired_reads=True, seed=11), path=bam, sort=True)
    gp, cp, _ = params_for("config5")
    stream_call_consensus(bam, out, gp, cp, device="cpu", capacity=128, chunk_reads=150,
                          bucket_ladder="auto", trace_path=trace)
    return trace, out


@pytest.fixture(params=["fixture", "port"])
def capture(request, port_capture):
    path = FIXTURE if request.param == "fixture" else port_capture[0]
    return report.load_trace(path), j_report.load_trace(path)


def test_both_validators_accept_both_captures(capture):
    ours, theirs = capture
    assert ours == theirs
    assert report.validate_trace(ours) == j_report.validate_trace(theirs) == []
    assert report.capture_kind(ours) == j_report.capture_kind(theirs) == "run"


def test_port_capture_is_a_full_ledger(port_capture):
    recs = report.load_trace(port_capture[0])
    kinds = {r["type"] for r in recs}
    assert {"meta", "span", "event", "xfer", "dev", "summary"} <= kinds
    assert any(r.get("name") == "tuner_verdict" for r in recs)


@pytest.mark.parametrize("fn", [
    "sum_check", "stage_stats", "lane_utilization", "chunk_critical_paths",
    "chunk_latency_percentiles", "render_report", "wall_seconds", "summary_record",
])
def test_report_functions_equal(capture, fn):
    ours, theirs = capture
    assert getattr(report, fn)(ours) == getattr(j_report, fn)(theirs)


@pytest.mark.parametrize("fn", [
    "byte_totals", "wire_floor", "packing_stats", "fill_stats", "bandwidth_stats",
    "per_chunk_bytes", "summary_bytes", "sum_check_bytes", "overlap_stats", "device_lanes",
])
def test_ledger_functions_equal(capture, fn):
    ours, theirs = capture
    assert getattr(ledger, fn)(ours) == getattr(j_ledger, fn)(theirs)


def test_output_check_equal(port_capture):
    trace, out = port_capture
    recs = report.load_trace(trace)
    got = ledger.output_check(recs)
    assert got == j_ledger.output_check(recs) and got[1]
    assert ledger.output_check(recs, out_path=out) == j_ledger.output_check(recs, out_path=out)


@pytest.mark.parametrize("fn", [
    "class_stats", "device_totals", "roofline", "compile_stats", "sum_check_dev",
    "wire_bandwidth",
])
def test_devledger_functions_equal(capture, fn):
    ours, theirs = capture
    kw = {"peak_flops": PEAK} if fn in ("class_stats", "device_totals", "roofline") else {}
    got = getattr(devledger, fn)(ours, **kw)
    assert got == getattr(j_devledger, fn)(theirs, **kw)
    if fn == "roofline" and got:
        assert got["peak_entry"] == "caller"


def test_chrome_export_equal(capture, tmp_path):
    ours, theirs = capture
    assert chrome.to_chrome(ours) == j_chrome.to_chrome(theirs)
    n = chrome.write_chrome(ours, str(tmp_path / "p.json"))
    assert n == j_chrome.write_chrome(theirs, str(tmp_path / "j.json"))
    assert open(tmp_path / "p.json").read() == open(tmp_path / "j.json").read()


def test_port_capture_sum_checks_pass(port_capture):
    recs = report.load_trace(port_capture[0])
    assert report.sum_check(recs)[1]
    assert ledger.sum_check_bytes(recs)[1]
    assert devledger.sum_check_dev(recs)[1]
    assert ledger.fill_stats(recs).get("sum_check_ok", True)
    assert 0 < ledger.wire_floor(recs)["frac"] <= 1


# ---- the device table

@pytest.mark.parametrize("name, entry, tflops", [
    ("NVIDIA H100 80GB HBM3", "h100-sxm-f32", 66.9),
    ("NVIDIA H100 PCIe", "h100-pcie-f32", 51.2),
    ("nvidia h100 pcie", "h100-pcie-f32", 51.2),
    ("NVIDIA A100-SXM4-80GB", "default-h100-sxm-f32", 66.9),
    ("TPU v5 lite", "default-h100-sxm-f32", 66.9),
    ("TPU v4", "default-h100-sxm-f32", 66.9),
    ("cpu", "default-h100-sxm-f32", 66.9),
])
def test_device_table_resolves_cuda_names(monkeypatch, name, entry, tflops):
    monkeypatch.delenv("DUT_PEAK_TFLOPS", raising=False)
    assert p_device.device_peak_flops(name) == (tflops * 1e12, entry)


def test_device_table_holds_no_tpu_entry():
    for entry, needles, _ in p_device.PEAK_TFLOPS_TABLE:
        for word in ("v5", "v4", "tpu", "cpu"):
            assert word not in entry and not any(word in n for n in needles)
    tpu_numbers = {t for _, _, t in j_device.PEAK_TFLOPS_TABLE}
    assert not tpu_numbers & {t for _, _, t in p_device.PEAK_TFLOPS_TABLE}
    assert p_device.DEFAULT_PEAK[1] not in tpu_numbers


def test_device_env_override_wins(monkeypatch):
    monkeypatch.setenv("DUT_PEAK_TFLOPS", "12.5")
    assert p_device.device_peak_flops("NVIDIA H100 80GB HBM3") == (12.5e12, "env:12.5T")
    assert p_device.device_peak_flops() == (12.5e12, "env:12.5T")


def test_device_without_a_card_takes_the_named_default(monkeypatch):
    monkeypatch.delenv("DUT_PEAK_TFLOPS", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_name(*_):
        raise AssertionError("asked a device name without a device")

    monkeypatch.setattr(torch.cuda, "get_device_name", no_name)
    assert p_device.device_peak_flops() == (66.9 * 1e12, "default-h100-sxm-f32")
    # the analysers resolve through it when no peak is passed
    recs = report.load_trace(FIXTURE)
    assert devledger.device_totals(recs) == {}


@pytest.mark.parametrize("x", [0.0, 1e-7, 0.123456, 3.14159e-3, -2.5e-5])
def test_round_mfu_equal(x):
    assert p_device.round_mfu(x) == j_device.round_mfu(x)


# ---- the tools: the JAX tools' flags, output and exit codes

TOOLS = ("trace_report", "check_trace", "wirestat", "devstat")


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"_jax_{name}", os.path.join(REPO, "tools",
                                                                                f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port_tool(name):
    return importlib.import_module(f"duplexumiconsensusreads_torch.tools.{name}")


def _run(mod, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = mod.main(argv)
    return rc, out.getvalue(), err.getvalue()


def _tamper(src, dst, pick, change):
    done = False
    with open(src) as f, open(dst, "w") as g:
        for line in f:
            rec = json.loads(line)
            if not done and pick(rec):
                change(rec)
                done = True
            g.write(json.dumps(rec) + "\n")
    assert done
    return dst


def _tampered(trace, tmp_path):
    """One tampered copy per kind of corruption, with the tool that
    must refuse it and the words it prints."""
    t = str(tmp_path)
    return {
        "xfer_wire": ("wirestat", "BYTE LEDGER DRIFT", _tamper(
            trace, t + "/wire.jsonl",
            lambda r: r.get("type") == "xfer" and r.get("dir") == "shard",
            lambda r: r.update(wire=r["wire"] + 12345))),
        "dev_dur": ("devstat", "DEVICE LEDGER DRIFT", _tamper(
            trace, t + "/dur.jsonl", lambda r: r.get("type") == "dev",
            lambda r: r.update(dur=round(r["dur"] + 1.5, 6)))),
        "dev_flops": ("devstat", "flops", _tamper(
            trace, t + "/flops.jsonl", lambda r: r.get("type") == "dev",
            lambda r: r.update(flops=-1.0))),
        "span_dur": ("trace_report", "TRACE/REPORT MISMATCH", _tamper(
            trace, t + "/span.jsonl",
            lambda r: r.get("type") == "span" and r.get("stage") == "scatter",
            lambda r: r.update(dur=round(r["dur"] + 1.5, 6)))),
        "bad_stage": ("check_trace", "unknown span stage", _tamper(
            trace, t + "/stage.jsonl", lambda r: r.get("type") == "span",
            lambda r: r.update(stage="bogus"))),
        "float_wire": ("check_trace", "wire", _tamper(
            trace, t + "/fwire.jsonl", lambda r: r.get("type") == "xfer",
            lambda r: r.update(wire=1.5))),
    }


@pytest.mark.parametrize("tool", TOOLS)
@pytest.mark.parametrize("which", ["fixture", "port"])
def test_tool_exits_and_output_equal_jax(port_capture, tool, which, monkeypatch):
    monkeypatch.delenv("DUT_PEAK_TFLOPS", raising=False)
    trace = FIXTURE if which == "fixture" else port_capture[0]
    extra = ["--peak-tflops", "66.9"] if tool == "devstat" else []
    for flags in ([], ["--json"]) if tool != "check_trace" else ([], ["--require-summary"]):
        got = _run(_port_tool(tool), [trace, *flags, *extra])
        want = _run(_jax_tool(tool), [trace, *flags, *extra])
        assert got == want and got[0] == 0, (tool, flags, got[2])


@pytest.mark.parametrize("case", ["xfer_wire", "dev_dur", "dev_flops", "span_dur",
                                  "bad_stage", "float_wire"])
def test_tool_refuses_its_tampered_capture(port_capture, tmp_path, case):
    tool, words, path = _tampered(port_capture[0], tmp_path)[case]
    rc, _, err = _run(_port_tool(tool), [path, *(["--peak-tflops", "66.9"]
                                                 if tool == "devstat" else [])])
    assert rc == 1 and words in err, err
    assert _run(_jax_tool(tool), [path, *(["--peak-tflops", "66.9"]
                                          if tool == "devstat" else [])])[0] == 1


def test_wirestat_refuses_a_grown_output(port_capture, tmp_path):
    trace, out = port_capture
    grown = str(tmp_path / "grown.bam")
    with open(out, "rb") as f, open(grown, "wb") as g:
        g.write(f.read() + b"\0")
    rc, _, err = _run(_port_tool("wirestat"), [trace, "--out", grown])
    assert rc == 1 and "BYTE LEDGER DRIFT" in err
    assert _run(_jax_tool("wirestat"), [trace, "--out", grown])[0] == 1
    assert _run(_port_tool("wirestat"), [trace, "--out", out])[0] == 0


def test_trace_report_chrome_counters(port_capture, tmp_path):
    p = str(tmp_path / "p.json")
    rc, _, _ = _run(_port_tool("trace_report"), [port_capture[0], "--chrome", p])
    doc = json.load(open(p))
    assert rc == 0
    names = {e["name"] for e in doc["traceEvents"] if e.get("ph") == "C"}
    assert any(n.startswith("h2d_bytes (xfer-") for n in names)
    assert any(n.startswith("device_gflops_s (c") for n in names)


def test_devstat_resolves_the_device_table(port_capture, monkeypatch):
    monkeypatch.delenv("DUT_PEAK_TFLOPS", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, out, _ = _run(_port_tool("devstat"), [port_capture[0], "--json"])
    doc = json.loads(out)
    assert rc == 0 and doc["peak_entry"] == "default-h100-sxm-f32"
    assert doc["peak_flops"] == 66.9 * 1e12 and doc["sum_check"]["ok"]


def test_tools_run_as_modules(port_capture):
    # the ``python -m`` entry point (one process; the other tools share
    # the same __main__ shape)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "-m", "duplexumiconsensusreads_torch.tools.wirestat", port_capture[0]],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=300,
    )
    assert r.returncode == 0, r.stderr
    assert "byte sum-check" in r.stdout and "output check: OK" in r.stdout


def test_each_dispatched_class_gets_its_own_dev_record(tmp_path, monkeypatch):
    """ROADMAP Faults 21: under a bucket ladder a chunk can hold two
    classes of different capacities with the same PipelineSpec (the
    spec does not carry the capacity). With every class dispatched
    before the drain fetches the first (a synchronous transfer pool, as
    on the card where dispatch runs ahead), each class still gets its
    own dev record: its capacity, its buckets, its dispatch seconds and
    its fetch window, and the device sum-check holds."""
    from concurrent.futures import Future, ThreadPoolExecutor

    from duplexumiconsensusreads_torch.bucketing import build_buckets
    from duplexumiconsensusreads_torch.io import read_bam, records_to_readbatch
    from duplexumiconsensusreads_torch.runtime import stream
    from duplexumiconsensusreads_torch.runtime.executor import partition_buckets

    class InlinePool(ThreadPoolExecutor):
        def submit(self, fn, *args, **kwargs):
            f = Future()
            try:
                f.set_result(fn(*args, **kwargs))
            except BaseException as e:  # surfaced where the drain reads it
                f.set_exception(e)
            return f

    def pool(max_workers=None, thread_name_prefix=""):
        cls = InlinePool if thread_name_prefix == "dut-xfer" else ThreadPoolExecutor
        return cls(max_workers=max_workers, thread_name_prefix=thread_name_prefix)

    bam, trace = str(tmp_path / "in.bam"), str(tmp_path / "t.jsonl")
    simulated_bam(SimConfig(n_molecules=600, read_len=30, n_positions=30, mean_family_size=4,
                            umi_error=0.01, duplex=True, seed=0), path=bam, sort=True)
    gp, cp, _ = params_for("config3")
    batch, _ = records_to_readbatch(read_bam(bam)[1], duplex=True)
    classes = partition_buckets(build_buckets(batch, capacity=512, grouping=gp,
                                              ladder=(128, 256, 512)),
                                gp, cp, packed_io=True, device="cpu")
    specs = [spec for _, spec in classes]
    assert len(set(specs)) < len(specs)  # two capacities share a spec
    monkeypatch.setattr(stream, "ThreadPoolExecutor", pool)
    stream_call_consensus(bam, str(tmp_path / "o.bam"), gp, cp, device="cpu", capacity=512,
                          chunk_reads=100_000, bucket_ladder="128,256,512", trace_path=trace)
    recs = [json.loads(line) for line in open(trace)]
    dev = sorted((r["chunk"], r["cap"], r["buckets"]) for r in recs if r.get("type") == "dev")
    # one H2D record per dispatched class, with its capacity and rows
    h2d = sorted((r["chunk"], r["cap"], r["rows_pad"] // r["cap"]) for r in recs
                 if r.get("type") == "xfer" and r.get("dir") == "h2d")
    assert dev == h2d and len({cap for _, cap, _ in dev}) == 3
    assert devledger.sum_check_dev(recs)[1]
