"""Mesh-sharded streaming in the torch port, on CPU lanes.

The JAX package's tests/test_mesh.py, ported: output bytes must not
move with the device count, the device subset or the wire rungs. The
byte-identity matrix pins {1, 2, 8} lanes x {packed D2H auto/off} x
{bucket ladder off/auto} against the port's one-lane fully-unpacked
reference, and the two-lane run against the JAX package's
``stream_call_consensus(n_devices=2)`` on the suite's two virtual
devices, record for record (the parity bar of tests/test_torch_stream.py;
file bytes are not compared across engines: the deflate codecs differ).

Also: device-subset pinning, the per-device byte ledger (dev-N lanes,
mesh_pad sums, mesh_h2d spans, the port's trace_report and wirestat
green, a tampered mesh_pad caught), kill/resume convergence on two
lanes and a two-lane resume of a one-lane checkpoint, the serve
``mesh`` job config, the CLI's ``--mesh`` and its whole-file refusal,
and the daemon's ``--devices`` parsing. Lanes here are logical lanes of
the CPU (parallel/mesh.py); the card runs the same path in
chip_smoke.py's mesh phase.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from duplexumiconsensusreads_tpu.io import read_bam as jax_read_bam
from duplexumiconsensusreads_tpu.io import simulated_bam
from duplexumiconsensusreads_tpu.runtime.stream import stream_call_consensus as jax_stream
from duplexumiconsensusreads_tpu.simulate import SimConfig
from duplexumiconsensusreads_tpu.types import ConsensusParams as JC
from duplexumiconsensusreads_tpu.types import GroupingParams as JG
from duplexumiconsensusreads_torch.io import read_bam
from duplexumiconsensusreads_torch.runtime import faults
from duplexumiconsensusreads_torch.runtime.stream import stream_call_consensus
from duplexumiconsensusreads_torch.telemetry import ledger, report
from duplexumiconsensusreads_torch.types import ConsensusParams, GroupingParams

from test_torch_stream import COUNTERS, _compare

GP = GroupingParams(strategy="adjacency", paired=True)
CP = ConsensusParams(mode="duplex")
KW = dict(capacity=128, chunk_reads=96, device="cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2")


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def mesh_sim(tmp_path_factory):
    """Sorted sim input (the JAX test's) + the one-lane fully-unpacked
    reference."""
    d = tmp_path_factory.mktemp("torch_mesh")
    path = str(d / "in.bam")
    simulated_bam(
        SimConfig(n_molecules=70, n_positions=10, umi_error=0.02, seed=52),
        path=path, sort=True,
    )
    ref = str(d / "ref.bam")
    rep = stream_call_consensus(path, ref, GP, CP, n_devices=1, packed="off",
                                d2h_packed="off", **KW)
    assert rep.n_chunks >= 3  # the matrix must cross chunk boundaries
    return path, _read(ref), rep


@pytest.mark.parametrize("ladder", ["off", "auto"])
@pytest.mark.parametrize("d2h", ["auto", "off"])
@pytest.mark.parametrize("n_dev", [1, 2, 8])
def test_byte_identity(mesh_sim, tmp_path, n_dev, d2h, ladder):
    path, ref_bytes, ref_rep = mesh_sim
    out = str(tmp_path / f"{n_dev}_{d2h}_{ladder}.bam")
    rep = stream_call_consensus(path, out, GP, CP, n_devices=n_dev, d2h_packed=d2h,
                                bucket_ladder=ladder, **KW)
    assert _read(out) == ref_bytes
    assert rep.n_devices == n_dev
    assert rep.n_consensus == ref_rep.n_consensus
    if n_dev == 1:
        assert rep.n_mesh_pad_buckets == 0
    else:
        # tiny chunks against a wide mesh: padding is real and counted
        assert rep.n_mesh_pad_buckets > 0


@pytest.mark.parametrize("d2h", ["auto", "off"])
def test_two_lanes_match_jax_two_devices_record_by_record(mesh_sim, tmp_path, d2h):
    """The port's two-lane run against JAX's on the suite's two virtual
    devices: every RunReport counter equal (the byte ledger's
    bytes_h2d/bytes_d2h and the mesh pad included: the per-device
    packed D2H wire is JAX's shard_map wire), records at the parity
    bar."""
    path, _, _ = mesh_sim
    jout, tout = str(tmp_path / "j.bam"), str(tmp_path / "t.bam")
    jrep = jax_stream(path, jout, JG(**vars(GP)), JC(**vars(CP)), n_devices=2,
                      d2h_packed=d2h, capacity=KW["capacity"], chunk_reads=KW["chunk_reads"])
    trep = stream_call_consensus(path, tout, GP, CP, n_devices=2, d2h_packed=d2h, **KW)
    assert jrep.n_devices == trep.n_devices == 2
    for f in COUNTERS:
        assert getattr(trep, f) == getattr(jrep, f), f
    _, jr = jax_read_bam(jout)
    _, tr = read_bam(tout)
    _compare(jr, tr, duplex=True)


def test_device_subset_pinning(mesh_sim, tmp_path):
    """``devices=`` (the daemon's --devices pinning) runs the mesh on an
    index subset of the pool: bytes identical, bad indices loud."""
    path, ref_bytes, _ = mesh_sim
    out = str(tmp_path / "pin.bam")
    rep = stream_call_consensus(path, out, GP, CP, devices=[1, 0], **KW)
    assert rep.n_devices == 2
    assert _read(out) == ref_bytes
    with pytest.raises(ValueError, match="out of range"):
        stream_call_consensus(path, str(tmp_path / "x.bam"), GP, CP, devices=[0, 99], **KW)
    with pytest.raises(ValueError, match="repeats"):
        stream_call_consensus(path, str(tmp_path / "x.bam"), GP, CP, devices=[1, 1], **KW)
    with pytest.raises(ValueError, match="requested 9 devices, have 8"):
        stream_call_consensus(path, str(tmp_path / "x.bam"), GP, CP, n_devices=9, **KW)


def test_eight_lanes_equal_one_in_one_process(mesh_sim, tmp_path):
    """The JAX test's eight-device subprocess leg: the port needs no
    fresh interpreter for eight lanes, so both runs share one process
    (and one @PG line) and are compared byte for byte, under the
    sub-byte H2D rung and the cycle error model as well."""
    path, _, _ = mesh_sim
    cp5 = ConsensusParams(mode="duplex", error_model="cycle")
    outs = {}
    for n in (8, 1):
        outs[n] = str(tmp_path / f"o{n}.bam")
        rep = stream_call_consensus(path, outs[n], GP, cp5, n_devices=n, packed="auto", **KW)
        assert rep.n_devices == n and (rep.n_mesh_pad_buckets > 0) == (n > 1)
    assert _read(outs[8]) == _read(outs[1])


def test_cycle_lanes_stream_byte_identical(mesh_sim, tmp_path):
    """A ('data', 'cycle') mesh through the streaming executor: the
    per-cycle lanes and the host join give the one-lane bytes, at every
    H2D rung (the sub-byte rung's bit planes split on byte
    boundaries)."""
    path, ref_bytes, _ = mesh_sim
    for packed in ("auto", "byte", "off"):
        out = str(tmp_path / f"c_{packed}.bam")
        rep = stream_call_consensus(path, out, GP, CP, n_devices=4, cycle_shards=2,
                                    packed=packed, **KW)
        assert rep.n_devices == 4
        assert _read(out) == ref_bytes, packed


# ---- the per-device ledger

@pytest.fixture(scope="module")
def traced_mesh(mesh_sim, tmp_path_factory):
    """One traced two-lane run: the per-device ledger under test."""
    path, ref_bytes, _ = mesh_sim
    d = tmp_path_factory.mktemp("torch_meshtrace")
    out = str(d / "out.bam")
    trace = str(d / "trace.jsonl")
    rep = stream_call_consensus(path, out, GP, CP, n_devices=2, trace_path=trace, **KW)
    assert _read(out) == ref_bytes
    records = report.load_trace(trace)
    assert not report.validate_trace(records)
    return records, rep, trace


def test_per_device_lanes_and_mesh_pad_sums(traced_mesh):
    records, rep, _ = traced_mesh
    xf = ledger.xfer_records(records)
    assert {r["lane"] for r in xf if r["dir"] in ("h2d", "d2h")} == {"dev-0", "dev-1"}
    devs = ledger.device_lanes(records)
    assert set(devs) == {"dev-0", "dev-1"}
    assert sum(d["h2d_wire"] for d in devs.values()) == rep.bytes_h2d
    assert sum(d["d2h_wire"] for d in devs.values()) == rep.bytes_d2h
    assert sum(d["mesh_pad"] for d in devs.values()) == rep.n_mesh_pad_buckets > 0
    assert all("mesh_pad" in r for r in xf if r["dir"] == "h2d")
    fill = ledger.fill_stats(records)
    assert fill["mesh_pad_buckets"] == rep.n_mesh_pad_buckets
    assert fill["sum_check_ok"]


def test_mesh_h2d_spans_on_device_lanes(traced_mesh):
    records, rep, _ = traced_mesh
    spans = [r for r in records if r.get("type") == "span" and r.get("stage") == "mesh_h2d"]
    assert spans, "a multi-lane run must record mesh_h2d spans"
    assert {s["lane"] for s in spans} == {"dev-0", "dev-1"}
    assert sum(s["dur"] for s in spans) == pytest.approx(rep.seconds["mesh_h2d"], abs=0.05)


def _tool(name, *args):
    return subprocess.run(
        [sys.executable, "-m", f"duplexumiconsensusreads_torch.tools.{name}", *args],
        capture_output=True, text=True, env=ENV, cwd=REPO, timeout=120,
    )


def test_trace_report_and_wirestat_green_and_a_tampered_mesh_pad_fails(traced_mesh, tmp_path):
    _, _, trace = traced_mesh
    for name in ("trace_report", "wirestat", "check_trace"):
        r = _tool(name, trace)
        assert r.returncode == 0, (name, r.stdout, r.stderr)
    r = _tool("wirestat", trace)
    assert "dev-0" in r.stdout and "mesh_pad" in r.stdout
    bad = str(tmp_path / "bad.jsonl")
    tampered = False
    with open(trace) as src, open(bad, "w") as dst:
        for line in src:
            rec = json.loads(line)
            if not tampered and rec.get("type") == "xfer" and rec.get("dir") == "h2d":
                rec["mesh_pad"] = int(rec.get("mesh_pad", 0)) + 3
                tampered = True
            dst.write(json.dumps(rec) + "\n")
    assert tampered
    r = _tool("wirestat", bad)
    assert r.returncode == 1, r.stdout


# ---- chaos

@pytest.mark.parametrize("site, nth", [("shard.write", 1), ("fetch.unpack", 2)])
def test_kill_then_resume_converges(mesh_sim, tmp_path, site, nth):
    path, ref_bytes, _ = mesh_sim
    out = str(tmp_path / "k.bam")
    faults.install(faults.FaultPlan.parse(f"{site}:{nth}:kill"))
    try:
        with pytest.raises(faults.InjectedKill):
            stream_call_consensus(path, out, GP, CP, n_devices=2, **KW)
    finally:
        faults.uninstall()
    assert not os.path.exists(out)
    rep = stream_call_consensus(path, out, GP, CP, n_devices=2, resume=True, **KW)
    assert rep.n_devices == 2
    assert _read(out) == ref_bytes


def test_mesh_resumes_single_device_checkpoint(mesh_sim, tmp_path):
    """The mesh stays out of the checkpoint fingerprint: a prefix
    committed on one lane resumes on two, byte-identical."""
    path, ref_bytes, _ = mesh_sim
    out = str(tmp_path / "x.bam")
    faults.install(faults.FaultPlan.parse("finalise.write:2:kill"))
    try:
        with pytest.raises(faults.InjectedKill):
            stream_call_consensus(path, out, GP, CP, n_devices=1, **KW)
    finally:
        faults.uninstall()
    rep = stream_call_consensus(path, out, GP, CP, n_devices=2, resume=True, **KW)
    assert rep.n_chunks_skipped >= 1
    assert _read(out) == ref_bytes


# ---- serve, the CLI, the daemon

def test_mesh_job_byte_identical(mesh_sim, tmp_path):
    from duplexumiconsensusreads_torch.serve import ConsensusService, client
    from duplexumiconsensusreads_torch.serve.job import serve_provenance

    path, _, _ = mesh_sim
    spool = str(tmp_path / "spool")
    out = str(tmp_path / "job.bam")
    config = dict(grouping="adjacency", mode="duplex", mesh=2,
                  capacity=KW["capacity"], chunk_reads=KW["chunk_reads"])
    job = client.submit(spool, path, out, config=config)
    ConsensusService(spool, device="cpu", poll_s=0.02).run_until_idle()
    st = client.status(spool, job)
    assert st["state"] == "done", st
    ref2 = str(tmp_path / "oneshot.bam")
    stream_call_consensus(path, ref2, GP, CP, n_devices=1,
                          provenance_cl=serve_provenance(config), **KW)
    assert _read(out) == _read(ref2)
    assert "mesh" not in serve_provenance(config)


def test_submission_refuses_bad_mesh(mesh_sim, tmp_path):
    from duplexumiconsensusreads_torch.serve import client

    path, _, _ = mesh_sim
    for bad in (0, -2, True, "2"):
        with pytest.raises(ValueError, match="mesh"):
            client.submit(str(tmp_path / "spool"), path, str(tmp_path / "o.bam"),
                          config={"mesh": bad})


def test_cli_mesh_flag_streams_byte_identical(mesh_sim, tmp_path):
    """``call --mesh 2`` end to end through the CLI, against the one-lane
    reference (the @PG line is this process's argv on both sides)."""
    from duplexumiconsensusreads_torch.cli.main import main

    path, ref_bytes, _ = mesh_sim
    out = str(tmp_path / "cli.bam")
    assert main(["call", path, "-o", out, "--mode", "duplex", "--grouping", "adjacency",
                 "--capacity", str(KW["capacity"]), "--chunk-reads", str(KW["chunk_reads"]),
                 "--mesh", "2", "--device", "cpu"]) == 0
    assert _read(out) == ref_bytes


def test_cli_mesh_refused_on_whole_file(mesh_sim, tmp_path):
    from duplexumiconsensusreads_tpu.cli.main import main as jax_main
    from duplexumiconsensusreads_torch.cli.main import main

    path, _, _ = mesh_sim
    argv = ["call", path, "-o", str(tmp_path / "x.bam"), "--mesh", "2"]
    with pytest.raises(SystemExit, match="--mesh requires the streaming") as theirs:
        jax_main(argv)
    with pytest.raises(SystemExit) as ours:
        main(argv + ["--device", "cpu"])
    assert str(ours.value) == str(theirs.value)


def test_daemon_devices_parse():
    from duplexumiconsensusreads_torch.serve.daemon import parse_devices

    assert parse_devices(None) == (None, None)
    assert parse_devices("4") == (4, None)
    assert parse_devices("0,2") == (None, [0, 2])
    assert parse_devices(" 1 , 3 ") == (None, [1, 3])
    assert parse_devices("2,") == (None, [2])
    for bad in ("", "a", "0,0", "-1,2", "0"):
        with pytest.raises(ValueError):
            parse_devices(bad)
    with pytest.raises(ValueError, match="one-element list"):
        parse_devices("0")


# ---- the default mesh

@pytest.mark.parametrize("kw, lanes", [
    ({}, [0]),
    ({"n_devices": 4}, [0, 1, 2, 3]),
    ({"devices": [2, 3]}, [2, 3]),
    ({"devices": [1, 2, 3], "n_devices": 2}, [1, 2]),
    ({"n_devices": 4, "cycle_shards": 2}, [0, 1, 2, 3]),
])
def test_the_default_mesh_is_one_lane_on_a_host_of_four_cards(monkeypatch, kw, lanes):
    """``run_mesh`` with no ``n_devices`` takes one lane of a four-card
    pool (the JAX package takes every device; ROADMAP Faults 13), a
    named ``devices`` subset whole, and an explicit count as asked."""
    import torch

    from duplexumiconsensusreads_torch.parallel import mesh

    cards = [torch.device("cuda", i) for i in range(4)]
    monkeypatch.setattr(mesh, "device_pool", lambda device="cuda", devices=None: (
        [cards[i] for i in devices] if devices else cards))
    m = mesh.run_mesh("cuda", **kw)
    assert [d.index for d in m.devices] == lanes
    assert m.n_cycle == kw.get("cycle_shards", 1)


def test_the_default_mesh_is_one_lane_on_the_cpu():
    from duplexumiconsensusreads_torch.parallel import mesh

    assert mesh.run_mesh("cpu").size == 1
    assert mesh.run_mesh("cpu", devices=[0, 1, 2]).size == 3
