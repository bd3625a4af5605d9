"""The port's follow-mode ingest (live/ and the stream's follow mode)
against the JAX package's.

- Byte identity: a follow run under every ``finalize_on`` mode, over a
  finished file, a file that grows while it is read and a FIFO, writes
  the bytes (and .bai) of the port's batch run over the same final
  input, with no live residue left behind.
- Port vs JAX: the port's follow output and the JAX package's follow
  output of the same growing input agree record by record at the
  parity bar (``test_torch_stream._compare``).
- Snapshots: each published snapshot is a valid, indexed BAM whose
  bytes are a prefix of the final output.
- Exactly once: a kill at the tailer's poll resumes, through the
  watermark, to the batch bytes; a torn input is refused loudly.
- ``TailSource``, ``parse_finalize_on`` and the watermark JSON equal
  the JAX package's.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time

import pytest

from duplexumiconsensusreads_tpu.io import read_bam as jax_read_bam
from duplexumiconsensusreads_tpu.io import simulated_bam
from duplexumiconsensusreads_tpu.live import TailSource as JaxTailSource
from duplexumiconsensusreads_tpu.live import parse_finalize_on as jax_parse_finalize_on
from duplexumiconsensusreads_tpu.live import watermark as jax_watermark
from duplexumiconsensusreads_tpu.runtime.stream import stream_call_consensus as jax_stream
from duplexumiconsensusreads_tpu.simulate import SimConfig
from duplexumiconsensusreads_tpu.types import ConsensusParams as JC
from duplexumiconsensusreads_tpu.types import GroupingParams as JG
from duplexumiconsensusreads_torch.io import read_bam
from duplexumiconsensusreads_torch.io.bam import parse_bam
from duplexumiconsensusreads_torch.live import TailSource, parse_finalize_on, watermark
from duplexumiconsensusreads_torch.runtime import faults
from duplexumiconsensusreads_torch.runtime.stream import stream_call_consensus
from duplexumiconsensusreads_torch.types import ConsensusParams, GroupingParams

from test_torch_stream import _compare

GP = GroupingParams(strategy="adjacency", paired=True)
CP = ConsensusParams(mode="duplex")
# write_index throughout: the byte-identity contract includes the .bai
KW = dict(capacity=128, chunk_reads=120, write_index=True)
# the live knobs these tests use (live_poll_s keeps the runs short)
LIVE = dict(follow=True, live_poll_s=0.01)
JOIN_S = 60.0


@pytest.fixture(scope="module")
def sim(tmp_path_factory):
    """(input path, reference bytes, reference .bai) of the port's batch run."""
    d = tmp_path_factory.mktemp("torch_live")
    path = str(d / "in.bam")
    simulated_bam(SimConfig(n_molecules=60, read_len=60, n_positions=8, umi_error=0.02,
                            seed=37), path=path, sort=True)
    ref = str(d / "ref.bam")
    rep = stream_call_consensus(path, ref, GP, CP, device="cpu", **KW)
    assert rep.n_chunks >= 3  # several commit points for snapshots and kills
    return path, *_out_files(ref)


def _out_files(out):
    with open(out, "rb") as f:
        b = f.read()
    with open(out + ".bai", "rb") as f:
        return b, f.read()


def _follow(path, out, **kw):
    return stream_call_consensus(path, out, GP, CP, device="cpu", **{**KW, **LIVE, **kw})


def _assert_no_live_residue(out):
    for suffix in (".livemark", ".snapshot.bam", ".snapshot.bam.bai", ".snapshot.bam.csi",
                   ".ckpt"):
        assert not os.path.exists(out + suffix), out + suffix


def _start_writer(path, raw, dst, delay_s=0.005, marker=False):
    """Append ``raw`` to ``dst`` in prime-sized slabs that tear BGZF
    blocks; a FIFO gets it in one write. Returns the started thread."""

    def write():
        if dst.endswith(".fifo"):
            with open(dst, "wb") as f:
                f.write(raw)
            return
        slab = max(1, len(raw) // 23)
        with open(dst, "ab") as f:
            for off in range(0, len(raw), slab):
                f.write(raw[off:off + slab])
                f.flush()
                time.sleep(delay_s)
        if marker:
            with open(dst + ".done", "w") as f:
                f.write("done\n")

    t = threading.Thread(target=write, daemon=True)
    t.start()
    return t


def _arrive(tmp_path, path, how, marker=False):
    """The input as it arrives: "finished" (a copy, marker written),
    "growing" (an empty file a writer appends to) or "fifo"."""
    with open(path, "rb") as f:
        raw = f.read()
    if how == "finished":
        inp = str(tmp_path / "in.bam")
        shutil.copy(path, inp)
        if marker:
            with open(inp + ".done", "w") as f:
                f.write("done\n")
        return inp, None
    if how == "fifo":
        inp = str(tmp_path / "in.fifo")
        os.mkfifo(inp)
    else:
        inp = str(tmp_path / "growing.bam")
        open(inp, "wb").close()
    return inp, _start_writer(path, raw, inp, marker=marker)


@pytest.mark.parametrize("finalize_on", ["eof", "idle:0.5", "marker"])
@pytest.mark.parametrize("how", ["finished", "growing", "fifo"])
def test_follow_is_byte_identical_to_the_batch_run(sim, tmp_path, how, finalize_on):
    path, ref_bytes, ref_bai = sim
    inp, writer = _arrive(tmp_path, path, how, marker=finalize_on == "marker")
    out = str(tmp_path / "f.bam")
    try:
        rep = _follow(inp, out, finalize_on=finalize_on)
    finally:
        if writer is not None:
            writer.join(JOIN_S)
            assert not writer.is_alive()
    assert _out_files(out) == (ref_bytes, ref_bai)
    assert rep.snapshot_seq == 0 and rep.n_chunks >= 3
    assert rep.seconds["live_poll"] >= 0 and rep.seconds["live_wait"] >= 0
    _assert_no_live_residue(out)


@pytest.mark.parametrize("how", ["growing", "fifo"])
def test_follow_without_native_equals_the_portable_batch_run(sim, tmp_path, monkeypatch, how):
    """Under DUT_NO_NATIVE=1 the portable iterator reads the tailer
    through the same open_fn: the follow output equals the portable
    batch run's bytes (the Python deflate on both sides)."""
    path, _, _ = sim
    monkeypatch.setenv("DUT_NO_NATIVE", "1")
    ref = str(tmp_path / "ref.bam")
    stream_call_consensus(path, ref, GP, CP, device="cpu", **KW)
    inp, writer = _arrive(tmp_path, path, how)
    out = str(tmp_path / "f.bam")
    try:
        rep = _follow(inp, out)
    finally:
        writer.join(JOIN_S)
    assert _out_files(out) == _out_files(ref) and rep.n_chunks >= 3
    _assert_no_live_residue(out)


def test_follow_matches_jax_follow_record_by_record(sim, tmp_path):
    """Both engines follow one growing file (one writer, two tailers):
    their outputs agree at the parity bar, and the run counters match."""
    path, _, _ = sim
    with open(path, "rb") as f:
        raw = f.read()
    inp = str(tmp_path / "growing.bam")
    open(inp, "wb").close()
    writer = _start_writer(path, raw, inp, delay_s=0.01)
    jout, tout = str(tmp_path / "j.bam"), str(tmp_path / "t.bam")
    jrep = {}

    def jax_follow():
        jrep["rep"] = jax_stream(inp, jout, JG(**vars(GP)), JC(**vars(CP)), n_devices=1,
                                 **KW, **LIVE)

    jt = threading.Thread(target=jax_follow, daemon=True)
    jt.start()
    try:
        trep = _follow(inp, tout)
    finally:
        jt.join(JOIN_S * 3)
        writer.join(JOIN_S)
    assert not jt.is_alive() and "rep" in jrep
    for f in ("n_records", "n_valid_reads", "n_chunks", "n_buckets", "n_families",
              "n_consensus", "snapshot_seq"):
        assert getattr(trep, f) == getattr(jrep["rep"], f), f
    _compare(jax_read_bam(jout)[1], read_bam(tout)[1], duplex=True)


def test_snapshots_are_valid_indexed_prefixes(sim, tmp_path):
    """Read at each commit (the progress callback runs right after the
    publish): every snapshot parses as a whole BAM, carries a .bai, and
    is the final output's bytes up to its own EOF block; the series is
    dense and its last snapshot holds every record."""
    path, ref_bytes, ref_bai = sim
    out = str(tmp_path / "f.bam")
    snap = out + ".snapshot.bam"
    seen = []

    def progress(_k, rep):
        with open(snap, "rb") as f, open(snap + ".bai", "rb") as g:
            seen.append((f.read(), g.read(), rep.snapshot_seq))

    inp, writer = _arrive(tmp_path, path, "growing")
    try:
        rep = _follow(inp, out, snapshot_chunks=1, progress=progress)
    finally:
        writer.join(JOIN_S)
    assert rep.snapshot_seq == rep.n_chunks == len(seen) >= 3
    assert _out_files(out) == (ref_bytes, ref_bai)
    n_final = len(read_bam(out)[1].names)
    prev = -1
    for i, (b, bai, seq) in enumerate(seen):
        assert seq == i + 1
        assert bai.startswith(b"BAI\1") and len(bai) > 8
        assert b[:-28] == ref_bytes[:len(b) - 28]
        _, recs = parse_bam(b)
        assert prev < len(recs.names) <= n_final
        prev = len(recs.names)
    assert prev == n_final
    _assert_no_live_residue(out)


def test_snapshot_cadence_does_not_move_bytes(sim, tmp_path):
    path, ref_bytes, ref_bai = sim
    out = str(tmp_path / "f.bam")
    rep = _follow(path, out, snapshot_chunks=2)
    assert rep.snapshot_seq == rep.n_chunks // 2
    assert _out_files(out) == (ref_bytes, ref_bai)


def test_kill_mid_tail_resumes_exactly_once(sim, tmp_path):
    """An injected kill at the tailer's 4th poll: no output, the
    watermark survives, and resume=True converges to the batch bytes
    with the snapshot series continuing."""
    path, ref_bytes, ref_bai = sim
    inp, writer = _arrive(tmp_path, path, "growing")
    out = str(tmp_path / "k.bam")
    faults.install(faults.FaultPlan.parse("live.poll:4:kill"))
    try:
        with pytest.raises(faults.InjectedKill):
            _follow(inp, out, snapshot_chunks=1)
    finally:
        faults.uninstall()
        writer.join(JOIN_S)
    assert not os.path.exists(out)
    mark = watermark.load(out)
    assert mark is not None
    rep = _follow(inp, out, snapshot_chunks=1, resume=True)
    assert rep.snapshot_seq >= max(int(mark["snapshot_seq"]), 1)
    assert _out_files(out) == (ref_bytes, ref_bai)
    _assert_no_live_residue(out)


def test_truncated_input_is_refused(sim, tmp_path):
    path, _, _ = sim
    with open(path, "rb") as f:
        raw = f.read()
    inp = str(tmp_path / "torn.bam")
    with open(inp, "wb") as f:
        f.write(raw[:-40])  # tears the trailing EOF block
    out = str(tmp_path / "f.bam")
    with pytest.raises(ValueError, match="truncated trailing BGZF block"):
        _follow(inp, out, finalize_on="idle:0.2")
    assert not os.path.exists(out)


def test_follow_refuses_a_range(sim, tmp_path):
    """Follow mode and range mode refuse each other in the JAX words."""
    path, _, _ = sim
    for kw in (dict(input_range=((0, 0), None, None)), dict(chunk_base=2),
               dict(first_read=7)):
        with pytest.raises(ValueError) as ours:
            _follow(path, str(tmp_path / "r.bam"), **kw)
        with pytest.raises(ValueError) as theirs:
            jax_stream(path, str(tmp_path / "j.bam"), JG(**vars(GP)), JC(**vars(CP)),
                       n_devices=1, **KW, **LIVE, **kw)
        assert str(ours.value) == str(theirs.value)


# ---- TailSource, parse_finalize_on, the watermark

@pytest.mark.parametrize("spec", ["eof", "marker", "idle:2.5", "idle:0", "idle:-1", "idle:",
                                  "idle:x", "never", ""])
def test_parse_finalize_on_matches_jax(spec):
    def run(fn):
        try:
            return fn(spec)
        except ValueError as e:
            return str(e)

    assert run(parse_finalize_on) == run(jax_parse_finalize_on)


def _drain(src, out):
    try:
        while True:
            b = src.read(1 << 14)
            if not b:
                break
            out.append(b)
    finally:
        src.close()


@pytest.mark.parametrize("finalize_on", ["eof", "idle:0.4"])
def test_tail_source_yields_jax_bytes_on_a_growing_file(sim, tmp_path, finalize_on):
    path, _, _ = sim
    with open(path, "rb") as f:
        raw = f.read()
    inp = str(tmp_path / "growing.bam")
    open(inp, "wb").close()
    writer = _start_writer(path, raw, inp)
    ours, theirs = TailSource(inp, 0.01, finalize_on), JaxTailSource(inp, 0.01, finalize_on)
    got = {"ours": [], "theirs": []}
    threads = [threading.Thread(target=_drain, args=(s, got[k]), daemon=True)
               for k, s in (("ours", ours), ("theirs", theirs))]
    for t in threads:
        t.start()
    for t in threads + [writer]:
        t.join(JOIN_S)
        assert not t.is_alive()
    assert b"".join(got["ours"]) == b"".join(got["theirs"]) == raw
    assert ours.finish_reason == theirs.finish_reason
    assert ours.tell() == theirs.tell() == ours.admitted_bytes() == len(raw)


def test_tail_source_is_forward_only_and_drains_its_phase_seconds(sim, tmp_path):
    path, _, _ = sim
    src = TailSource(path, poll_s=0.01)
    try:
        first = src.read(1 << 14)
        assert src.seek(len(first)) == len(first)
        with pytest.raises(ValueError, match="forward-only"):
            src.seek(0)
    finally:
        src.close()
    empty = str(tmp_path / "empty.bam")
    open(empty, "wb").close()
    src = TailSource(empty, poll_s=0.01, finalize_on="idle:10")
    try:
        deadline = time.monotonic() + 10
        poll_s = 0.0
        while poll_s <= 0 and time.monotonic() < deadline:
            time.sleep(0.05)
            poll_s, _ = src.take_phase_seconds()
        assert poll_s > 0
        again, _ = src.take_phase_seconds()
        assert again < poll_s
    finally:
        src.close()


def test_watermark_json_equals_jax(sim, tmp_path, monkeypatch):
    """The same (output, input) pair and the same random token give the
    same .livemark bytes; a resume reuses it, a rewritten head re-pins."""
    path, _, _ = sim
    monkeypatch.setattr(os, "urandom", lambda n: b"\x5a" * n)
    ours, theirs = str(tmp_path / "a" / "o.bam"), str(tmp_path / "b" / "o.bam")
    for d in ("a", "b"):
        os.makedirs(tmp_path / d)
    m1 = watermark.load_or_create(ours, path)
    j1 = jax_watermark.load_or_create(theirs, path)
    assert m1 == j1
    with open(watermark.mark_path(ours), "rb") as f, open(jax_watermark.mark_path(theirs),
                                                          "rb") as g:
        assert f.read() == g.read()
    m1["snapshot_seq"], j1["snapshot_seq"] = 3, 3
    watermark.save(ours, m1)
    jax_watermark.save(theirs, j1)
    assert watermark.load(ours) == jax_watermark.load(theirs) == m1
    monkeypatch.undo()
    assert watermark.load_or_create(ours, path)["stat_sig"] == m1["stat_sig"]
    assert watermark.load_or_create(ours, path, resume=False)["stat_sig"] != m1["stat_sig"]
    inp = str(tmp_path / "in.bam")
    shutil.copy(path, inp)
    ma = watermark.load_or_create(ours, inp, resume=False)
    with open(inp, "r+b") as f:
        f.write(b"XXXX")
    assert watermark.load_or_create(ours, inp)["stat_sig"] != ma["stat_sig"]
    watermark.clear(ours)
    assert watermark.load(ours) is None


def test_fifo_resume_is_refused_in_the_jax_words(tmp_path):
    fifo = str(tmp_path / "p.fifo")
    os.mkfifo(fifo)
    msgs = []
    for wm, out in ((watermark, "o.bam"), (jax_watermark, "j.bam")):
        out = str(tmp_path / out)
        wm.load_or_create(out, fifo)
        with pytest.raises(ValueError, match="FIFO") as e:
            wm.load_or_create(out, fifo)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_live_counters_reach_the_status_document():
    from duplexumiconsensusreads_tpu.serve.client import status_document as jax_doc
    from duplexumiconsensusreads_torch.serve.client import status_document

    st = {"job_id": "j", "state": "running", "snapshot_seq": 3, "reads_emitted": 120,
          "now_m": 10.0, "admitted_m": 4.0}
    assert status_document(st) == jax_doc(st)
    assert status_document(st)["snapshot_seq"] == 3
    assert json.dumps(status_document(st), sort_keys=True)
