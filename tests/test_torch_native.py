"""The port's native BAM loader against the JAX package's and against
the port's own portable codec.

The C++ source is a copy (``duplexumiconsensusreads_torch/native/src``),
built here with g++ into the port's ``_build/``. For every case of the
JAX package's ``tests/test_native.py`` — duplex and single, bad UMIs,
an unparseable long RX, the flag filter, degenerate RX, uncompressed
BAM and aux types, a large multi-block BGZF — the port's
``read_bam_native`` must give the same ReadBatch arrays and ``info`` as
the JAX ``read_bam_native``, and the same arrays and counters as the
port's portable ``records_to_readbatch``. The native streaming iterator
must cut the portable iterator's chunks; the native deflate must
round-trip through the portable inflate; a failed build must raise.
"""

from __future__ import annotations

import ctypes
import os
import struct
import subprocess

import numpy as np
import pytest

from duplexumiconsensusreads_tpu.io import simulated_bam
from duplexumiconsensusreads_tpu.io.native_reader import read_bam_native as jax_read_native
from duplexumiconsensusreads_tpu.simulate import SimConfig
from duplexumiconsensusreads_torch import native
from duplexumiconsensusreads_torch.io import BamHeader, bgzf, read_bam, records_to_readbatch, write_bam
from duplexumiconsensusreads_torch.io.bam import (
    FLAG_SECONDARY,
    FLAG_SUPPLEMENTARY,
    FLAG_UNMAPPED,
    make_aux_i,
    make_aux_z,
)
from duplexumiconsensusreads_torch.io.native_reader import read_bam_native
from duplexumiconsensusreads_torch.runtime import stream

FIELDS = ("bases", "quals", "umi", "pos_key", "strand_ab", "frag_end", "valid")


def _equal_batches(a, b):
    for f in FIELDS:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)


def _check_all(path, duplex=True, **kw):
    """Port native == JAX native (arrays and info) == port portable
    (arrays and every counter but the ``native`` flag)."""
    h, b, info = read_bam_native(path, duplex=duplex, **kw)
    jh, jb, jinfo = jax_read_native(path, duplex=duplex, **kw)
    ph, recs = read_bam(path)
    pb, pinfo = records_to_readbatch(recs, duplex=duplex)
    assert h.ref_names == jh.ref_names == ph.ref_names and h.text == ph.text
    _equal_batches(b, jb)
    _equal_batches(b, pb)
    assert info == jinfo and info["native"] is True
    assert {k: v for k, v in info.items() if k != "native"} == {
        k: pinfo[k] for k in info if k != "native"}
    return b, info


def _sim(path, **cfg):
    _, recs, *_ = simulated_bam(SimConfig(**cfg))
    return recs


@pytest.mark.parametrize("duplex", [True, False])
def test_native_matches_python(tmp_path, duplex):
    path = str(tmp_path / "x.bam")
    simulated_bam(SimConfig(n_molecules=120, duplex=duplex, umi_error=0.02, read_len=80,
                            n_positions=8, n_frac=0.01, seed=13), path=path)
    _check_all(path, duplex=duplex)


def test_native_drops_bad_umis(tmp_path):
    path = str(tmp_path / "y.bam")
    recs = _sim(path, n_molecules=6, seed=7)
    recs.umi[0] = ""
    recs.aux_raw[0] = b""
    recs.umi[1] = "NNNACG-ACGTTT"
    recs.aux_raw[1] = make_aux_z("RX", recs.umi[1])
    write_bam(path, BamHeader.synthetic(), recs)
    b, _ = _check_all(path)
    assert not b.valid[0] and not b.valid[1] and b.valid[2:].all()


def test_unparseable_long_rx_does_not_inflate_umi_len(tmp_path):
    path = str(tmp_path / "w.bam")
    recs = _sim(path, n_molecules=8, seed=17)
    recs.umi[0] = "NACGTACGNN-ACGTACGTNN"  # longer than everyone, unparseable
    recs.aux_raw[0] = make_aux_z("RX", recs.umi[0])
    recs.umi[1] = recs.umi[1].lower()  # lowercase must still parse
    recs.aux_raw[1] = make_aux_z("RX", recs.umi[1])
    write_bam(path, BamHeader.synthetic(), recs)
    b, info = _check_all(path)
    assert info["n_valid"] == len(recs) - 1 and not b.valid[0] and b.valid[1]


def test_native_flag_filter_parity(tmp_path):
    path = str(tmp_path / "fl.bam")
    recs = _sim(path, n_molecules=10, seed=19)
    recs.flags[0] |= FLAG_SECONDARY
    recs.flags[1] |= FLAG_SUPPLEMENTARY
    recs.flags[2] |= FLAG_UNMAPPED
    recs.ref_id[2] = -1
    recs.pos[2] = -1
    write_bam(path, BamHeader.synthetic(), recs)
    b, info = _check_all(path)
    assert info["n_dropped_flag"] == 3 and not b.valid[:3].any()


@pytest.mark.parametrize("all_dash", [False, True])
def test_native_degenerate_rx_parity(tmp_path, all_dash):
    path = str(tmp_path / "deg.bam")
    recs = _sim(path, n_molecules=4 if all_dash else 6, seed=31 if all_dash else 29)
    for i in range(len(recs) if all_dash else 1):
        recs.umi[i] = "-"
        recs.aux_raw[i] = make_aux_z("RX", "-")
    write_bam(path, BamHeader.synthetic(), recs)
    _, info = _check_all(path)
    if all_dash:  # umi_len 0: every read valid
        assert info["umi_len"] == 0 and info["n_valid"] == len(recs)
    else:  # the '-' read is length-inconsistent, dropped
        assert info["n_valid"] == len(recs) - 1


def test_native_uncompressed_and_aux_types(tmp_path):
    from duplexumiconsensusreads_torch.io.bam import serialize_bam

    recs = _sim(str(tmp_path / "z.bam"), n_molecules=10, seed=3)
    for i in range(len(recs)):
        extra = (
            make_aux_i("NM", i)
            + b"XFf" + struct.pack("<f", 1.5)
            + b"XBB" + b"C" + struct.pack("<I", 3) + bytes([1, 2, 3])
            + b"XAA" + b"Q"
        )
        recs.aux_raw[i] = extra + recs.aux_raw[i] + make_aux_z("XZ", "trailing")
    for name, compressed in (("z.bam", True), ("raw.bam", False)):
        path = str(tmp_path / name)
        if compressed:
            write_bam(path, BamHeader.synthetic(), recs)
        else:  # an uncompressed BAM: the raw record stream, no BGZF
            with open(path, "wb") as f:
                f.write(serialize_bam(BamHeader.synthetic(), recs))
        _, info = _check_all(path)
        assert info["n_valid"] == len(recs)


def test_native_bgzf_large_multiblock(tmp_path):
    path = str(tmp_path / "big.bam")
    simulated_bam(SimConfig(n_molecules=2000, read_len=120, n_positions=32, seed=21), path=path)
    _, info = _check_all(path, n_threads=4)
    assert info["n_records"] > 10_000


# ---- the streaming reader


@pytest.fixture(scope="module")
def sorted_bams(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_native")
    out = {}
    for name, paired in (("single", False), ("mates", True)):
        p = str(d / f"{name}.bam")
        simulated_bam(SimConfig(n_molecules=150, read_len=40, n_positions=8, umi_error=0.02,
                                duplex=True, paired_reads=paired, seed=11), path=p, sort=True)
        out[name] = p
    return out


@pytest.mark.parametrize("which", ["single", "mates"])
@pytest.mark.parametrize("chunk_reads", [37, 150, 100_000])
def test_native_chunks_equal_the_portable_chunks(sorted_bams, monkeypatch, which, chunk_reads):
    nat = list(stream.iter_batch_chunks(sorted_bams[which], chunk_reads, duplex=True,
                                        warn_mixed=False))
    monkeypatch.setenv("DUT_NO_NATIVE", "1")
    port = list(stream.iter_batch_chunks(sorted_bams[which], chunk_reads, duplex=True,
                                         warn_mixed=False))
    assert [b.n_reads for _, b, _ in nat] == [b.n_reads for _, b, _ in port]
    assert len(nat) >= (2 if chunk_reads < 1000 else 1)
    for (_, a, ia), (_, b, ib) in zip(nat, port):
        _equal_batches(a, b)
        assert ia["native"] and "native" not in ib
        assert {k: v for k, v in ia.items() if k != "native"} == {k: ib[k] for k in ia if k != "native"}


@pytest.mark.parametrize("n", [1, 7, 4096])
def test_native_record_walk_equals_the_python_walk(sorted_bams, n):
    rd_n = stream.BamStreamReader(sorted_bams["mates"], read_size=1 << 14, use_native=True)
    rd_p = stream.BamStreamReader(sorted_bams["mates"], read_size=1 << 14, use_native=False)
    try:
        while True:
            a, b = rd_n.read_raw_records(n), rd_p.read_raw_records(n)
            assert a == b and rd_n._consumed == rd_p._consumed
            if a is None:
                break
    finally:
        rd_n.close()
        rd_p.close()


def test_reader_start_offset_resumes_mid_file(sorted_bams):
    """start=(coffset, uoffset) begins at the record a virtual offset
    addresses, as the BAI query and the linear index use it."""
    from duplexumiconsensusreads_torch.io.index import build_linear_index

    idx = build_linear_index(sorted_bams["single"], every=100)
    assert len(idx.coffset) >= 3
    whole = stream.BamStreamReader(sorted_bams["single"])
    raws = []
    while (r := whole.read_raw_records(100)) is not None:
        raws.append(r)
    whole.close()
    for use_native in (True, False):
        rd = stream.BamStreamReader(sorted_bams["single"], use_native=use_native,
                                    start=(int(idx.coffset[2]), int(idx.uoffset[2])))
        assert rd.read_raw_records(100) == raws[2]
        rd.close()


# ---- deflate


@pytest.mark.parametrize("size", [0, 1, 65_280, 65_281, 400_000])
def test_native_deflate_round_trips_through_the_portable_inflate(size):
    rng = np.random.default_rng(size)
    data = (rng.integers(0, 4, size).astype(np.uint8) + ord("A")).tobytes()
    comp, codec = bgzf.compress_fast_tagged(data)
    assert codec == "native" == bgzf.deflate_flavor()
    assert comp.endswith(bgzf.BGZF_EOF) and bgzf.decompress(comp) == data
    # the same payload's bytes are a pure function of the input
    assert bgzf.compress_fast(data) == comp
    raw, _ = bgzf.compress_fast_tagged(data, eof=False)
    assert raw + bgzf.BGZF_EOF == comp


def test_no_native_selects_the_portable_codec(monkeypatch):
    data = b"ACGT" * 50_000
    monkeypatch.setenv("DUT_NO_NATIVE", "1")
    comp, codec = bgzf.compress_fast_tagged(data)
    assert codec == "python" == bgzf.deflate_flavor()
    assert comp == bgzf.compress(data) and bgzf.decompress(comp) == data
    assert native.active_lib() is None and not native.native_available()


# ---- the build


def test_library_builds_into_the_port_build_dir():
    info = native.build()
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(native.__file__)))
    assert os.path.dirname(info["path"]) == os.path.join(pkg, "_build") == native.BUILD_DIR
    assert os.path.basename(info["path"]).startswith("libdutbam-")
    assert info["zlib_h"] is native.zlib_header_found()
    assert native.get_lib()._name == info["path"]
    assert "duplexumiconsensusreads_tpu" not in info["path"]


def test_build_failure_raises_with_the_compiler_output(tmp_path, monkeypatch):
    """No quiet fallback: a source that does not compile raises, and
    load_input propagates it instead of parsing with the Python codec."""
    from duplexumiconsensusreads_torch.io import load_input

    src = tmp_path / "src"
    src.mkdir()
    (src / "bamloader.cpp").write_text("this is not C++;\n")
    monkeypatch.setattr(native, "SRC_DIR", str(src))
    monkeypatch.setattr(native, "SOURCE", str(src / "bamloader.cpp"))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()
    bam = str(tmp_path / "in.bam")
    simulated_bam(SimConfig(n_molecules=4, seed=1), path=bam)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        load_input(bam, duplex=True)
    monkeypatch.setenv("DUT_NO_NATIVE", "1")
    assert load_input(bam, duplex=True)[1].n_reads > 0


def test_zlib_declarations_header_builds_a_working_library(tmp_path):
    """The card's host may lack zlib.h: the source then compiles against
    src/zlib_decls.h and links the libz.so.1 this process loaded."""
    import zlib  # noqa: F401 — maps libz.so.1

    libz = next(line.split()[-1] for line in open("/proc/self/maps") if "/libz.so" in line)
    out = str(tmp_path / "libdecls.so")
    cmd = ["g++", *native.CXX_FLAGS, "-DDUT_ZLIB_DECLS", "-o", out, native.SOURCE, libz,
           "-pthread"]
    r = subprocess.run(cmd, capture_output=True, text=True)
    assert r.returncode == 0, r.stdout + r.stderr
    lib = native._bind(ctypes.CDLL(out))
    data = np.frombuffer(b"duplex umi consensus " * 20_000, np.uint8)
    cap = lib.dut_bgzf_compress_bound(len(data))
    buf = np.empty(cap, np.uint8)
    w = lib.dut_bgzf_compress(data, len(data), buf, cap, 6, 4)
    assert w > 0
    comp = buf[:w].tobytes()
    assert comp == native.bgzf_compress_native(data.tobytes(), n_threads=4)
    assert bgzf.decompress(comp) == data.tobytes()
    src = np.frombuffer(comp, np.uint8)
    usize = lib.dut_bgzf_usize(src, len(src))
    back = np.empty(usize, np.uint8)
    assert lib.dut_bgzf_decompress(src, len(src), back, usize, 4) == usize == len(data)
    np.testing.assert_array_equal(back, data)


def test_resume_across_deflate_codecs_recomputes(sorted_bams, tmp_path, monkeypatch):
    """The fingerprint's deflate element and each shard's codec tag: a
    manifest the native deflate wrote is not resumed under
    DUT_NO_NATIVE=1 (nor the reverse); the recomputed run gives the
    portable run's bytes."""
    import json

    from duplexumiconsensusreads_torch.cli.main import params_for
    from duplexumiconsensusreads_torch.runtime.stream import stream_call_consensus

    gp, cp, _ = params_for("config5")
    kw = dict(capacity=128, chunk_reads=150, device="cpu")
    ckpt, out = str(tmp_path / "m.ckpt"), str(tmp_path / "o.bam")
    stream_call_consensus(sorted_bams["single"], out, gp, cp, checkpoint_path=ckpt, **kw)
    done = json.load(open(ckpt))["done"]
    assert len(done) >= 3 and {e["codec"] for e in done.values()} == {"native"}
    monkeypatch.setenv("DUT_NO_NATIVE", "1")
    rep = stream_call_consensus(sorted_bams["single"], out, gp, cp, checkpoint_path=ckpt,
                                resume=True, **kw)
    assert rep.n_chunks_skipped == 0 and rep.n_chunks == len(done)
    assert {e["codec"] for e in json.load(open(ckpt))["done"].values()} == {"python"}
    fresh = str(tmp_path / "f.bam")
    stream_call_consensus(sorted_bams["single"], fresh, gp, cp, **kw)
    assert open(out, "rb").read() == open(fresh, "rb").read()


def test_a_built_library_loads_while_another_process_holds_the_build_lock(tmp_path):
    """A process stopped while holding the build directory's lock (a
    SIGSTOPped daemon at its first native load) must not block another
    process's load of a library that already exists."""
    import sys

    native.get_lib()  # the library exists in the port's build directory
    lock = os.path.join(native.build_dir(native.BUILD_DIR), "libdutbam.lock")
    holder = subprocess.Popen(
        [sys.executable, "-c",
         "import fcntl, sys, time\n"
         f"f = open({lock!r}, 'w'); fcntl.flock(f, fcntl.LOCK_EX)\n"
         "print('held', flush=True); time.sleep(60)\n"],
        stdout=subprocess.PIPE, text=True)
    try:
        assert holder.stdout.readline().strip() == "held"
        r = subprocess.run(
            [sys.executable, "-c",
             "from duplexumiconsensusreads_torch import native; native.get_lib(); print('ok')"],
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            capture_output=True, text=True, timeout=60)
        assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr
    finally:
        holder.kill()
        holder.wait()


# The repository's conftest builds the JAX package's native library
# once under a lock before collection (conftest.py:build_reference_native).
# These run that function in several processes at once against a copy
# of the reference's native/ directory with no library in it.
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE_NATIVE = os.path.join(REPO, "duplexumiconsensusreads_tpu", "native")
BUILD_CHILD = (
    "import importlib.util, sys\n"
    "spec = importlib.util.spec_from_file_location('root_conftest', sys.argv[1])\n"
    "hook = importlib.util.module_from_spec(spec)\n"
    "spec.loader.exec_module(hook)\n"
    "lib = hook.build_reference_native(sys.argv[2], sys.argv[3])\n"
    "print('bound', lib.dut_bgzf_compress_bound(1000), flush=True)\n"
)


def _reference_native_copy(tmp_path):
    import shutil

    dst = tmp_path / "native"
    dst.mkdir()
    for name in ("Makefile", "__init__.py"):
        shutil.copy(os.path.join(REFERENCE_NATIVE, name), dst / name)
    shutil.copytree(os.path.join(REFERENCE_NATIVE, "src"), dst / "src")
    assert not (dst / "libdutbam.so").exists()
    return str(dst)


def _start_build_process(native_dir, lock):
    import sys

    return subprocess.Popen(
        [sys.executable, "-c", BUILD_CHILD, os.path.join(REPO, "conftest.py"), native_dir, lock],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def test_six_processes_build_the_reference_library_once_and_each_loads_it(tmp_path):
    """Six processes run the conftest hook's build at once on a copy with
    no library, as six xdist workers do on a fresh checkout: each one
    ends with a library that binds."""
    native_dir = _reference_native_copy(tmp_path)
    lock = str(tmp_path / "build" / "reference-native.lock")
    procs = [_start_build_process(native_dir, lock) for _ in range(6)]
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err
        assert out.split()[0] == "bound" and int(out.split()[1]) > 1000, out
    assert os.path.exists(os.path.join(native_dir, "libdutbam.so"))


def test_a_process_finding_the_reference_build_lock_held_waits_and_then_loads(tmp_path):
    """While another process holds the lock, the hook waits (it neither
    builds nor gives up); once the lock is free it builds and binds."""
    import fcntl
    import time

    native_dir = _reference_native_copy(tmp_path)
    lock = str(tmp_path / "reference-native.lock")
    with open(lock, "a") as held:
        fcntl.flock(held, fcntl.LOCK_EX)
        p = _start_build_process(native_dir, lock)
        try:
            time.sleep(2.0)
            assert p.poll() is None, p.communicate()
            assert not os.path.exists(os.path.join(native_dir, "libdutbam.so"))
        finally:
            fcntl.flock(held, fcntl.LOCK_UN)
    out, err = p.communicate(timeout=300)
    assert p.returncode == 0, err
    assert out.split()[0] == "bound", out
