"""The port's indexes against the JAX package's, and its region query.

``build_bai``, ``build_csi`` and ``build_linear_index`` of the port and
of the JAX package, run on the same coordinate-sorted BAM, must write
identical bytes (the .dlix npz's members compared, since a zip entry
carries its write time); ``read_bai`` and ``query_start_voffset`` must
agree; the port's ``view`` of a region must return exactly the records
of a brute-force filter of the whole file, through the .bai and the
.csi, in process and through the CLI.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import zipfile

import numpy as np
import pytest

from duplexumiconsensusreads_tpu.io import bai as jbai
from duplexumiconsensusreads_tpu.io import csi as jcsi
from duplexumiconsensusreads_tpu.io import index as jindex
from duplexumiconsensusreads_torch.cli.main import main as cli_main
from duplexumiconsensusreads_torch.cli.main import parse_region, region_records, rows_to_records
from duplexumiconsensusreads_torch.io import bai, csi, index, read_bam
from duplexumiconsensusreads_torch.io.bam import BamHeader, BamRecords, write_bam
from duplexumiconsensusreads_torch.runtime.executor import write_bam_index

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _sorted_bam(path, n_per_ref=300, ref_lengths=(1_000_000,) * 3, n_unmapped=5, seed=5):
    """Coordinate-sorted BAM over several references (positions cross
    many 16 kb windows and bin levels, CIGARs with deletions and soft
    clips, a few placed-but-unmapped records) with an unmapped tail."""
    rng = np.random.default_rng(seed)
    rows = []
    for r, ln in enumerate(ref_lengths):
        for k, p in enumerate(np.sort(rng.integers(0, min(ln, 3_000_000) - 200, n_per_ref))):
            cig = [[(30, "M")], [(5, "S"), (25, "M")], [(12, "M"), (40, "D"), (18, "M")]][k % 3]
            rows.append((f"r{r}_{k}", 4 if k % 97 == 5 else 0, r, int(p), cig))
    rows += [(f"u{k}", 4, -1, -1, []) for k in range(n_unmapped)]
    n, L = len(rows), 30
    recs = BamRecords(
        names=[x[0] for x in rows],
        flags=np.array([x[1] for x in rows], np.uint16),
        ref_id=np.array([x[2] for x in rows], np.int32),
        pos=np.array([x[3] for x in rows], np.int32),
        mapq=np.full(n, 60, np.uint8),
        next_ref_id=np.full(n, -1, np.int32),
        next_pos=np.full(n, -1, np.int32),
        tlen=np.zeros(n, np.int32),
        lengths=np.full(n, L, np.int32),
        seq=rng.integers(0, 4, (n, L)).astype(np.uint8),
        qual=np.full((n, L), 30, np.uint8),
        cigars=[x[4] for x in rows],
        umi=["ACGTAA"] * n,
        aux_raw=[b"RXZACGTAA\x00"] * n,
    )
    header = BamHeader.synthetic(
        ref_names=tuple(f"chr{r + 1}" for r in range(len(ref_lengths))),
        ref_lengths=tuple(ref_lengths), sort_order="coordinate",
    )
    write_bam(path, header, recs)
    return recs


@pytest.fixture(scope="module")
def bam(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("torch_index") / "in.bam")
    _sorted_bam(p)
    return p


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("no_native", [False, True])
def test_bai_bytes_equal_the_jax_package(bam, tmp_path, monkeypatch, no_native):
    if no_native:
        monkeypatch.setenv("DUT_NO_NATIVE", "1")
    ours = bai.build_bai(bam, str(tmp_path / "t.bai"))
    theirs = jbai.build_bai(bam, str(tmp_path / "j.bai"))
    assert _bytes(ours) == _bytes(theirs) and len(_bytes(ours)) > 100


@pytest.mark.parametrize("no_native", [False, True])
def test_csi_bytes_equal_the_jax_package(bam, tmp_path, monkeypatch, no_native):
    if no_native:
        monkeypatch.setenv("DUT_NO_NATIVE", "1")
    ours = csi.build_csi(bam, str(tmp_path / "t.csi"))
    theirs = jcsi.build_csi(bam, str(tmp_path / "j.csi"))
    assert _bytes(ours) == _bytes(theirs)


@pytest.mark.parametrize("every", [1, 37, 100_000])
def test_linear_index_equals_the_jax_package(bam, tmp_path, every):
    ours, theirs = str(tmp_path / "t.dlix"), str(tmp_path / "j.dlix")
    index.build_linear_index(bam, every=every).save(ours)
    jindex.build_linear_index(bam, every=every).save(theirs)
    with zipfile.ZipFile(ours) as a, zipfile.ZipFile(theirs) as b:
        assert a.namelist() == b.namelist()
        for name in a.namelist():
            assert a.read(name) == b.read(name), name
    t, j = index.BamLinearIndex.load(ours), jindex.BamLinearIndex.load(theirs)
    assert t.n_records == j.n_records == 905
    for key in (None, 0, int(t.pos_key[len(t.pos_key) // 2]), int(t.pos_key[-1]) + 1):
        assert t.start_voffset(key) == j.start_voffset(key)


def test_query_start_voffset_agrees(bam, tmp_path):
    path = bai.build_bai(bam, str(tmp_path / "q.bai"))
    ours, theirs = bai.read_bai(path), jbai.read_bai(path)
    c_path = csi.build_csi(bam, str(tmp_path / "q.csi"))
    c_ours, c_theirs = csi.read_csi(c_path), jcsi.read_csi(c_path)
    rng = np.random.default_rng(3)
    n_hit = 0
    for _ in range(200):
        ref = int(rng.integers(0, 4))  # ref 3 does not exist
        beg = int(rng.integers(0, 1_000_000))
        end = beg + int(rng.integers(1, 200_000))
        v = bai.query_start_voffset(ours, ref, beg, end)
        assert v == jbai.query_start_voffset(theirs, ref, beg, end)
        assert (csi.query_start_voffset_csi(c_ours, ref, beg, end)
                == jcsi.query_start_voffset_csi(c_theirs, ref, beg, end))
        n_hit += v is not None
    assert n_hit > 50


def _brute(recs, ref_id, beg, end):
    out = []
    for i in range(len(recs)):
        if int(recs.ref_id[i]) != ref_id:
            continue
        span = sum(n for n, op in recs.cigars[i] if op in "MDN=X") or 1
        if int(recs.pos[i]) < end and int(recs.pos[i]) + span > beg:
            out.append(recs.names[i])
    return out


@pytest.mark.parametrize("region", ["chr1", "chr2:1-20000", "chr2:150001-450000",
                                    "chr3:999000-1000000", "chr1:5-5"])
@pytest.mark.parametrize("fmt", ["bai", "csi"])
def test_view_equals_a_filter_of_the_whole_file(tmp_path, region, fmt):
    path = str(tmp_path / "v.bam")
    recs = _sorted_bam(path, seed=9)
    (bai.build_bai if fmt == "bai" else csi.build_csi)(path)
    header = read_bam(path)[0]
    ref_id, beg, end, _ = parse_region(region, header)
    kept = region_records(path, header, ref_id, beg, end)
    got = rows_to_records(kept)
    assert got.names == _brute(recs, ref_id, beg, end)
    if got.names:
        i = recs.names.index(got.names[0])
        assert got.cigars[0] == recs.cigars[i] and got.aux_raw[0] == recs.aux_raw[i]
        np.testing.assert_array_equal(got.seq[0], recs.seq[i])


def test_call_write_index_then_view_through_the_cli(tmp_path):
    from duplexumiconsensusreads_tpu.io import simulated_bam
    from duplexumiconsensusreads_tpu.simulate import SimConfig

    inp, out, sub = (str(tmp_path / n) for n in ("in.bam", "out.bam", "sub.bam"))
    simulated_bam(SimConfig(n_molecules=150, read_len=40, n_positions=30, duplex=True,
                            seed=4), path=inp, sort=True)
    env = dict(os.environ, PYTHONPATH=REPO)
    base = [sys.executable, "-m", "duplexumiconsensusreads_torch"]
    r = subprocess.run(base + ["call", inp, "-o", out, "--config", "config5", "--capacity",
                               "128", "--device", "cpu", "--write-index"],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr
    assert _bytes(out + ".bai") == _bytes(jbai.build_bai(out, str(tmp_path / "j.bai")))
    header, recs = read_bam(out)
    mid = int(np.median(recs.pos))
    region = f"{header.ref_names[0]}:{mid - 2000}-{mid + 2000}"
    r = subprocess.run(base + ["view", out, region, "--json", "-o", sub],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr
    want = _brute(recs, 0, mid - 2001, mid + 2000)
    assert json.loads(r.stdout)["n_records"] == len(want) > 0
    assert read_bam(sub)[1].names == want
    r = subprocess.run(base + ["view", out, "chrX:1-10"], capture_output=True, text=True,
                       env=env, timeout=300)
    assert r.returncode != 0 and "unknown reference" in r.stderr


def test_index_cli_writes_each_format(bam, tmp_path, capsys):
    import shutil

    path = str(tmp_path / "c.bam")
    shutil.copy(bam, path)
    assert cli_main(["index", path]) == 0
    assert cli_main(["index", path, "--bai"]) == 0
    assert cli_main(["index", path, "--csi"]) == 0
    assert _bytes(path + ".bai") == _bytes(jbai.build_bai(path, str(tmp_path / "j.bai")))
    assert _bytes(path + ".csi") == _bytes(jcsi.build_csi(path, str(tmp_path / "j.csi")))
    assert index.BamLinearIndex.load(path + ".dlix").n_records == 905
    with pytest.raises(SystemExit, match="mutually exclusive"):
        cli_main(["index", path, "--bai", "--csi"])


def test_long_contig_takes_csi(tmp_path):
    """Past BAI's 2^29 coordinate space the index is a CSI (depth sized
    to the contig), equal to the JAX package's, and view reads it."""
    path = str(tmp_path / "long.bam")
    recs = _sorted_bam(path, n_per_ref=200, ref_lengths=(700_000_000, 1_000_000), seed=2)
    with pytest.raises(ValueError, match="CSI"):
        bai.build_bai(path, str(tmp_path / "x.bai"))
    header = read_bam(path)[0]
    out = write_bam_index(path, header.ref_lengths)
    assert out == path + ".csi" and not os.path.exists(path + ".bai")
    assert _bytes(out) == _bytes(jcsi.build_csi(path, str(tmp_path / "j.csi")))
    kept = region_records(path, header, 0, 1_000_000, 2_000_000)
    assert rows_to_records(kept).names == _brute(recs, 0, 1_000_000, 2_000_000)
