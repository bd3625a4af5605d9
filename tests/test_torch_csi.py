"""The port's CSI index against the JAX package's (the contracts of
tests/test_csi.py that tests/test_torch_index.py does not already hold:
the CSI bytes, query starts and long-contig view are there).

Here: the generalised binning against BAI's at depth 5, the depth
sizing, bin 0 on records past BAI's domain, ``view`` using an existing
.csi without building a .bai, ``call --write-index`` choosing a CSI from
the header, and the refusal of truncated indexes and of malformed
metadata pseudo-bins. Each runs through both packages: equal values,
equal bytes, or the same refusal with the same words.
"""

from __future__ import annotations

import os
import struct

import numpy as np
import pytest

from duplexumiconsensusreads_tpu.cli.main import main as jax_main
from duplexumiconsensusreads_tpu.io import bai as jbai
from duplexumiconsensusreads_tpu.io import bam as jbam
from duplexumiconsensusreads_tpu.io import csi as jcsi
from duplexumiconsensusreads_torch.cli.main import main as cli_main
from duplexumiconsensusreads_torch.io import bai, bam, csi, read_bam, write_bam
from duplexumiconsensusreads_torch.io.bam import BamHeader, BamRecords


def _sorted_bam(path, positions, ref_len=10_000_000, L=50, header_len=None):
    n = len(positions)
    rng = np.random.default_rng(1)
    recs = BamRecords(
        names=[f"r{i}" for i in range(n)], flags=np.zeros(n, np.uint16),
        ref_id=np.zeros(n, np.int32), pos=np.asarray(sorted(positions), np.int32),
        mapq=np.full(n, 60, np.uint8), next_ref_id=np.full(n, -1, np.int32),
        next_pos=np.full(n, -1, np.int32), tlen=np.zeros(n, np.int32),
        lengths=np.full(n, L, np.int32), seq=rng.integers(0, 4, (n, L)).astype(np.uint8),
        qual=np.full((n, L), 30, np.uint8), cigars=[[(L, "M")]] * n, umi=["ACGT"] * n,
        aux_raw=[b"RXZACGT\x00"] * n)
    write_bam(path, BamHeader.synthetic(ref_names=("chr1",), ref_lengths=(header_len or ref_len,),
                                        sort_order="coordinate"), recs)
    return recs


def test_reg2bin_matches_the_bai_scheme_alike():
    rng = np.random.default_rng(3)
    begs = rng.integers(0, (1 << 29) - 200, 2000)
    ends = begs + rng.integers(1, 200, 2000)
    ours = csi.reg2bin_vec(begs, ends, 14, 5)
    np.testing.assert_array_equal(ours, jcsi.reg2bin_vec(begs, ends, 14, 5))
    np.testing.assert_array_equal(ours, bam._reg2bin_vec(begs, ends))
    np.testing.assert_array_equal(ours, jbam._reg2bin_vec(begs, ends))
    for beg, end, b in zip(begs[:50].tolist(), ends[:50].tolist(), ours[:50].tolist()):
        bins = csi.reg2bins(beg, end, 14, 5)
        assert b in bins and bins == jcsi.reg2bins(beg, end, 14, 5)


@pytest.mark.parametrize("length, depth", [(1 << 29, 5), ((1 << 29) + 1, 6), (1 << 32, 6),
                                           ((1 << 32) + 1, 7)])
def test_depth_sizing_alike(length, depth):
    assert csi.depth_for(length) == jcsi.depth_for(length) == depth


def test_record_bin_zero_past_the_bai_domain_alike(tmp_path):
    """A record past 2^29 carries bin 0 in the port's serializer as in
    the JAX package's; one inside keeps its reg2bin."""
    from duplexumiconsensusreads_torch.io.index import _record_offsets
    from duplexumiconsensusreads_torch.runtime.stream import BamStreamReader

    bins = []
    for side, write in (("port", write_bam), ("jax", jbam.write_bam)):
        path = str(tmp_path / f"{side}.bam")
        recs = _sorted_bam(path, [1000, 600_000_000], ref_len=1_200_000_000)
        write(path, read_bam(path)[0], recs)
        rdr = BamStreamReader(path)
        try:
            raw = rdr.read_raw_records(16)
        finally:
            rdr.close()
        offs = _record_offsets(raw)
        assert len(offs) == 2
        bins.append([struct.unpack_from("<H", raw, int(o) + 14)[0] for o in offs])
    assert bins[0] == bins[1] == [bam._reg2bin(1000, 1050), 0]


def test_view_uses_an_existing_csi_alike(tmp_path):
    positions = list(range(100, 50_000, 911))
    want = sorted(p for p in positions if p < 2000 and p + 50 > 999)
    for side, fn in (("jax", jax_main), ("port", cli_main)):
        path = str(tmp_path / f"{side}.bam")
        _sorted_bam(path, positions)
        csi.build_csi(path)
        out = str(tmp_path / f"{side}_o.bam")
        assert fn(["view", path, "chr1:1000-2000", "-o", out]) == 0
        assert not os.path.exists(path + ".bai"), f"{side} view built a BAI"
        assert sorted(np.asarray(read_bam(out)[1].pos).tolist()) == want


def test_call_write_index_picks_csi_from_the_header_alike(tmp_path):
    """A header contig past 2^29 (records at small positions): ``call
    --write-index`` writes a .csi and no .bai, equal to the JAX CLI's."""
    from duplexumiconsensusreads_torch.io import simulated_bam
    from duplexumiconsensusreads_torch.simulate import SimConfig

    header, recs, _, _ = simulated_bam(SimConfig(n_molecules=20, duplex=False, seed=5),
                                       sort=True)
    bam_path = str(tmp_path / "in.bam")
    write_bam(bam_path, BamHeader.synthetic(
        ref_names=tuple(header.ref_names),
        ref_lengths=tuple((1 << 29) + 1 for _ in header.ref_names), sort_order="coordinate"),
        recs)
    outs = {}
    for side, fn in (("jax", jax_main), ("port", cli_main)):
        outs[side] = str(tmp_path / f"{side}.bam")
        assert fn(["call", bam_path, "-o", outs[side], "--mode", "ss", "--grouping", "exact",
                   "--capacity", "256", "--backend", "cpu", "--write-index"]) == 0
        assert os.path.exists(outs[side] + ".csi") and not os.path.exists(outs[side] + ".bai")
    assert csi.read_csi(outs["port"] + ".csi")["n_ref"] == len(header.ref_names)
    assert (open(outs["port"] + ".csi", "rb").read()
            == open(jcsi.build_csi(outs["port"], str(tmp_path / "j.csi")), "rb").read())


def _refusal(fn, path) -> str:
    with pytest.raises(ValueError) as e:
        fn(path)
    return str(e.value)


@pytest.mark.parametrize("fmt", ["bai", "csi"])
def test_truncated_index_refused_alike(tmp_path, fmt):
    path = str(tmp_path / "t.bam")
    _sorted_bam(path, [100, 500, 900, 40_000])
    data = open(bai.build_bai(path) if fmt == "bai" else csi.build_csi(path), "rb").read()
    ours, theirs = (bai.read_bai, jbai.read_bai) if fmt == "bai" else (csi.read_csi,
                                                                       jcsi.read_csi)
    for cut in (10, len(data) // 2):
        trunc = str(tmp_path / f"x{cut}.{fmt}")
        with open(trunc, "wb") as f:
            f.write(data[:cut])
        msg = _refusal(ours, trunc)
        assert "truncated or corrupt" in msg and msg == _refusal(theirs, trunc)


@pytest.mark.parametrize("n_chunk", [0, 1, 3])
def test_metadata_pseudo_bin_chunk_count_refused_alike(tmp_path, n_chunk):
    chunks = struct.pack("<QQ", 0, 0) * n_chunk
    p = tmp_path / "meta.bai"
    p.write_bytes(b"BAI\x01" + struct.pack("<i", 1) + struct.pack("<i", 1)
                  + struct.pack("<Ii", bai.METADATA_BIN, n_chunk) + chunks
                  + struct.pack("<i", 0) + struct.pack("<Q", 0))
    msg = _refusal(bai.read_bai, str(p))
    assert "pseudo-bin" in msg and msg == _refusal(jbai.read_bai, str(p))
    p2 = tmp_path / "meta.csi"
    p2.write_bytes(csi.CSI_MAGIC + struct.pack("<iii", 14, 5, 0) + struct.pack("<i", 1)
                   + struct.pack("<i", 1) + struct.pack("<IQi", csi._n_bins(5) + 1, 0, n_chunk)
                   + chunks + struct.pack("<Q", 0))
    msg = _refusal(csi.read_csi, str(p2))
    assert "pseudo-bin" in msg and msg == _refusal(jcsi.read_csi, str(p2))
