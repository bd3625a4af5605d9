"""The port's BAI and output headers against the JAX package's (the
contracts of tests/test_bai.py that tests/test_torch_index.py does not
already hold: the BAI bytes, structure and region queries on a sorted
multi-reference file are there).

Here: positionless placed records, the unsorted and over-2^29
refusals, the indexing speed at 100k records, the output header's
provenance (@RG/@CO kept, @PG chained, the consensus @RG and its
collision rename, a custom read group) through ``call`` whole and
streamed, ``filter`` and ``group``, and ``view`` on a contig name with
colons over an unmapped tail. Each runs through both packages on the
same file: identical index bytes or the same refusal; the port's
output headers equal the JAX CLI's but for the program name, with the
same RG tag on every record.
"""

from __future__ import annotations

import json
import time

import numpy as np
import pytest

from duplexumiconsensusreads_tpu.cli.main import main as jax_main
from duplexumiconsensusreads_tpu.io import bai as jbai
from duplexumiconsensusreads_torch.cli.main import main as cli_main
from duplexumiconsensusreads_torch.io import bai, read_bam, write_bam
from duplexumiconsensusreads_torch.io.bam import BamHeader, BamRecords

PORT_NAME, JAX_NAME = "duplexumiconsensusreads_torch", "duplexumiconsensusreads_tpu"


def _records(rid, pos, flags, L=24, seed=5, cigars=None):
    n = len(pos)
    rng = np.random.default_rng(seed)
    return BamRecords(
        names=[f"r{i}" for i in range(n)], flags=np.asarray(flags, np.uint16),
        ref_id=np.asarray(rid, np.int32), pos=np.asarray(pos, np.int32),
        mapq=np.full(n, 60, np.uint8), next_ref_id=np.full(n, -1, np.int32),
        next_pos=np.full(n, -1, np.int32), tlen=np.zeros(n, np.int32),
        lengths=np.full(n, L, np.int32), seq=rng.integers(0, 4, (n, L)).astype(np.uint8),
        qual=np.full((n, L), 30, np.uint8),
        cigars=cigars or [[(L, "M")] for _ in range(n)], umi=[""] * n,
        aux_raw=[b"RXZACGTAA\x00"] * n)


def _multi_ref_bam(path, n_per_ref=40, n_ref=3, seed=5, sort=True, edit=None):
    """tests/test_bai.py's multi-reference BAM: positions spread over
    several 16 kb windows and bin levels on each reference."""
    rng = np.random.default_rng(seed)
    rid = np.repeat(np.arange(n_ref), n_per_ref)
    pos = np.concatenate([np.sort(rng.integers(0, 300_000, n_per_ref)) for _ in range(n_ref)])
    recs = _records(rid, pos, np.zeros(len(pos)), seed=seed)
    if edit:
        edit(recs)
    header = BamHeader.synthetic(ref_names=tuple(f"chr{r + 1}" for r in range(n_ref)),
                                 ref_lengths=(1_000_000,) * n_ref,
                                 sort_order="coordinate" if sort else "unsorted")
    write_bam(path, header, recs)
    return recs


def both_bai(path, tmp_path) -> bytes:
    """Both packages' build_bai on one BAM: identical bytes, or the same
    refusal (re-raised)."""
    outs = []
    for mod, tag in ((bai, "t"), (jbai, "j")):
        try:
            outs.append(("ok", open(mod.build_bai(path, str(tmp_path / f"{tag}.bai")),
                                    "rb").read()))
        except ValueError as e:
            outs.append(("refused", str(e)))
    assert outs[0] == outs[1]
    if outs[0][0] == "refused":
        raise ValueError(outs[0][1])
    return outs[0][1]


def test_bai_clamps_positionless_placed_records_alike(tmp_path):
    path = str(tmp_path / "pm1.bam")

    def edit(recs):
        recs.pos[0], recs.flags[0] = -1, 4

    _multi_ref_bam(path, n_per_ref=5, n_ref=1, edit=edit)
    both_bai(path, tmp_path)
    ref = bai.read_bai(str(tmp_path / "t.bai"))["refs"][0]
    assert ref["meta"][2] == 4 and ref["meta"][3] == 1 and ref["linear"][0] != 0


def test_bai_rejects_unsorted_alike(tmp_path):
    path = str(tmp_path / "uns.bam")

    def edit(recs):
        for f in ("flags", "ref_id", "pos", "seq"):
            a = getattr(recs, f)
            a[[0, 5]] = a[[5, 0]]

    _multi_ref_bam(path, sort=False, edit=edit)
    with pytest.raises(ValueError, match="not coordinate-sorted"):
        both_bai(path, tmp_path)


def test_bai_refuses_contig_over_512mbp_alike(tmp_path):
    path = str(tmp_path / "long.bam")
    write_bam(path, BamHeader.synthetic(ref_names=("big1",), ref_lengths=(600_000_000,),
                                        sort_order="coordinate"),
              _records(np.zeros(4), np.arange(4) * 100, np.zeros(4)))
    with pytest.raises(ValueError, match="CSI"):
        both_bai(path, tmp_path)


def test_bai_indexes_100k_records_fast_and_alike(tmp_path):
    path = str(tmp_path / "big.bam")
    _multi_ref_bam(path, n_per_ref=50_000, n_ref=2, seed=3)
    t0 = time.monotonic()
    out = bai.build_bai(path)
    dt = time.monotonic() - t0
    assert sum(r["meta"][2] + r["meta"][3] for r in bai.read_bai(out)["refs"]) == 100_000
    assert open(out, "rb").read() == open(jbai.build_bai(path, str(tmp_path / "j.bai")),
                                          "rb").read()
    assert dt < 15, f"build_bai took {dt:.1f}s for 100k records"


@pytest.fixture
def provenance_bam(tmp_path):
    """tests/test_bai.py's simulated input with @RG/@CO lines and RG tags
    grafted in."""
    bam = str(tmp_path / "in.bam")
    assert cli_main(["simulate", "-o", bam, "--molecules", "60", "--read-len", "40",
                     "--positions", "6", "--umi-error", "0.02", "--seed", "17", "--sorted"]) == 0
    h, recs = read_bam(bam)
    lines = h.text.rstrip("\n").splitlines()
    lines[1:1] = ["@RG\tID:rg1\tSM:sampleA", "@RG\tID:rg2\tSM:sampleB"]
    lines.append("@CO\tprovenance comment")
    for i in range(len(recs)):
        recs.aux_raw[i] += b"RGZ" + (b"rg1" if i % 2 else b"rg2") + b"\x00"
    write_bam(bam, BamHeader("\n".join(lines) + "\n", h.ref_names, h.ref_lengths), recs)
    return bam


def both_cli(tmp_path, cmd, src, *flags) -> tuple:
    """One subcommand through both CLIs (the port's ``call`` and
    ``group`` at --device cpu): the port's header equals the JAX CLI's
    but for the program name, and every record carries the same RG
    tag. Returns the port's (header text, records, output path)."""
    out = {s: str(tmp_path / f"{cmd}_{s}.bam") for s in ("jax", "port")}
    assert jax_main([cmd, src, "-o", out["jax"], *flags]) == 0
    extra = ["--device", "cpu"] if cmd in ("call", "group") else []
    assert cli_main([cmd, src, "-o", out["port"], *flags, *extra]) == 0
    (jh, jr), (h, r) = read_bam(out["jax"]), read_bam(out["port"])
    assert h.text.replace(PORT_NAME, JAX_NAME) == jh.text.replace(PORT_NAME, JAX_NAME)
    assert _read_groups(r) == _read_groups(jr) and len(r) == len(jr) > 0
    return h.text, r, out["port"]


def _read_groups(recs) -> list:
    """Each record's RG:Z values."""
    from duplexumiconsensusreads_torch.io.bam import iter_aux_fields

    return [[a[vs:e] for _, tag, _, vs, e in iter_aux_fields(a) if tag == b"RG"]
            for a in recs.aux_raw]


@pytest.mark.parametrize("mode", ["whole", "stream"])
def test_output_header_and_read_group_alike(provenance_bam, tmp_path, mode):
    extra = ["--chunk-reads", "120"] if mode == "stream" else []
    text, recs, out = both_cli(tmp_path, "call", provenance_bam, "--config", "config3",
                               "--capacity", "256", "--write-index", *extra)
    lines = text.splitlines()
    assert "SO:coordinate" in lines[0]
    for want in ("@RG\tID:rg1\tSM:sampleA", "@RG\tID:rg2\tSM:sampleB", "@CO\tprovenance comment"):
        assert want in text
    new_pg = [line for line in lines if line.startswith("@PG") and "PP:" in line]
    assert len(new_pg) == 1 and "PP:duplexumi" in new_pg[0]
    assert any("ID:A" in line and "sampleA" in line and "sampleB" in line
               for line in lines if line.startswith("@RG"))
    assert all(b"RGZA\x00" in a for a in recs.aux_raw)
    key = np.asarray(recs.ref_id).astype(np.int64) << 32 | np.asarray(recs.pos)
    assert (np.diff(key) >= 0).all()
    idx = bai.read_bai(out + ".bai")
    assert sum(r["meta"][2] + r["meta"][3] for r in idx["refs"] if r["meta"]) == len(recs)


def test_read_group_id_collision_uniquified_alike(tmp_path):
    bam = str(tmp_path / "in.bam")
    assert cli_main(["simulate", "-o", bam, "--molecules", "40", "--read-len", "40",
                     "--positions", "4", "--seed", "3", "--sorted"]) == 0
    h, recs = read_bam(bam)
    lines = h.text.rstrip("\n").splitlines()
    lines.insert(1, "@RG\tID:A\tSM:prior_consensus")
    write_bam(bam, BamHeader("\n".join(lines) + "\n", h.ref_names, h.ref_lengths), recs)
    text, recs2, _ = both_cli(tmp_path, "call", bam, "--config", "config3", "--capacity", "256")
    rg = [line for line in text.splitlines() if line.startswith("@RG")]
    assert any("ID:A\t" in line and "prior_consensus" in line for line in rg)
    assert any("ID:A.1" in line for line in rg)
    assert all(b"RGZA.1\x00" in a for a in recs2.aux_raw)


def test_custom_read_group_id_alike(provenance_bam, tmp_path):
    text, recs, _ = both_cli(tmp_path, "call", provenance_bam, "--config", "config3",
                             "--capacity", "256", "--read-group-id", "ctdna1")
    assert any(line.startswith("@RG") and "ID:ctdna1" in line for line in text.splitlines())
    assert all(b"RGZctdna1\x00" in a for a in recs.aux_raw)


def test_filter_and_group_chain_pg_alike(provenance_bam, tmp_path):
    text, _, out = both_cli(tmp_path, "call", provenance_bam, "--config", "config3",
                            "--capacity", "256")
    n_pg = sum(line.startswith("@PG") for line in text.splitlines())
    ftext, _, _ = both_cli(tmp_path, "filter", out, "--min-depth", "1")
    pg_f = [line for line in ftext.splitlines() if line.startswith("@PG")]
    assert len(pg_f) == n_pg + 1
    assert any("ID:duplexumi.1" in line or "ID:duplexumi.2" in line for line in pg_f)
    gtext, _, _ = both_cli(tmp_path, "group", provenance_bam, "--duplex")
    assert any("PP:" in line for line in gtext.splitlines() if line.startswith("@PG"))


def test_view_colon_contig_and_unmapped_tail_alike(tmp_path, capsys):
    path = str(tmp_path / "hla.bam")
    n, L = 8, 24
    rng = np.random.default_rng(4)
    pos = np.r_[np.sort(rng.integers(0, 50_000, n - 2)), [-1, -1]]
    write_bam(path, BamHeader.synthetic(ref_names=("HLA-A*01:01:01:01",),
                                        ref_lengths=(100_000,), sort_order="coordinate"),
              _records(np.r_[np.zeros(n - 2), [-1, -1]], pos, np.r_[np.zeros(n - 2), [4, 4]],
                       cigars=[[(L, "M")] for _ in range(n - 2)] + [[], []]))
    for region in ("HLA-A*01:01:01:01", "HLA-A*01:01:01:01:1-100000"):
        res = []
        for fn in (jax_main, cli_main):
            capsys.readouterr()
            assert fn(["view", path, region, "--json"]) == 0
            res.append(json.loads(capsys.readouterr().out.strip().splitlines()[-1]))
        # the first run builds the .bai the second finds ("index" names it)
        res[0].pop("index", None)
        assert res[0] == res[1] and res[1]["n_records"] == n - 2
