"""min_input_qual, the ``filter`` command, ``--max-reads`` and
multi-chromosome input: the port against the JAX package (the contracts
of tests/test_filter.py).

Both CLIs run in process on one simulated input (``JAX_PLATFORMS=cpu``;
the port's call at ``--device cpu``): the consensus BAMs agree at the
parity bar, and ``filter`` on one consensus BAM writes identical
records with the same counters and warnings through either package.
Library calls (the consensus caller, ``downsample_families``,
``records_to_readbatch``, ``call_batch``) take the same seeded batch on
both sides. The JAX suite's own claims are then checked on the port's
output.
"""

from __future__ import annotations

import json
import struct
import warnings

import numpy as np
import pytest

from duplexumiconsensusreads_tpu import types as jt
from duplexumiconsensusreads_tpu.cli.main import main as jax_main
from duplexumiconsensusreads_tpu.io import convert as jax_convert
from duplexumiconsensusreads_tpu.ops import ConsensusCaller as JaxCaller
from duplexumiconsensusreads_tpu.runtime.executor import call_batch_cpu as jax_oracle_call
from duplexumiconsensusreads_tpu.runtime.executor import call_batch_tpu
from duplexumiconsensusreads_tpu.simulate import SimConfig, simulate_batch
from duplexumiconsensusreads_torch import oracle
from duplexumiconsensusreads_torch import types as pt
from duplexumiconsensusreads_torch.cli.main import main as cli_main
from duplexumiconsensusreads_torch.io import convert, read_bam, write_bam
from duplexumiconsensusreads_torch.io.bam import BamHeader
from duplexumiconsensusreads_torch.ops import ConsensusCaller
from duplexumiconsensusreads_torch.runtime.executor import call_batch
from test_torch_cli import assert_parity, assert_same_bam
from test_torch_jumbo import call_parity, to_port


def _cd(aux: bytes) -> int:
    i = aux.find(b"cDi")
    return struct.unpack_from("<i", aux, i + 3)[0]


def _b_arr(aux: bytes, tag: bytes) -> np.ndarray:
    i = aux.find(tag + b"B")
    dt = {b"S": "<u2", b"I": "<u4"}[aux[i + 3:i + 4]]
    (cnt,) = struct.unpack_from("<I", aux, i + 4)
    return np.frombuffer(aux, dt, cnt, i + 8).astype(np.int64)


def both_calls(tmp_path, bam: str, tag: str, *flags, reports=None) -> tuple[str, str]:
    """``call`` through the JAX CLI and the port's (``--device cpu``) on
    one input, each writing its report to ``reports[side]`` if given;
    the outputs agree at the parity bar. Returns (JAX's output, the
    port's)."""
    jout, pout = str(tmp_path / f"{tag}_jax.bam"), str(tmp_path / f"{tag}_port.bam")
    rep = {side: ["--report", reports[side]] if reports else [] for side in ("jax", "port")}
    assert jax_main(["call", bam, "-o", jout, *flags, *rep["jax"]]) == 0
    assert cli_main(["call", bam, "-o", pout, "--device", "cpu", *flags, *rep["port"]]) == 0
    assert_parity(jout, pout, duplex=True)
    return jout, pout


def both_filters(tmp_path, capsys, src: str, *flags) -> tuple[str, list]:
    """``filter`` through both CLIs on one consensus BAM: identical
    records, the same counters and warnings. Returns (the port's
    output, its stderr lines)."""
    outs, errs = {}, {}
    for side, fn in (("jax", jax_main), ("port", cli_main)):
        outs[side] = str(tmp_path / f"filtered_{side}.bam")
        capsys.readouterr()
        assert fn(["filter", src, "-o", outs[side], *flags]) == 0
        errs[side] = [line.split("] ", 1)[1] for line in capsys.readouterr().err.splitlines()
                      if "] " in line]
    assert_same_bam(outs["jax"], outs["port"])
    assert [e.replace("`duplexumi call`", "`call`") for e in errs["jax"]] == errs["port"]
    return outs["port"], errs["port"]


@pytest.fixture(scope="module")
def consensus(tmp_path_factory):
    """tests/test_filter.py's consensus input: 120 molecules, read_len
    40, base error 0.03, called under config3 at capacity 512 by both
    packages."""
    d = tmp_path_factory.mktemp("torch_filter")
    bam = str(d / "in.bam")
    assert cli_main(["simulate", "-o", bam, "--truth", str(d / "t.npz"), "--molecules", "120",
                     "--read-len", "40", "--positions", "8", "--base-error", "0.03", "--sorted",
                     "--seed", "5"]) == 0
    return both_calls(d, bam, "cons", "--config", "config3", "--capacity", "512")


def test_min_input_qual_masks_evidence_and_depth_alike():
    batch, _ = simulate_batch(SimConfig(n_molecules=30, duplex=False, qual_lo=10, qual_hi=40,
                                        seed=3))
    pb = to_port(batch, pt.ReadBatch)
    fams = oracle.group_reads(pb, pt.GroupingParams(strategy="exact"))
    jf = to_port(fams, jt.FamilyAssignment)
    depth = {}
    for miq in (0, 25, 35):
        cp = pt.ConsensusParams(mode="single_strand", min_input_qual=miq)
        jcp = jt.ConsensusParams(**vars(cp))
        cpu = ConsensusCaller(cp, backend="cpu")(pb, fams)
        jcpu = JaxCaller(jcp, backend="cpu")(batch, jf)
        for f in ("bases", "quals", "depth", "valid"):
            np.testing.assert_array_equal(getattr(cpu, f), getattr(jcpu, f), err_msg=f)
        dev = ConsensusCaller(cp, backend="cuda", device="cpu")(pb, fams)
        jdev = JaxCaller(jcp, backend="tpu")(batch, jf)
        cv = np.asarray(cpu.valid, bool)
        n = len(cv)
        for f in ("depth", "bases"):
            got = np.asarray(getattr(dev, f))[:n][cv]
            np.testing.assert_array_equal(got, np.asarray(getattr(jdev, f))[:n][cv], err_msg=f)
            np.testing.assert_array_equal(got, np.asarray(getattr(cpu, f))[cv], err_msg=f)
        depth[miq] = np.asarray(cpu.depth).sum()
    assert depth[35] < depth[0]


def test_filter_min_depth_alike(consensus, tmp_path, capsys):
    out, _ = both_filters(tmp_path, capsys, consensus[0], "--min-depth", "4")
    _, before = read_bam(consensus[0])
    _, after = read_bam(out)
    assert 0 < len(after) < len(before)
    assert all(_cd(a) >= 4 for a in after.aux_raw)
    assert sum(_cd(a) < 4 for a in before.aux_raw) == len(before) - len(after)


def test_filter_mask_and_nfrac_alike(consensus, tmp_path, capsys):
    out, _ = both_filters(tmp_path, capsys, consensus[1], "--mask-qual", "60",
                          "--max-n-frac", "0.5")
    _, after = read_bam(out)
    for i in range(len(after)):
        l = int(after.lengths[i])
        q, s = after.qual[i, :l], after.seq[i, :l]
        assert ((q >= 60) | ((s == 4) & (q == 2))).all()
        assert (s == 4).sum() <= 0.5 * l


def test_filter_foreign_int_types_and_missing_tags_alike(consensus, tmp_path, capsys):
    """cD as int16 and cM as uint8 (another writer's flavour), and one
    record with no depth tags: counted and warned about, the same way."""
    header, recs = read_bam(consensus[1])
    for i in range(len(recs)):
        a = recs.aux_raw[i]
        j, k = a.find(b"cDi"), a.find(b"cMi")
        cd, cm = struct.unpack_from("<i", a, j + 3)[0], struct.unpack_from("<i", a, k + 3)[0]
        recs.aux_raw[i] = a[:j] if i == 0 else (
            a[:j] + b"cDs" + struct.pack("<h", cd) + b"cMC" + struct.pack("<B", min(cm, 255)))
    foreign = str(tmp_path / "foreign.bam")
    write_bam(foreign, header, recs)
    out, err = both_filters(tmp_path, capsys, foreign, "--min-depth", "1")
    assert any("1 records lack a required depth tag" in e for e in err)
    assert len(read_bam(out)[1]) == len(recs) - 1


def test_filter_passthrough_identity_alike(consensus, tmp_path, capsys):
    out, _ = both_filters(tmp_path, capsys, consensus[1])
    _, a = read_bam(consensus[1])
    _, b = read_bam(out)
    assert a.names == b.names
    np.testing.assert_array_equal(a.seq, b.seq)
    np.testing.assert_array_equal(a.qual, b.qual)


def test_mixed_mates_warn_alike():
    """A family holding R1 and R2 mates warns in both packages, with the
    same batch; the simulator's paired-end convention warns in
    neither."""
    from duplexumiconsensusreads_torch.io.bam import (
        FLAG_MATE_REVERSE,
        FLAG_PAIRED,
        FLAG_READ1,
        FLAG_READ2,
        FLAG_REVERSE,
    )

    _, recs, _, _ = convert.simulated_bam(SimConfig(n_molecules=20, duplex=False, seed=8),
                                          sort=True)
    _, jrecs, _, _ = jax_convert.simulated_bam(SimConfig(n_molecules=20, duplex=False, seed=8),
                                               sort=True)
    flags = np.asarray(recs.flags).copy()
    flags[::2] = FLAG_PAIRED | FLAG_READ1 | FLAG_MATE_REVERSE
    flags[1::2] = FLAG_PAIRED | FLAG_READ2 | FLAG_REVERSE
    recs.flags = jrecs.flags = flags.astype(np.uint16)
    with pytest.warns(UserWarning, match="R1 and R2 mates"):
        ours, info = convert.records_to_readbatch(recs, duplex=False)
    with pytest.warns(UserWarning, match="R1 and R2 mates"):
        theirs, jinfo = jax_convert.records_to_readbatch(jrecs, duplex=False)
    assert info == jinfo
    for f in ("bases", "umi", "pos_key", "strand_ab", "frag_end", "valid"):
        np.testing.assert_array_equal(getattr(ours, f), getattr(theirs, f), err_msg=f)
    _, recs2, _, _ = convert.simulated_bam(SimConfig(n_molecules=20, duplex=True, seed=9),
                                           sort=True, paired_end=True)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        convert.records_to_readbatch(recs2, duplex=True)


def test_multi_chromosome_grouping_and_call_alike(tmp_path):
    """One UMI at one coordinate on two chromosomes: two families in the
    port, the JAX device path and the oracle, and the BAM round trip
    keeps the two references apart."""
    rng = np.random.default_rng(9)
    n, l, u = 60, 30, 6
    half = n // 2
    seq1, seq2 = (rng.integers(0, 4, size=l, dtype=np.uint8) for _ in range(2))
    bases = np.r_[np.tile(seq1, (half, 1)), np.tile(seq2, (n - half, 1))]
    err = rng.random((n, l)) < 0.05
    bases[err] = (bases[err] + 1) % 4
    batch = jt.ReadBatch(
        bases=bases, quals=np.full((n, l), 30, np.uint8),
        umi=np.tile(rng.integers(0, 4, size=u, dtype=np.uint8), (n, 1)),
        pos_key=convert.pack_pos_key(np.r_[np.zeros(half, np.int64), np.ones(n - half, np.int64)],
                                     np.full(n, 500, np.int64)),
        strand_ab=np.ones(n, bool), frag_end=np.zeros(n, bool), valid=np.ones(n, bool))
    gp, cp = jt.GroupingParams(strategy="exact"), jt.ConsensusParams(mode="single_strand")
    ours = call_batch(to_port(batch, pt.ReadBatch), pt.GroupingParams(**vars(gp)),
                      pt.ConsensusParams(**vars(cp)), capacity=64, device="cpu")
    call_parity(ours, call_batch_tpu(batch, gp, cp, capacity=64), duplex=False)
    call_parity(ours, jax_oracle_call(batch, gp, cp), duplex=False, oracle=True)
    assert len(ours[0]) == 2
    recs = convert.readbatch_to_records(to_port(batch, pt.ReadBatch), duplex=False)
    p = str(tmp_path / "multi.bam")
    write_bam(p, BamHeader.synthetic(ref_names=("chr1", "chr2"), ref_lengths=(10_000, 10_000)),
              recs)
    h2, recs2 = read_bam(p)
    assert h2.ref_names == ["chr1", "chr2"]
    batch2, _ = convert.records_to_readbatch(recs2, duplex=False)
    assert len(np.unique(np.asarray(batch2.pos_key))) == 2


def _downsample_batch():
    rng = np.random.default_rng(3)
    n, l, u = 40, 20, 6
    umi = np.tile(rng.integers(0, 4, size=u, dtype=np.uint8), (n, 1))
    umi[20:, 0] = (umi[20:, 0] + 1) % 4  # two families of 20
    return pt.ReadBatch(
        bases=rng.integers(0, 4, size=(n, l), dtype=np.uint8),
        quals=rng.integers(10, 41, size=(n, l), dtype=np.uint8), umi=umi,
        pos_key=np.full(n, 777, np.int64), strand_ab=np.ones(n, bool),
        frag_end=np.zeros(n, bool), valid=np.ones(n, bool))


def _one_pos_umi(batch):
    batch.umi[:] = batch.umi[0]
    batch.strand_ab[:20] = False
    batch.frag_end[10:20] = True
    return batch


@pytest.mark.parametrize("edit, max_reads, dropped", [
    (None, 5, 30),
    (_one_pos_umi, 4, (10 - 4) + (10 - 4) + (20 - 4)),
    (None, 3, 34),
    (None, 0, 0),
], ids=["top_quality_per_family", "strands_and_ends_apart", "deterministic", "zero_is_off"])
def test_downsample_families_alike(edit, max_reads, dropped):
    """downsample_families keeps the same reads as the JAX package's:
    the top-quality ``max_reads`` of each (family, strand, end)."""
    ours = _downsample_batch()
    if edit:
        ours = edit(ours)
    theirs = to_port(ours, jt.ReadBatch)
    assert convert.downsample_families(ours, max_reads) == dropped
    assert jax_convert.downsample_families(theirs, max_reads) == dropped
    np.testing.assert_array_equal(ours.valid, theirs.valid)
    if edit is None and max_reads == 5:
        score = (ours.quals.astype(int) * (ours.bases < 4)).sum(axis=1)
        for fam in (np.arange(20), np.arange(20, 40)):
            kept = fam[ours.valid[fam]]
            assert len(kept) == 5 and set(score[kept]) == set(np.sort(score[fam])[-5:])


def test_cli_max_reads_end_to_end_alike(tmp_path):
    """--max-reads 3: whole file and 150-read chunks agree in the port,
    the JAX CLI agrees at the parity bar, the reports count the same
    dropped reads, and no consensus saw more than 2 x 3 reads."""
    bam = str(tmp_path / "in.bam")
    assert cli_main(["simulate", "-o", bam, "--molecules", "60", "--family-size", "8",
                     "--max-family-size", "16", "--sorted", "--seed", "2"]) == 0
    flags = ["--config", "config3", "--capacity", "256", "--max-reads", "3"]
    reps = {k: str(tmp_path / f"{k}.json") for k in ("jax", "port", "stream")}
    _, pout = both_calls(tmp_path, bam, "whole", *flags, reports=reps)
    sout = str(tmp_path / "stream.bam")
    assert cli_main(["call", bam, "-o", sout, "--device", "cpu", *flags, "--chunk-reads", "150",
                     "--report", reps["stream"]]) == 0
    r = {k: json.load(open(v)) for k, v in reps.items()}
    assert r["port"]["n_downsampled_reads"] > 0
    assert (r["port"]["n_downsampled_reads"] == r["stream"]["n_downsampled_reads"]
            == r["jax"]["n_downsampled_reads"])
    _, a = read_bam(pout)
    _, b = read_bam(sout)
    assert len(a) == len(b) > 0
    np.testing.assert_array_equal(a.seq, b.seq)
    np.testing.assert_array_equal(a.qual, b.qual)
    assert all(_cd(aux) <= 6 for aux in a.aux_raw)


@pytest.fixture(scope="module")
def per_base(tmp_path_factory):
    """Per-base-tag consensus BAMs of two inputs (config3, capacity 256)
    from both packages, and one without the tags."""
    d = tmp_path_factory.mktemp("torch_filter_pb")
    out = {}
    for name, extra in (("depth", ["--molecules", "40", "--seed", "8"]),
                        ("error", ["--molecules", "50", "--base-error", "0.08", "--seed", "9"])):
        bam = str(d / f"{name}.bam")
        assert cli_main(["simulate", "-o", bam, "--read-len", "30", "--positions", "4",
                         "--sorted", *extra]) == 0
        flags = ["--config", "config3", "--capacity", "256"]
        out[name] = both_calls(d, bam, name, *flags, "--per-base-tags")
        out[name + "_plain"] = both_calls(d, bam, name + "_plain", *flags)
    return out


def test_filter_min_base_depth_masks_shallow_cycles_alike(per_base, tmp_path, capsys):
    _, before = read_bam(per_base["depth"][1])
    depths = np.concatenate([_b_arr(a, b"cd") for a in before.aux_raw])
    thr = int(depths.max())
    out, err = both_filters(tmp_path, capsys, per_base["depth"][1], "--min-base-depth", str(thr))
    _, after = read_bam(out)
    n_shallow = int((depths < thr).sum())
    n_masked = sum(int(((after.seq[k][:after.lengths[k]] == 4)
                        & (_b_arr(after.aux_raw[k], b"cd")[:after.lengths[k]] < thr)).sum())
                   for k in range(len(after)))
    assert n_shallow > 0 and n_masked >= n_shallow * 0.9
    assert any("masked" in e for e in err)
    out2, err2 = both_filters(tmp_path, capsys, per_base["depth_plain"][1],
                              "--min-base-depth", "2")
    assert any("lack a usable per-base cd array" in e for e in err2)
    assert len(read_bam(out2)[1]) == len(before)


def test_filter_error_rate_thresholds_alike(per_base, tmp_path, capsys):
    _, before = read_bam(per_base["error"][1])
    rates = np.asarray([_b_arr(a, b"ce").sum() / max(int(_b_arr(a, b"cd").sum()), 1)
                        for a in before.aux_raw])
    thr = float(np.median(rates))
    want_drop = int((rates > thr).sum())
    assert 0 < want_drop < len(before)
    out, _ = both_filters(tmp_path, capsys, per_base["error"][1], "--max-read-error-rate",
                          str(thr))
    assert len(read_bam(out)[1]) == len(before) - want_drop
    out2, _ = both_filters(tmp_path, capsys, per_base["error"][1], "--max-base-error-rate", "0.0")
    _, after2 = read_bam(out2)
    assert len(after2) == len(before)
    for k in range(len(after2)):
        li = int(after2.lengths[k])
        assert not np.any((_b_arr(after2.aux_raw[k], b"ce")[:li] > 0)
                          & (after2.seq[k][:li] != 4)), k
    out3, err3 = both_filters(tmp_path, capsys, per_base["error_plain"][1],
                              "--max-read-error-rate", "0.01")
    assert any("skipped the error-rate filters" in e for e in err3)
    assert len(read_bam(out3)[1]) == len(before)
