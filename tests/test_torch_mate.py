"""Mate-aware paired-end grouping and consensus: the port against the
JAX package (the contracts of tests/test_mate.py).

The same seeded batch goes through both packages' grouping (the oracle
and the port's device grouper on the CPU) and through ``call_batch``
against ``call_batch_tpu`` and the oracle; the same BAM through both
CLIs (the port at ``--device cpu``). Grouping ids are identical,
consensus rows agree at the parity bar, reports count the same pairs.
The JAX suite's claims (identity without second-end reads, the fgbio
top-R1/bottom-R2 pairing, truth on both fragment ends, linked pairs,
the auto resolution and its warning) are then checked on the port.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest

from duplexumiconsensusreads_tpu import oracle as jax_oracle
from duplexumiconsensusreads_tpu import types as jt
from duplexumiconsensusreads_tpu.cli.main import main as jax_main
from duplexumiconsensusreads_tpu.runtime.executor import call_batch_cpu as jax_oracle_call
from duplexumiconsensusreads_tpu.runtime.executor import call_batch_tpu
from duplexumiconsensusreads_tpu.runtime.executor import resolve_mate_aware as jax_resolve
from duplexumiconsensusreads_tpu.simulate import SimConfig, simulate_batch
from duplexumiconsensusreads_torch import oracle
from duplexumiconsensusreads_torch import types as pt
from duplexumiconsensusreads_torch.cli.main import main as cli_main
from duplexumiconsensusreads_torch.io import read_bam, simulated_bam, write_bam
from duplexumiconsensusreads_torch.io.bam import (
    FLAG_PAIRED,
    FLAG_PROPER_PAIR,
    FLAG_READ1,
    FLAG_READ2,
    BamRecords,
)
from duplexumiconsensusreads_torch.io.convert import records_to_readbatch
from duplexumiconsensusreads_torch.ops import UmiGrouper
from duplexumiconsensusreads_torch.runtime.executor import call_batch, resolve_mate_aware
from duplexumiconsensusreads_torch.utils.phred import umi_sort_keys
from test_torch_cli import assert_parity
from test_torch_jumbo import call_parity, to_port

PAIRED_CFG = SimConfig(n_molecules=60, read_len=40, n_positions=8, mean_family_size=4,
                       duplex=True, paired_reads=True, umi_error=0.02, seed=21)
FAMS = ("family_id", "molecule_id", "pair_id", "n_families", "n_molecules")


def _take_records(recs, idx) -> BamRecords:
    """The records at ``idx`` (the JAX CLI's helper of the same name; the
    port's CLI has no use for it)."""
    out = {}
    for f in dataclasses.fields(BamRecords):
        v = getattr(recs, f.name)
        out[f.name] = [v[i] for i in idx] if isinstance(v, list) else v[idx]
    return BamRecords(**out)


def _assert_fams_equal(a, b):
    for f in FAMS:
        np.testing.assert_array_equal(np.asarray(getattr(a, f)), np.asarray(getattr(b, f)),
                                      err_msg=f)


def _params(strategy="adjacency", paired=True, mate_aware=True, mode="duplex"):
    return jt.GroupingParams(strategy=strategy, paired=paired, mate_aware=mate_aware), \
        jt.ConsensusParams(mode=mode)


def _port_call(batch, gp, cp, capacity):
    return call_batch(to_port(batch, pt.ReadBatch), pt.GroupingParams(**vars(gp)),
                      pt.ConsensusParams(**vars(cp)), capacity=capacity, device="cpu")


def _sorted_rows(t):
    cb, cq, cd, _, fp, fu = t[:6]
    order = np.lexsort((*reversed(umi_sort_keys(fu)), fp))
    return cb[order], cq[order], cd[order], fp[order], fu[order]


@pytest.mark.parametrize("strategy", ["exact", "adjacency"])
@pytest.mark.parametrize("paired", [True, False])
def test_no_second_end_grouping_identity_alike(strategy, paired):
    """Without second-end reads mate_aware groups exactly as classic
    grouping, in the port's oracle and device grouper as in JAX's."""
    batch, _ = simulate_batch(SimConfig(n_molecules=50, duplex=True, umi_error=0.02, seed=5))
    assert not np.asarray(batch.frag_end).any()
    pb = to_port(batch, pt.ReadBatch)
    base = None
    for mate_aware in (False, True):
        gp = pt.GroupingParams(strategy=strategy, paired=paired, mate_aware=mate_aware)
        fams = oracle.group_reads(pb, gp)
        _assert_fams_equal(fams, jax_oracle.group_reads(batch, jt.GroupingParams(**vars(gp))))
        _assert_fams_equal(UmiGrouper(gp, backend="cuda", device="cpu")(pb), fams)
        if base is None:
            base = fams
        _assert_fams_equal(base, fams)


def test_no_second_end_consensus_identity_alike():
    batch, _ = simulate_batch(SimConfig(n_molecules=40, duplex=True, umi_error=0.02, seed=6))
    outs = []
    for mate_aware in (False, True):
        gp, cp = _params(mate_aware=mate_aware)
        outs.append(_port_call(batch, gp, cp, 256))
        call_parity(outs[-1], call_batch_tpu(batch, gp, cp, capacity=256), duplex=True)
    for a, b in zip(_sorted_rows(outs[0]), _sorted_rows(outs[1])):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("strategy", ["exact", "adjacency"])
def test_device_grouper_matches_the_oracles_on_paired_mates(strategy):
    batch, _ = simulate_batch(PAIRED_CFG)
    gp = pt.GroupingParams(strategy=strategy, paired=True, mate_aware=True)
    pb = to_port(batch, pt.ReadBatch)
    fams = oracle.group_reads(pb, gp)
    _assert_fams_equal(UmiGrouper(gp, backend="cuda", device="cpu")(pb), fams)
    _assert_fams_equal(fams, jax_oracle.group_reads(batch, jt.GroupingParams(**vars(gp))))


def test_duplex_pipeline_matches_jax_and_the_oracle_on_paired_mates():
    batch, _ = simulate_batch(PAIRED_CFG)
    gp, cp = _params()
    ours = _port_call(batch, gp, cp, 256)
    call_parity(ours, call_batch_tpu(batch, gp, cp, capacity=256), duplex=True)
    c = jax_oracle_call(batch, gp, cp)
    assert len(ours[0]) == len(c[0]) > 0
    ts, cs = _sorted_rows(ours), _sorted_rows(c)
    for i in (0, 3, 4):
        np.testing.assert_array_equal(ts[i], cs[i])
    dq = np.abs(ts[1].astype(int) - cs[1].astype(int))
    assert (dq <= 3).all() and (dq <= 1).mean() > 0.97


def test_units_pair_top_r1_with_bottom_r2_alike():
    batch, _ = simulate_batch(PAIRED_CFG)
    gp = pt.GroupingParams(strategy="exact", paired=True, mate_aware=True)
    fams = oracle.group_reads(to_port(batch, pt.ReadBatch), gp)
    _assert_fams_equal(fams, jax_oracle.group_reads(batch, jt.GroupingParams(**vars(gp))))
    mol = np.asarray(fams.molecule_id)
    s = np.asarray(batch.strand_ab, bool)
    e2 = np.asarray(batch.frag_end, bool)
    r2 = e2 ^ ~s
    for unit in np.unique(mol[mol >= 0])[:50]:
        sel = mol == unit
        assert len(np.unique(e2[sel])) == 1
        top_r2, bottom_r2 = r2[sel][s[sel]], r2[sel][~s[sel]]
        if not e2[sel][0]:
            assert not top_r2.any() and (bottom_r2.all() or bottom_r2.size == 0)
        else:
            assert (top_r2.all() or top_r2.size == 0) and not bottom_r2.any()


def test_ss_mate_aware_equals_split_by_readnumber_in_the_port(tmp_path):
    """Single-strand mate-aware calling on a mixed-mate BAM equals the
    split-by-read-number workflow row for row in the port (exact
    grouping), and the JAX package's mate-aware call."""
    bam = str(tmp_path / "in.bam")
    simulated_bam(PAIRED_CFG, path=bam, sort=True)
    _, recs = read_bam(bam)
    flags = np.asarray(recs.flags)
    cp = pt.ConsensusParams(mode="single_strand")
    split = []
    for want in (FLAG_READ1, FLAG_READ2):
        b, _ = records_to_readbatch(_take_records(recs, np.nonzero(flags & want)[0]), duplex=True)
        split.append(_sorted_rows(call_batch(b, pt.GroupingParams("exact", paired=True), cp,
                                             capacity=256, device="cpu")))
    gp = pt.GroupingParams("exact", paired=True, mate_aware=True)
    full_b, info = records_to_readbatch(recs, duplex=True, warn_mixed=False)
    assert info["mixed_mates"]
    full_out = call_batch(full_b, gp, cp, capacity=256, device="cpu")
    call_parity(full_out, call_batch_tpu(to_port(full_b, jt.ReadBatch),
                                         jt.GroupingParams(**vars(gp)),
                                         jt.ConsensusParams(**vars(cp)), capacity=256),
                duplex=False)
    full = _sorted_rows(full_out)

    def rowset(parts):
        return sorted((int(parts[3][i]), parts[4][i].tobytes(), parts[0][i].tobytes(),
                       parts[1][i].tobytes(), parts[2][i].tobytes())
                      for i in range(len(parts[0])))

    merged = [np.concatenate([a, b]) for a, b in zip(*split)]
    assert len(full[0]) == len(merged[0]) > 0
    assert rowset(full) == rowset(merged)


def test_duplex_mate_aware_validates_against_both_truths_in_the_port():
    cfg = SimConfig(n_molecules=80, read_len=40, n_positions=8, mean_family_size=5, duplex=True,
                    paired_reads=True, base_error=0.01, seed=22)
    batch, truth = simulate_batch(cfg)
    key_to_mol = {(int(truth.mol_pos_key[m]), truth.mol_umi[m].tobytes()): m
                  for m in range(len(truth.mol_seq))}

    def error_rate(mate_aware):
        gp, cp = _params("exact", mate_aware=mate_aware)
        out = _port_call(batch, gp, cp, 512)
        call_parity(out, call_batch_tpu(batch, gp, cp, capacity=512), duplex=True)
        cb, fp, fu, mate = out[0], out[4], out[5], out[6]
        errs = bases = 0
        for i in range(len(cb)):
            m = key_to_mol[(int(fp[i]), fu[i].tobytes())]
            true = truth.mol_seq2[m] if mate[i] else truth.mol_seq[m]
            real = cb[i] != 4
            errs += int((cb[i][real] != true[real]).sum())
            bases += int(real.sum())
        return errs / max(bases, 1), int((mate == 0).sum()), int((mate == 1).sum())

    rate_on, n_r1, n_r2 = error_rate(True)
    assert n_r1 > 0 and n_r2 > 0 and rate_on < 1e-3
    assert error_rate(False)[0] > 0.2


def _both_cli(tmp_path, bam, *flags, warns=None):
    """``call`` through both CLIs on one BAM (the port at --device cpu):
    the parity bar, and the reports. Returns (the port's report, its
    output, JAX's report)."""
    out = {s: str(tmp_path / f"o_{s}.bam") for s in ("jax", "port")}
    rep = {s: str(tmp_path / f"r_{s}.json") for s in ("jax", "port")}
    for side, fn, extra in (("jax", jax_main, []), ("port", cli_main, ["--device", "cpu"])):
        argv = ["call", bam, "-o", out[side], *flags, "--report", rep[side], *extra]
        if warns:
            with pytest.warns(UserWarning, match=warns):
                assert fn(argv) == 0
        else:
            assert fn(argv) == 0
    duplex = "ss" not in flags
    if json.load(open(rep["port"]))["n_consensus"]:
        assert_parity(out["jax"], out["port"], duplex=duplex)
    pr, jr = (json.load(open(rep[s])) for s in ("port", "jax"))
    for k in ("mate_aware", "n_consensus", "n_consensus_pairs", "n_records", "n_valid_reads"):
        assert pr[k] == jr[k], k
    return pr, out["port"]


def test_cli_mate_aware_end_to_end_alike(tmp_path, capsys, recwarn):
    bam, truth = str(tmp_path / "in.bam"), str(tmp_path / "t.npz")
    assert cli_main(["simulate", "-o", bam, "--truth", truth, "--molecules", "150", "--read-len",
                     "50", "--positions", "16", "--family-size", "5", "--paired-reads",
                     "--umi-error", "0.02", "--sorted", "--seed", "31"]) == 0
    rep, out = _both_cli(tmp_path, bam, "--config", "config3", "--capacity", "512")
    assert rep["mate_aware"] is True and rep["n_consensus_pairs"] > 0
    assert not [w for w in recwarn if "R1 and R2" in str(w.message)]
    _, recs = read_bam(out)
    flags = np.asarray(recs.flags)
    pp = FLAG_PAIRED | FLAG_PROPER_PAIR
    r1 = (flags & (pp | FLAG_READ1)) == (pp | FLAG_READ1)
    r2 = (flags & (pp | FLAG_READ2)) == (pp | FLAG_READ2)
    assert r1.sum() == r2.sum() == rep["n_consensus_pairs"]
    names = np.asarray(recs.names)
    for i in np.nonzero(r1)[0][:20]:
        j = np.nonzero(names == names[i])[0]
        other = j[j != i][0]
        assert len(j) == 2 and r2[other]
        assert recs.pos[i] == recs.next_pos[i] == recs.pos[other]
    capsys.readouterr()
    assert cli_main(["validate", out, "--truth", truth, "--json"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["n_consensus_pairs"] == rep["n_consensus_pairs"]
    assert res["n_matched_to_truth"] > 0.9 * res["n_consensus"] and res["error_rate"] < 1e-3


def test_pair_links_survive_class_dispatch_alike():
    batch, _ = simulate_batch(SimConfig(n_molecules=120, read_len=32, n_positions=40,
                                        mean_family_size=4, duplex=True, paired_reads=True,
                                        umi_error=0.02, seed=13))
    gp, cp = _params()
    ours = _port_call(batch, gp, cp, 128)
    call_parity(ours, call_batch_tpu(batch, gp, cp, capacity=128), duplex=True)

    def n_pairs(parts):
        pair, mate = parts[7], parts[6]
        vals, cnt = np.unique(pair[pair >= 0], return_counts=True)
        return sum(1 for v, k in zip(vals, cnt) if k == 2 and set(mate[pair == v]) == {0, 1})

    assert n_pairs(ours) == n_pairs(jax_oracle_call(batch, gp, cp)) > 0


def test_cli_mate_aware_off_warns_alike(tmp_path):
    bam = str(tmp_path / "in.bam")
    assert cli_main(["simulate", "-o", bam, "--molecules", "40", "--read-len", "30",
                     "--paired-reads", "--sorted", "--seed", "3"]) == 0
    rep, _ = _both_cli(tmp_path, bam, "--config", "config3", "--capacity", "256",
                       "--mate-aware", "off", warns="R1 and R2 mates")
    assert rep["mate_aware"] is False


def test_stream_matches_whole_file_on_paired_input_in_the_port(tmp_path):
    bam = str(tmp_path / "in.bam")
    simulated_bam(SimConfig(n_molecules=120, read_len=36, n_positions=24, duplex=True,
                            paired_reads=True, umi_error=0.02, seed=17), path=bam, sort=True)
    flags = ["--config", "config3", "--capacity", "256", "--device", "cpu"]
    whole, streamed = str(tmp_path / "whole.bam"), str(tmp_path / "stream.bam")
    assert cli_main(["call", bam, "-o", whole, *flags]) == 0
    assert cli_main(["call", bam, "-o", streamed, *flags, "--chunk-reads", "300"]) == 0

    def rows(recs):
        fl = np.asarray(recs.flags)
        out = {}
        for i in range(len(recs)):
            key = (int(recs.pos[i]), recs.umi[i], bool(fl[i] & FLAG_READ2))
            assert key not in out
            out[key] = (recs.seq[i].tobytes(), recs.qual[i].tobytes())
        return out

    a, b = read_bam(whole)[1], read_bam(streamed)[1]
    assert len(a) == len(b) > 0 and rows(a) == rows(b)
    assert ((np.asarray(a.flags) & FLAG_PAIRED) != 0).sum() > 0


def test_classic_paired_end_flags_stay_single_alike(tmp_path):
    bam = str(tmp_path / "in.bam")
    simulated_bam(SimConfig(n_molecules=40, read_len=30, duplex=True, seed=12), path=bam,
                  sort=True, paired_end=True)
    rep, out = _both_cli(tmp_path, bam, "--config", "config3", "--capacity", "256")
    assert rep["mate_aware"] is False
    assert (np.asarray(read_bam(out)[1].flags) == 0).all()


def test_split_by_readnumber_input_resolves_off_alike(tmp_path):
    bam = str(tmp_path / "in.bam")
    simulated_bam(PAIRED_CFG, path=bam, sort=True)
    header, recs = read_bam(bam)
    split = str(tmp_path / "r1.bam")
    write_bam(split, header, _take_records(recs, np.nonzero(np.asarray(recs.flags)
                                                            & FLAG_READ1)[0]))
    rep, _ = _both_cli(tmp_path, split, "--config", "config3", "--capacity", "256")
    assert rep["mate_aware"] is False and rep["n_consensus"] > 0


def test_ss_unpaired_mate_aware_pairs_by_fragment_end_alike(tmp_path, capsys):
    bam, truth = str(tmp_path / "in.bam"), str(tmp_path / "t.npz")
    assert cli_main(["simulate", "-o", bam, "--truth", truth, "--molecules", "80", "--read-len",
                     "40", "--positions", "8", "--family-size", "5", "--paired-reads",
                     "--sorted", "--seed", "41"]) == 0
    rep, out = _both_cli(tmp_path, bam, "--mode", "ss", "--grouping", "exact", "--capacity",
                         "512")
    assert rep["mate_aware"] is True and rep["n_consensus_pairs"] > 0
    capsys.readouterr()
    assert cli_main(["validate", out, "--truth", truth, "--json"]) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["error_rate"] < 1e-2


def test_resumed_stream_reports_pairs_in_the_port(tmp_path):
    from duplexumiconsensusreads_torch.runtime.stream import stream_call_consensus

    bam = str(tmp_path / "in.bam")
    simulated_bam(PAIRED_CFG, path=bam, sort=True)
    gp, cp = pt.GroupingParams(strategy="adjacency", paired=True), pt.ConsensusParams("duplex")
    ck = str(tmp_path / "ck.json")
    kw = dict(capacity=256, chunk_reads=300, checkpoint_path=ck, device="cpu")
    rep1 = stream_call_consensus(bam, str(tmp_path / "o1.bam"), gp, cp, **kw)
    assert rep1.mate_aware and rep1.n_consensus_pairs > 0
    rep2 = stream_call_consensus(bam, str(tmp_path / "o2.bam"), gp, cp, resume=True, **kw)
    assert rep2.n_chunks_skipped == rep2.n_chunks > 0
    assert (rep2.n_consensus_pairs, rep2.n_consensus) == (rep1.n_consensus_pairs,
                                                          rep1.n_consensus)


@pytest.mark.parametrize("info, setting", [
    ({"mixed_mates": True}, "auto"), ({"mixed_mates": False}, "auto"), ({}, "auto"),
    ({}, "on"), ({"mixed_mates": True}, "off"), ({}, "bogus"),
])
def test_resolve_mate_aware_settings_alike(info, setting):
    gp = pt.GroupingParams(paired=True)
    jgp = jt.GroupingParams(paired=True)
    if setting == "bogus":
        with pytest.raises(ValueError):
            resolve_mate_aware(gp, info, setting)
        with pytest.raises(ValueError):
            jax_resolve(jgp, info, setting)
        return
    assert resolve_mate_aware(gp, info, setting).mate_aware == \
        jax_resolve(jgp, info, setting).mate_aware


def test_npz_without_frag_end_loads_alike(tmp_path):
    from duplexumiconsensusreads_tpu.io.npz import load_readbatch as jax_load
    from duplexumiconsensusreads_torch.io.npz import load_readbatch

    batch, _ = simulate_batch(SimConfig(n_molecules=10, seed=1))
    p = str(tmp_path / "old.npz")
    with open(p, "wb") as f:
        np.savez_compressed(f, **{k: np.asarray(getattr(batch, k)) for k in
                                  ("bases", "quals", "umi", "pos_key", "strand_ab", "valid")})
    ours, theirs = load_readbatch(p), jax_load(p)
    assert not np.asarray(ours.frag_end).any()
    for f in ("bases", "quals", "umi", "pos_key", "strand_ab", "frag_end", "valid"):
        np.testing.assert_array_equal(np.asarray(getattr(ours, f)),
                                      np.asarray(getattr(theirs, f)), err_msg=f)
