"""The CIGAR policy, the port against the JAX package (the contracts of
tests/test_cigar.py).

Within each family, reads whose CIGAR is not the family's modal one are
dropped at input conversion, except a minority that differs by soft
clips only, which is trimmed and shifted into the modal cycle space.
The same records go through both packages' ``modal_cigar_keep``,
``cigar_hashes``, ``inject_indels``, ``records_to_readbatch`` and native
loaders: identical keeps, hashes, batches and counters. End to end,
both CLIs call an indel simulation at the parity bar with the same
drop counts, and the port's consensus is checked against the truth.
"""

from __future__ import annotations

import json
import struct

import numpy as np
import pytest

from duplexumiconsensusreads_tpu.cli.main import main as jax_main
from duplexumiconsensusreads_tpu.io import convert as jconv
from duplexumiconsensusreads_tpu.io.native_reader import read_bam_native as jax_native
from duplexumiconsensusreads_torch.cli.main import main as cli_main
from duplexumiconsensusreads_torch.constants import BASE_PAD
from duplexumiconsensusreads_torch.io import convert, read_bam, simulated_bam, write_bam
from duplexumiconsensusreads_torch.io.bam import (
    FLAG_PAIRED,
    FLAG_READ1,
    FLAG_READ2,
    FLAG_REVERSE,
    BamHeader,
    BamRecords,
)
from duplexumiconsensusreads_torch.io.native_reader import read_bam_native
from duplexumiconsensusreads_torch.simulate import SimConfig
from test_torch_cli import assert_parity

FIELDS = ("bases", "quals", "umi", "pos_key", "strand_ab", "frag_end", "valid")
CIGAR_COUNTERS = ("n_rescued_cigar", "n_dropped_cigar", "n_dropped_cigar_ab",
                  "n_dropped_cigar_ba")


def convert_alike(recs, duplex: bool, path: str | None = None):
    """records_to_readbatch of both packages (and both native loaders on
    ``path``): identical batches and info. Returns the port's."""
    batch, info = convert.records_to_readbatch(recs, duplex=duplex)
    outs = [jconv.records_to_readbatch(recs, duplex=duplex)]
    if path:
        outs += [read_bam_native(path, duplex=duplex)[1:], jax_native(path, duplex=duplex)[1:]]
    for b, i in outs:
        for k in CIGAR_COUNTERS:
            assert i[k] == info[k], k
        for f in FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(b, f)),
                                          np.asarray(getattr(batch, f)), err_msg=f)
    assert outs[0][1] == info
    return batch, info


@pytest.mark.parametrize("hashes, strand, keep", [
    ([7, 7, 7, 7, 12345, 999], None, [True, True, True, True, False, True]),
    ([7, 7, 7, 9, 9], [True, True, True, False, False], [True] * 5),
    ([7, 7, 12, 9, 9], [True, True, True, False, False], [True, True, False, True, True]),
    ([9, 9, 3, 3], None, [False, False, True, True]),
], ids=["minority_dropped", "per_strand", "minority_within_a_strand", "tie_to_smaller_hash"])
def test_modal_cigar_keep_alike(hashes, strand, keep):
    n = len(hashes)
    pos = np.zeros(n, np.int64)
    if n == 6:
        pos[:] = [5, 5, 5, 5, 5, 9]
    args = (pos, np.zeros((n, 4), np.uint8), np.ones(n, bool), np.array(hashes, np.uint64))
    if strand is not None:
        args += (np.array(strand),)
    ours = convert.modal_cigar_keep(*args)
    np.testing.assert_array_equal(ours, jconv.modal_cigar_keep(*args))
    np.testing.assert_array_equal(ours, keep)


def test_all_indel_family_is_kept_alike():
    _, recs, _, _ = simulated_bam(SimConfig(n_molecules=20, duplex=True, seed=2), sort=True)
    batch0, _ = convert.records_to_readbatch(recs, duplex=True)
    key = np.asarray(batch0.pos_key)
    members = np.nonzero(key == key[np.asarray(batch0.valid)][0])[0]
    l = int(recs.lengths[members[0]])
    for i in members:
        recs.cigars[i] = [(10, "M"), (1, "D"), (l - 10, "M")]
    batch, info = convert_alike(recs, duplex=True)
    assert info["n_dropped_cigar"] == 0 and np.asarray(batch.valid)[members].all()


def test_codecs_agree_on_indel_input_alike(tmp_path):
    path = str(tmp_path / "indel.bam")
    simulated_bam(SimConfig(n_molecules=80, mean_family_size=5, indel_error=0.08, duplex=True,
                            seed=4), path=path, sort=True)
    _, info = convert_alike(read_bam(path)[1], duplex=True, path=path)
    assert info["n_dropped_cigar"] > 0


def test_cigar_hash_is_fnv1a_of_the_bam_bytes_alike():
    cigs = [[(150, "M")], [(10, "M"), (1, "I"), (139, "M")], []]
    h = convert.cigar_hashes(cigs)
    np.testing.assert_array_equal(h, jconv.cigar_hashes(cigs))
    ops = {c: i for i, c in enumerate("MIDNSHP=X")}
    for k, cig in enumerate(cigs):
        x = 0xCBF29CE484222325 if cig else 0
        for b in b"".join(struct.pack("<I", (n << 4) | ops[o]) for n, o in cig):
            x = ((x ^ b) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
        assert h[k] == x


def test_inject_indels_alike():
    _, recs, _, _ = simulated_bam(SimConfig(n_molecules=30, duplex=False, seed=6), sort=True)
    _, jrecs, _, _ = jconv.simulated_bam(SimConfig(n_molecules=30, duplex=False, seed=6),
                                         sort=True)
    sel = convert.inject_indels(recs, 0.3, seed=1)
    np.testing.assert_array_equal(sel, jconv.inject_indels(jrecs, 0.3, seed=1))
    assert len(sel) > 0 and [list(c) for c in recs.cigars] == [list(c) for c in jrecs.cigars]
    np.testing.assert_array_equal(recs.seq, jrecs.seq)
    for i in sel:
        assert sum(n for n, o in recs.cigars[i] if o in "MIS=X") == int(recs.lengths[i])


def _call_both(tmp_path, bam, *flags) -> tuple[dict, str]:
    """``call`` through both CLIs on one input (the port at --device
    cpu): the parity bar, the same drop counters. Returns the port's
    report and output path."""
    out = {s: str(tmp_path / f"o_{s}.bam") for s in ("jax", "port")}
    rep = {s: str(tmp_path / f"r_{s}.json") for s in ("jax", "port")}
    assert jax_main(["call", bam, "-o", out["jax"], *flags, "--report", rep["jax"]]) == 0
    assert cli_main(["call", bam, "-o", out["port"], *flags, "--report", rep["port"],
                     "--device", "cpu"]) == 0
    assert_parity(out["jax"], out["port"], duplex=True)
    pr, jr = (json.load(open(rep[s])) for s in ("port", "jax"))
    for k in ("n_records", "n_dropped", *CIGAR_COUNTERS[2:]):
        assert pr[k] == jr[k], k
    return pr, out["port"]


def test_indel_reads_dropped_end_to_end_alike(tmp_path, capsys):
    bam, truth = str(tmp_path / "in.bam"), str(tmp_path / "t.npz")
    assert cli_main(["simulate", "-o", bam, "--truth", truth, "--molecules", "150", "--read-len",
                     "60", "--positions", "8", "--family-size", "6", "--indel-error", "0.05",
                     "--sorted", "--seed", "13"]) == 0
    rep, out = _call_both(tmp_path, bam, "--config", "config3", "--capacity", "512")
    assert rep["n_dropped"] > 0
    capsys.readouterr()
    assert cli_main(["validate", out, "--truth", truth, "--json"]) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["error_rate"] < 5e-3


def test_cigar_drop_fraction_bounded_on_indel_sim_alike(tmp_path):
    path = str(tmp_path / "indel.bam")
    simulated_bam(SimConfig(n_molecules=120, mean_family_size=5, indel_error=0.06, duplex=True,
                            seed=8), path=path, sort=True)
    rep, _ = _call_both(tmp_path, path, "--config", "config3", "--capacity", "256")
    dropped = rep["n_dropped_cigar_ab"] + rep["n_dropped_cigar_ba"]
    assert 0 < dropped / rep["n_records"] < 0.12
    assert rep["n_dropped_cigar_ab"] > 0 and rep["n_dropped_cigar_ba"] > 0


def _clip_bam(path, cigs, pos, flags=None, next_pos=None, seed=3, rand_qual=True):
    n, L = len(cigs), 40
    rng = np.random.default_rng(seed)
    seq = rng.integers(0, 4, (n, L)).astype(np.uint8)
    qual = rng.integers(20, 40, (n, L)).astype(np.uint8) if rand_qual else np.full((n, L), 30,
                                                                                   np.uint8)
    write_bam(path, BamHeader.synthetic(sort_order="coordinate"), BamRecords(
        names=[f"r{i}" for i in range(n)],
        flags=np.zeros(n, np.uint16) if flags is None else np.asarray(flags, np.uint16),
        ref_id=np.zeros(n, np.int32), pos=np.asarray(pos, np.int32),
        mapq=np.full(n, 60, np.uint8),
        next_ref_id=np.full(n, -1 if next_pos is None else 0, np.int32),
        next_pos=np.full(n, -1, np.int32) if next_pos is None else np.asarray(next_pos, np.int32),
        tlen=np.zeros(n, np.int32), lengths=np.full(n, L, np.int32), seq=seq, qual=qual,
        cigars=cigs, umi=["ACGTAA"] * n, aux_raw=[b"RXZACGTAA\x00"] * n))
    return read_bam(path)[1]


CLIP = [(5, "S"), (30, "M"), (5, "S")]
SHIFTED = [(3, "S"), (30, "M"), (7, "S")]


def test_softclip_rescue_trims_and_shifts_alike(tmp_path):
    """A soft-clip-only minority (3S30M7S against 5S30M5S) is rescued
    into the modal cycle space; an indel-core minority still drops; in
    both codecs of both packages."""
    path = str(tmp_path / "sc.bam")
    recs = _clip_bam(path, [CLIP] * 3 + [SHIFTED, [(40, "M")], [(40, "M")],
                                         [(20, "M"), (1, "I"), (19, "M")]],
                     [100] * 4 + [500] * 3)
    batch, info = convert_alike(recs, duplex=False, path=path)
    assert (info["n_rescued_cigar"], info["n_dropped_cigar"], info["n_dropped_cigar_ab"],
            info["n_dropped_cigar_ba"]) == (1, 1, 1, 0)
    v, b, q = np.asarray(batch.valid), np.asarray(batch.bases), np.asarray(batch.quals)
    assert v[3] and not v[6]
    np.testing.assert_array_equal(b[3, 5:35], np.asarray(recs.seq)[3, 3:33])
    np.testing.assert_array_equal(q[3, 5:35], np.asarray(recs.qual)[3, 3:33])
    assert (b[3, :5] == BASE_PAD).all() and (b[3, 35:] == BASE_PAD).all()
    assert (q[3, :5] == 0).all() and (q[3, 35:] == 0).all()


@pytest.mark.parametrize("n_r2, rescued", [(1, 0), (3, 1)],
                         ids=["other_start_not_rescued", "per_mate_donor"])
def test_softclip_rescue_per_alignment_start_alike(tmp_path, n_r2, rescued):
    """R1 copies at 100 and R2 at 250 share (pos_key, UMI, strand): an R2
    soft-clip variant is rescued only against a kept R2 (its own POS)
    donor, never into R1's cycle space."""
    flags = [FLAG_PAIRED | FLAG_READ1] * 3 + [FLAG_PAIRED | FLAG_READ2 | FLAG_REVERSE] * n_r2
    pos = [100] * 3 + [250] * n_r2
    recs = _clip_bam(str(tmp_path / "m.bam"), [CLIP] * (2 + n_r2) + [SHIFTED], pos, flags=flags,
                     next_pos=[250 if p == 100 else 100 for p in pos], seed=6 + 3 * (n_r2 > 1),
                     rand_qual=False)
    batch, info = convert_alike(recs, duplex=False, path=str(tmp_path / "m.bam"))
    assert info["n_rescued_cigar"] == rescued and info["n_dropped_cigar"] == 1 - rescued
    last = len(pos) - 1
    assert bool(np.asarray(batch.valid)[last]) == bool(rescued)
    if rescued:
        b = np.asarray(batch.bases)
        np.testing.assert_array_equal(b[last, 5:35], np.asarray(recs.seq)[last, 3:33])
        assert (b[last, :5] == BASE_PAD).all() and (b[last, 35:] == BASE_PAD).all()
