"""--ref-projected: the port against the JAX package (the contracts of
tests/test_refproject.py).

Each input (hand-built indel families, the indel simulator, mate pairs
with a real insert) goes through the JAX CLI and the port's with the
same flags, on both executors: ``--backend cpu`` (the oracle on both
sides: identical records) and the device path (JAX's default backend
against the port at ``--device cpu``: the parity bar). The reports'
counters are equal. The JAX suite's claims (realigned minorities, the
majority's I/D in the CIGAR, the span-cap fallback, linked pairs,
truth) are then checked on the port's output. ``ref_project`` and
``records_to_readbatch(ref_projected=True)`` are held against the JAX
package's directly.
"""

from __future__ import annotations

import json
import struct

import numpy as np
import pytest

from duplexumiconsensusreads_tpu.cli.main import main as jax_main
from duplexumiconsensusreads_tpu.io.convert import records_to_readbatch as jax_convert
from duplexumiconsensusreads_tpu.io.refproject import ref_project as jax_ref_project
from duplexumiconsensusreads_torch.cli.main import main as cli_main
from duplexumiconsensusreads_torch.io import read_bam, write_bam
from duplexumiconsensusreads_torch.io.bam import (
    FLAG_MATE_REVERSE,
    FLAG_PAIRED,
    FLAG_READ1,
    FLAG_READ2,
    FLAG_REVERSE,
    BamHeader,
    BamRecords,
    iter_aux_fields,
)
from duplexumiconsensusreads_torch.io.convert import records_to_readbatch
from duplexumiconsensusreads_torch.io.refproject import ref_project
from test_torch_cli import assert_parity, assert_same_bam

BACKENDS = ["cpu", "device"]
# report counters of the mesh, which differs by design (the JAX suite's
# CPU runs two virtual devices, the port one lane)
MESH_COUNTERS = ("n_devices", "n_mesh_pad_buckets", "n_pipeline_compiles")


def assert_same_info(info: dict, jinfo: dict) -> None:
    """records_to_readbatch's info dicts equal, the projection's counters
    and width included."""
    assert info.keys() == jinfo.keys()
    for k, v in info.items():
        if k == "ref_projection":
            for f in ("width", "read_len", "n_projected_reads", "n_fallback_reads",
                      "n_fallback_groups", "n_unanchored_reads", "mate_split"):
                assert getattr(v, f) == getattr(jinfo[k], f), f
            assert sorted(v.groups) == sorted(jinfo[k].groups)
        else:
            assert v == jinfo[k], k


def _records(seqs, cigars, pos, umis, L, flags=None, next_pos=None, tlen=None, names=None):
    n = len(cigars)
    return BamRecords(
        names=names or [f"r{i}" for i in range(n)],
        flags=np.zeros(n, np.uint16) if flags is None else np.asarray(flags, np.uint16),
        ref_id=np.zeros(n, np.int32), pos=np.asarray(pos, np.int32),
        mapq=np.full(n, 60, np.uint8),
        next_ref_id=np.full(n, -1 if next_pos is None else 0, np.int32),
        next_pos=np.full(n, -1, np.int32) if next_pos is None else np.asarray(next_pos, np.int32),
        tlen=np.zeros(n, np.int32) if tlen is None else np.asarray(tlen, np.int32),
        lengths=np.full(n, L, np.int32), seq=np.asarray(seqs, np.uint8),
        qual=np.full((n, L), 30, np.uint8), cigars=cigars, umi=list(umis),
        aux_raw=[b"RXZ" + u.encode() + b"\x00" for u in umis])


def _family_bam(path, cigars, seqs, pos=None, L=40, umi="ACGTAA"):
    n = len(cigars)
    write_bam(path, BamHeader.synthetic(sort_order="coordinate"),
              _records(seqs, cigars, [100] * n if pos is None else pos, [umi] * n, L))
    return path


def call_both(bam, tmp_path, *flags, backend="cpu", tag="c") -> tuple[dict, str]:
    """``call --ref-projected`` through both CLIs: on ``backend`` "cpu"
    the records are identical, on "device" (JAX's default backend, the
    port at --device cpu) they agree at the parity bar; the reports'
    counters are equal. Returns (the port's report, its output)."""
    out = {side: str(tmp_path / f"{tag}_{side}.bam") for side in ("jax", "port")}
    rep = {side: str(tmp_path / f"{tag}_{side}.json") for side in ("jax", "port")}
    argv = ["call", str(bam), "--ref-projected", *flags]
    where = ["--backend", "cpu"] if backend == "cpu" else []
    assert jax_main([*argv, *where, "-o", out["jax"], "--report", rep["jax"]]) == 0
    where = ["--backend", "cpu"] if backend == "cpu" else ["--device", "cpu"]
    assert cli_main([*argv, *where, "-o", out["port"], "--report", rep["port"]]) == 0
    if backend == "cpu":
        assert_same_bam(out["jax"], out["port"])
    else:
        assert_parity(out["jax"], out["port"], duplex="ss" not in flags)
    jr, pr = (json.load(open(rep[s])) for s in ("jax", "port"))
    counters = [k for k in jr if k.startswith("n_") and k not in MESH_COUNTERS]
    assert {k: pr[k] for k in counters} == {k: jr[k] for k in counters}
    assert pr["mate_aware"] == jr["mate_aware"]
    return pr, out["port"]


def _ss(bam, tmp_path, *extra, tag="c"):
    """tests/test_refproject.py's ``_call``: ss, exact, capacity 256, on
    the oracle of both packages."""
    return call_both(bam, tmp_path, "--mode", "ss", "--grouping", "exact", "--capacity", "256",
                     *extra, tag=tag)


def test_minority_indel_reads_realigned_alike(tmp_path):
    rng = np.random.default_rng(5)
    L = 40
    true = rng.integers(0, 4, L).astype(np.uint8)
    seqs = np.broadcast_to(true, (6, L)).copy()
    cigars = [[(L, "M")] for _ in range(6)]
    p, d = 10, 20
    seqs[4, p + 1:] = true[p:L - 1]
    seqs[4, p] = (true[p] + 1) % 4
    cigars[4] = [(p, "M"), (1, "I"), (L - p - 1, "M")]
    seqs[5, d:L - 1] = true[d + 1:]
    seqs[5, L - 1] = 0
    cigars[5] = [(d, "M"), (1, "D"), (L - d, "M")]
    rep, out = _ss(_family_bam(str(tmp_path / "fam.bam"), cigars, seqs, L=L), tmp_path)
    assert rep["n_projected_reads"] == 6
    assert rep["n_dropped_cigar_ab"] + rep["n_dropped_cigar_ba"] == 0
    _, cons = read_bam(out)
    assert len(cons) == 1 and cons.cigars[0][0][1] == "M" and int(cons.pos[0]) == 100
    np.testing.assert_array_equal(cons.seq[0, :int(cons.lengths[0])][:L], true)


def _majority(L, rng_seed, row, cigar):
    rng = np.random.default_rng(rng_seed)
    true = rng.integers(0, 4, L).astype(np.uint8)
    seqs = np.zeros((5, L), np.uint8)
    for k in range(4):
        seqs[k] = row(true)
    seqs[4] = true
    return true, seqs, [cigar] * 4 + [[(L, "M")]]


def test_majority_insertion_emits_i_alike(tmp_path):
    L, p = 30, 12
    ins = np.array([2, 3], np.uint8)
    true, seqs, cigars = _majority(L, 7, lambda t: np.concatenate([t[:p], ins, t[p:L - 2]]),
                                   [(p, "M"), (2, "I"), (L - p - 2, "M")])
    _, out = _ss(_family_bam(str(tmp_path / "ins.bam"), cigars, seqs, L=L), tmp_path)
    _, cons = read_bam(out)
    assert len(cons) == 1 and cons.cigars[0] == [(p, "M"), (2, "I"), (L - p, "M")]
    called = cons.seq[0, :int(cons.lengths[0])]
    np.testing.assert_array_equal(called[p:p + 2], ins)
    np.testing.assert_array_equal(called[:p], true[:p])
    np.testing.assert_array_equal(called[p + 2:], true[p:])


def test_majority_deletion_emits_d_alike(tmp_path):
    L, d = 30, 14
    true, seqs, cigars = _majority(L, 11, lambda t: np.concatenate([t[:d], t[d + 1:], [1]]),
                                   [(d, "M"), (1, "D"), (L - d, "M")])
    _, out = _ss(_family_bam(str(tmp_path / "del.bam"), cigars, seqs, L=L), tmp_path)
    _, cons = read_bam(out)
    assert len(cons) == 1 and cons.cigars[0][:2] == [(d, "M"), (1, "D")]
    called = cons.seq[0, :int(cons.lengths[0])]
    np.testing.assert_array_equal(called[:d], true[:d])
    assert called[d] == true[d + 1]


def test_minority_insertion_suppressed_alike(tmp_path):
    rng = np.random.default_rng(13)
    L, p = 30, 8
    true = rng.integers(0, 4, L).astype(np.uint8)
    seqs = np.broadcast_to(true, (5, L)).copy()
    cigars = [[(L, "M")] for _ in range(5)]
    seqs[0, p + 1:] = true[p:L - 1]
    seqs[0, p] = 3
    cigars[0] = [(p, "M"), (1, "I"), (L - p - 1, "M")]
    _, out = _ss(_family_bam(str(tmp_path / "mini.bam"), cigars, seqs, L=L), tmp_path)
    _, cons = read_bam(out)
    assert cons.cigars[0] == [(L, "M")]
    np.testing.assert_array_equal(cons.seq[0, :L], true)


def test_wide_group_falls_back_alike(tmp_path):
    """Two reads 500 bp apart: apart they both project; forced into one
    group they exceed the span cap and keep the cycle layout, in both
    packages' ref_project."""
    rng = np.random.default_rng(17)
    L = 40
    path = _family_bam(str(tmp_path / "wide.bam"), [[(L, "M")], [(L, "M")]],
                       rng.integers(0, 4, (2, L)).astype(np.uint8), pos=[100, 600], L=L)
    _, r2 = read_bam(path)
    batch, info = records_to_readbatch(r2, duplex=False, ref_projected=True)
    jbatch, jinfo = jax_convert(r2, duplex=False, ref_projected=True)
    assert_same_info(info, jinfo)
    assert info["n_projection_fallback_reads"] == 0
    np.testing.assert_array_equal(batch.bases, jbatch.bases)
    args = (np.asarray(r2.seq), np.asarray(r2.qual), np.ones(2, bool), np.zeros(2, np.int64),
            np.zeros((2, 4), np.uint8), np.asarray(r2.pos), lambda i: r2.cigars[i])
    ours, theirs = ref_project(*args), jax_ref_project(*args)
    for a, b in zip((ours[0], ours[1], ours[3]), (theirs[0], theirs[1], theirs[3])):
        np.testing.assert_array_equal(a, b)
    assert ours[2].n_fallback_groups == theirs[2].n_fallback_groups == 1
    assert ours[3].all()
    np.testing.assert_array_equal(ours[0][:, :L], np.asarray(r2.seq))


def test_fallback_group_emits_cycle_width_alike(tmp_path):
    """A group projected wider than L beside one past the span cap: the
    fallback family keeps the read length, an all-M CIGAR and
    read-length per-base tags."""
    rng = np.random.default_rng(23)
    L = 40
    t45 = rng.integers(0, 4, L + 5).astype(np.uint8)
    t2 = rng.integers(0, 4, L).astype(np.uint8)
    row_a = np.concatenate([t45[:20], t45[25:45]])
    row_mon = np.concatenate([t2[:10], rng.integers(0, 4, 30)]).astype(np.uint8)
    cigars = [[(20, "M"), (5, "D"), (20, "M")]] * 3 + [[(L, "M")]] * 2 + [
        [(10, "M"), (200, "D"), (30, "M")]]
    bam = str(tmp_path / "mixed.bam")
    write_bam(bam, BamHeader.synthetic(sort_order="coordinate"),
              _records(np.stack([row_a, row_a, row_a, t2, t2, row_mon]), cigars,
                       [100] * 3 + [600] * 3, ["ACGTAA"] * 3 + ["GGCCTT"] * 3, L))
    rep, out = _ss(bam, tmp_path, "--per-base-tags")
    assert (rep["n_projection_fallback_groups"], rep["n_projection_fallback_reads"],
            rep["n_projected_reads"]) == (1, 3, 3)
    _, cons = read_bam(out)
    assert len(cons) == 2
    assert cons.cigars[0] == [(20, "M"), (5, "D"), (20, "M")] and cons.cigars[1] == [(L, "M")]
    assert [int(x) for x in cons.lengths] == [L, L]
    np.testing.assert_array_equal(cons.seq[0, :L], row_a)
    np.testing.assert_array_equal(cons.seq[1, :L], t2)
    for raw in cons.aux_raw:
        j = raw.index(b"cdB")
        assert struct.unpack("<I", raw[j + 4:j + 8])[0] == L


def _validate(out, truth, capsys, *flags) -> dict:
    capsys.readouterr()
    assert cli_main(["validate", out, "--truth", truth, "--json", *flags]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("backend", BACKENDS)
def test_indel_sim_truth_and_parity_alike(tmp_path, backend, capsys):
    bam, truth = str(tmp_path / "ind.bam"), str(tmp_path / "truth.npz")
    assert cli_main(["simulate", "-o", bam, "--truth", truth, "--molecules", "100",
                     "--family-size", "5", "--indel-error", "0.08", "--base-error", "0.01",
                     "--sorted", "--seed", "21"]) == 0
    rep, out = call_both(bam, tmp_path, "--config", "config3", "--capacity", "512",
                         backend=backend)
    assert rep["n_projected_reads"] > 0
    assert rep["n_dropped_cigar_ab"] + rep["n_dropped_cigar_ba"] == 0
    v = _validate(out, truth, capsys, "--pos-window", "200")
    assert v["n_unmatched"] == 0 and v["n_matched_to_truth"] == v["n_consensus"] > 0
    classic = str(tmp_path / "classic.bam")
    assert cli_main(["call", bam, "-o", classic, "--config", "config3", "--capacity", "512",
                     *(["--backend", "cpu"] if backend == "cpu" else ["--device", "cpu"])]) == 0
    vc = _validate(classic, truth, capsys)
    assert v["error_rate"] <= vc["error_rate"] * 1.5 + 1e-6


@pytest.mark.parametrize("backend", BACKENDS)
def test_mate_aware_ref_projected_alike(tmp_path, capsys, backend):
    bam, truth = str(tmp_path / "pair.bam"), str(tmp_path / "truth.npz")
    assert cli_main(["simulate", "-o", bam, "--truth", truth, "--molecules", "80",
                     "--family-size", "5", "--indel-error", "0.06", "--base-error", "0.01",
                     "--paired-reads", "--sorted", "--seed", "41"]) == 0
    rep, out = call_both(bam, tmp_path, "--config", "config3", "--capacity", "512",
                         backend=backend)
    assert rep["mate_aware"] is True and rep["n_projected_reads"] > 0
    assert rep["n_dropped_cigar_ab"] + rep["n_dropped_cigar_ba"] == 0
    _, cons = read_bam(out)
    by_name: dict = {}
    for i in range(len(cons)):
        if cons.names[i].endswith("p"):
            by_name.setdefault(cons.names[i], []).append(i)
    for nm, rows in by_name.items():
        assert len(rows) == 2, nm
        a, b = rows
        assert int(cons.next_pos[a]) == int(cons.pos[b])
        assert int(cons.next_pos[b]) == int(cons.pos[a])
        ta, tb = int(cons.tlen[a]), int(cons.tlen[b])
        assert ta == -tb and ta != 0
        assert abs(ta) >= abs(int(cons.pos[a]) - int(cons.pos[b]))
    assert len(by_name) == rep["n_consensus_pairs"] > 0
    v = _validate(out, truth, capsys, "--pos-window", "200")
    assert v["n_unmatched"] == 0 and v["error_rate"] < 5e-3


@pytest.mark.parametrize("backend", BACKENDS)
def test_projected_pair_with_real_insert_alike(tmp_path, backend):
    rng = np.random.default_rng(61)
    L, k = 40, 3
    n = 2 * k
    seqs = np.stack([rng.integers(0, 4, L).astype(np.uint8)] * k
                    + [rng.integers(0, 4, L).astype(np.uint8)] * k)
    flags = ([FLAG_PAIRED | FLAG_READ1 | FLAG_MATE_REVERSE] * k
             + [FLAG_PAIRED | FLAG_READ2 | FLAG_REVERSE] * k)
    bam = str(tmp_path / "ins.bam")
    write_bam(bam, BamHeader.synthetic(sort_order="coordinate"),
              _records(seqs, [[(L, "M")]] * n, [100] * k + [250] * k, ["ACGTAA"] * n, L,
                       flags=flags, next_pos=[250] * k + [100] * k,
                       tlen=[190] * k + [-190] * k, names=[f"t{i % k}" for i in range(n)]))
    rep, out = call_both(bam, tmp_path, "--mode", "ss", "--grouping", "exact", "--capacity", "64",
                         "--mate-aware", "on", backend=backend)
    assert rep["n_consensus_pairs"] == 1
    _, cons = read_bam(out)
    a, b = [i for i in range(len(cons)) if cons.names[i].endswith("p")]
    assert cons.names[a] == cons.names[b]
    pa, pb = int(cons.pos[a]), int(cons.pos[b])
    assert sorted([pa, pb]) == [100, 250]
    assert int(cons.next_pos[a]) == pb and int(cons.next_pos[b]) == pa
    assert int(cons.tlen[a]) == -int(cons.tlen[b]) and abs(int(cons.tlen[a])) == 250 + L - 100


def test_backend_parity_on_projected_grid_alike(tmp_path):
    """The port's two executors on one projected input, each against the
    JAX one: records agree, bases equal wherever both call."""
    from duplexumiconsensusreads_torch.io import simulated_bam
    from duplexumiconsensusreads_torch.simulate import SimConfig

    bam = str(tmp_path / "p.bam")
    simulated_bam(SimConfig(n_molecules=60, mean_family_size=4, indel_error=0.06,
                            base_error=0.01, duplex=True, seed=33), path=bam, sort=True)
    outs = {}
    for backend in BACKENDS:
        outs[backend] = read_bam(call_both(bam, tmp_path, "--config", "config3", "--capacity",
                                           "512", backend=backend, tag=backend)[1])[1]
    a, b = outs["cpu"], outs["device"]
    assert len(a) == len(b) and a.names == b.names and a.cigars == b.cigars
    np.testing.assert_array_equal(a.pos, b.pos)
    for i in range(len(a)):
        la = int(a.lengths[i])
        np.testing.assert_array_equal(a.seq[i, :la], b.seq[i, :la])


def test_unanchored_reads_invalidated_alike(tmp_path):
    rng = np.random.default_rng(3)
    L = 40
    true = rng.integers(0, 4, L).astype(np.uint8)
    cigars = [[(L, "M")] for _ in range(3)] + [[(L, "S")]]
    bam = _family_bam(str(tmp_path / "unanch.bam"), cigars,
                      np.broadcast_to(true, (4, L)).copy(), L=L)
    _, recs = read_bam(bam)
    batch, info = records_to_readbatch(recs, duplex=False, ref_projected=True)
    jbatch, jinfo = jax_convert(recs, duplex=False, ref_projected=True)
    assert_same_info(info, jinfo)
    np.testing.assert_array_equal(batch.valid, jbatch.valid)
    assert info["n_projection_unanchored_reads"] == 1 and not batch.valid[3]
    assert info["n_valid"] == 3 and info["n_dropped_cigar"] == 0
    rep, out = _ss(bam, tmp_path)
    assert rep["n_projection_unanchored_reads"] == 1
    _, cons = read_bam(out)
    cd = [struct.unpack_from("<i", cons.aux_raw[0], vs)[0]
          for _s, t, _typ, vs, _e in iter_aux_fields(cons.aux_raw[0]) if t == b"cD"]
    assert len(cons) == 1 and cd == [3]
