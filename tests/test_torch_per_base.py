"""The config5 call's output options, the port against the JAX package.

Both executors with ``per_base_tags=True`` on the CPU, against the JAX
calls (``JAX_PLATFORMS=cpu``) on the same input, at the parity bar:
- ``cd`` (per-base depth, an integer count) bit-identical on every
  record;
- ``ce`` (per-base disagreeing reads) identical except at a counted
  tie cycle, where the consensus base itself may differ (ROADMAP
  "Faults found" 1 and 4);
- every other aux tag and field identical, quals within 2 (duplex).
``write_index=True`` writes the .bai that ``build_bai`` (the port's and
the JAX package's) makes of the output. The whole-file ``ref_projected``
and ``umi_whitelist`` runs and ``max_reads`` hold against the JAX
whole-file call record by record, with the same report counters. The
CLI refuses what the JAX CLI refuses, in its words.
"""

from __future__ import annotations

import os
import struct

import numpy as np
import pytest

from duplexumiconsensusreads_tpu.cli.main import main as jax_main
from duplexumiconsensusreads_tpu.io import read_bam as jax_read_bam
from duplexumiconsensusreads_tpu.io import simulated_bam
from duplexumiconsensusreads_tpu.io.bai import build_bai as jax_build_bai
from duplexumiconsensusreads_tpu.runtime.executor import call_consensus_file as jax_call
from duplexumiconsensusreads_tpu.runtime.stream import stream_call_consensus as jax_stream
from duplexumiconsensusreads_tpu.simulate import SimConfig
from duplexumiconsensusreads_tpu.types import ConsensusParams as JC
from duplexumiconsensusreads_tpu.types import GroupingParams as JG
from duplexumiconsensusreads_torch.cli.main import main as cli_main
from duplexumiconsensusreads_torch.cli.main import params_for
from duplexumiconsensusreads_torch.constants import NO_CALL_QUAL
from duplexumiconsensusreads_torch.io import read_bam
from duplexumiconsensusreads_torch.io.bai import build_bai
from duplexumiconsensusreads_torch.io.bam import iter_aux_fields
from duplexumiconsensusreads_torch.runtime.executor import call_consensus_file
from duplexumiconsensusreads_torch.runtime.stream import stream_call_consensus

KW = dict(capacity=128)
STREAM_KW = dict(capacity=128, chunk_reads=150)
# a strand call at an evidence tie has qual <= 3; the duplex merge then
# moves the duplex qual by at most 2 * 3 (chip_smoke.py's TIE_QUAL)
TIE_QUAL = 3
_B_TYPES = {b"c": "i1", b"C": "u1", b"s": "<i2", b"S": "<u2", b"i": "<i4", b"I": "<u4"}


@pytest.fixture(scope="module")
def bams(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_per_base")
    out = {}
    for name, paired in (("single", False), ("mates", True)):
        p = str(d / f"{name}.bam")
        _, _, _, truth = simulated_bam(
            SimConfig(n_molecules=120, read_len=40, n_positions=8, umi_error=0.02,
                      cycle_error_slope=0.003, duplex=True, paired_reads=paired,
                      indel_error=0.02, seed=11),
            path=p, sort=True,
        )
        out[name] = p
        out[name + "_truth"] = truth
    return d, out


def _tags(aux: bytes) -> dict:
    """tag -> int64 array (B arrays) or raw value bytes."""
    out = {}
    for _, tag, typ, vs, end in iter_aux_fields(aux):
        if typ == b"B":
            cnt = struct.unpack_from("<I", aux, vs + 1)[0]
            out[tag] = np.frombuffer(aux, _B_TYPES[aux[vs:vs + 1]], cnt, vs + 5).astype(np.int64)
        else:
            out[tag] = aux[vs:end]
    return out


def compare_per_base(a, b, duplex: bool = True, per_base: bool = True) -> dict:
    """Records of the JAX call (a) and the port's (b) at the parity bar;
    returns the counts of tie cycles and compared cycles."""
    assert len(a) == len(b) > 0
    for f in ("names", "flags", "ref_id", "pos", "mapq", "next_ref_id", "next_pos",
              "tlen", "lengths"):
        np.testing.assert_array_equal(np.asarray(getattr(a, f)), np.asarray(getattr(b, f)),
                                      err_msg=f)
    assert list(a.cigars) == list(b.cigars)
    tol = 2 if duplex else 1
    sa, sb = np.asarray(a.seq), np.asarray(b.seq)
    qa, qb = np.asarray(a.qual).astype(int), np.asarray(b.qual).astype(int)
    dq = np.abs(qa - qb)
    tie = (((sa != sb) & (qa == NO_CALL_QUAL) & (qb == NO_CALL_QUAL))
           | ((sa == sb) & (dq > tol) & (dq <= 2 * TIE_QUAL + tol)))
    assert not ((sa != sb) & ~tie).any(), "bases differ outside a tie"
    assert (np.where(tie, 0, dq) <= tol).all()
    n_ce_tie = 0
    for i in range(len(a)):
        ta, tb = _tags(a.aux_raw[i]), _tags(b.aux_raw[i])
        assert set(ta) == set(tb)
        assert (b"cd" in tb) is per_base and (b"ce" in tb) is per_base
        for tag in ta:
            if tag == b"ce":
                diff = ta[tag] != tb[tag]
                li = int(a.lengths[i])
                assert not (diff & ~tie[i, :li]).any(), f"record {i}: ce differs off a tie"
                n_ce_tie += int(diff.sum())
            else:
                # cd (the integer per-base depth) and every other tag:
                # bit-identical
                np.testing.assert_array_equal(ta[tag], tb[tag], err_msg=tag.decode())
        if per_base:
            assert len(tb[b"cd"]) == len(tb[b"ce"]) == int(b.lengths[i])
    return {"tie_cycles": int(tie.sum()), "ce_tie_cycles": n_ce_tie, "cycles": int(sa.size)}


@pytest.mark.parametrize("which", ["single", "mates"])
def test_whole_file_per_base_tags_match_jax(bams, which):
    d, paths = bams
    gp, cp, _ = params_for("config5")
    jout, tout = str(d / f"j_wf_{which}.bam"), str(d / f"t_wf_{which}.bam")
    jrep = jax_call(paths[which], jout, JG(**vars(gp)), JC(**vars(cp)), per_base_tags=True,
                    **KW)
    trep = call_consensus_file(paths[which], tout, gp, cp, device="cpu", per_base_tags=True,
                               **KW)
    for f in ("n_records", "n_valid_reads", "n_buckets", "n_families", "n_molecules",
              "n_consensus", "n_consensus_pairs", "mate_aware", "n_size_classes"):
        assert getattr(trep, f) == getattr(jrep, f), f
    stats = compare_per_base(jax_read_bam(jout)[1], read_bam(tout)[1])
    assert stats["tie_cycles"] * 1000 <= stats["cycles"]


@pytest.mark.parametrize("which", ["single", "mates"])
def test_stream_per_base_tags_match_jax(bams, which):
    d, paths = bams
    gp, cp, _ = params_for("config5")
    jout, tout = str(d / f"j_st_{which}.bam"), str(d / f"t_st_{which}.bam")
    jrep = jax_stream(paths[which], jout, JG(**vars(gp)), JC(**vars(cp)), n_devices=1,
                      per_base_tags=True, **STREAM_KW)
    trep = stream_call_consensus(paths[which], tout, gp, cp, device="cpu",
                                 per_base_tags=True, **STREAM_KW)
    assert trep.n_chunks >= 3
    for f in ("n_records", "n_valid_reads", "n_buckets", "n_families", "n_molecules",
              "n_consensus", "n_consensus_pairs", "n_chunks", "mate_aware", "bytes_h2d",
              "bytes_d2h"):
        assert getattr(trep, f) == getattr(jrep, f), f
    stats = compare_per_base(jax_read_bam(jout)[1], read_bam(tout)[1])
    assert stats["tie_cycles"] * 1000 <= stats["cycles"]


def test_per_base_tags_turn_the_packed_return_path_off(bams, tmp_path):
    """The full (F, L) matrices cross the wire: per-base-tag runs fetch
    more than the packed rung would, and say so in the trace."""
    import json

    _, paths = bams
    gp, cp, _ = params_for("config5")
    reps = {}
    for pb in (False, True):
        tr = str(tmp_path / f"t{pb}.jsonl")
        reps[pb] = stream_call_consensus(paths["mates"], str(tmp_path / f"o{pb}.bam"), gp, cp,
                                         device="cpu", per_base_tags=pb, trace_path=tr,
                                         **STREAM_KW)
        events = [json.loads(line) for line in open(tr)]
        reasons = {e.get("reason") for e in events if e.get("name") == "packed_fallback"}
        assert ("per-base-tags-fetch-full-matrices" in reasons) is pb
    assert reps[True].bytes_d2h > 2 * reps[False].bytes_d2h
    assert reps[True].bytes_h2d == reps[False].bytes_h2d


@pytest.mark.parametrize("mode", ["whole_file", "stream"])
def test_write_index_writes_the_bai_of_the_output(bams, tmp_path, mode):
    _, paths = bams
    gp, cp, _ = params_for("config5")
    out = str(tmp_path / "o.bam")
    if mode == "stream":
        stream_call_consensus(paths["mates"], out, gp, cp, device="cpu", per_base_tags=True,
                              write_index=True, **STREAM_KW)
    else:
        call_consensus_file(paths["mates"], out, gp, cp, device="cpu", per_base_tags=True,
                            write_index=True, **KW)
    with open(out + ".bai", "rb") as f:
        written = f.read()
    for builder, name in ((build_bai, "t.bai"), (jax_build_bai, "j.bai")):
        with open(builder(out, str(tmp_path / name)), "rb") as f:
            assert f.read() == written
    assert not os.path.exists(out + ".csi")


def test_portable_codec_gives_the_native_records(bams, tmp_path, monkeypatch):
    """DUT_NO_NATIVE=1: the same chunks and records on both executors
    (the file bytes differ only by the deflate codec)."""
    _, paths = bams
    gp, cp, _ = params_for("config5")
    runs = {}
    for flavor in ("native", "python"):
        if flavor == "python":
            monkeypatch.setenv("DUT_NO_NATIVE", "1")
        s_out, w_out = str(tmp_path / f"s_{flavor}.bam"), str(tmp_path / f"w_{flavor}.bam")
        srep = stream_call_consensus(paths["mates"], s_out, gp, cp, device="cpu",
                                     per_base_tags=True, write_index=True, **STREAM_KW)
        call_consensus_file(paths["mates"], w_out, gp, cp, device="cpu", per_base_tags=True,
                            **KW)
        runs[flavor] = (srep.n_chunks, read_bam(s_out)[1], read_bam(w_out)[1])
    (nc_n, s_n, w_n), (nc_p, s_p, w_p) = runs["native"], runs["python"]
    assert nc_n == nc_p >= 3
    for x, y in ((s_n, s_p), (w_n, w_p)):
        assert x.names == y.names and list(x.aux_raw) == list(y.aux_raw)
        np.testing.assert_array_equal(x.seq, y.seq)
        np.testing.assert_array_equal(x.qual, y.qual)


@pytest.mark.parametrize("which", ["single", "mates"])
def test_ref_projected_matches_jax(bams, which):
    d, paths = bams
    gp, cp, _ = params_for("config5")
    jout, tout = str(d / f"j_rp_{which}.bam"), str(d / f"t_rp_{which}.bam")
    jrep = jax_call(paths[which], jout, JG(**vars(gp)), JC(**vars(cp)), ref_projected=True,
                    **KW)
    trep = call_consensus_file(paths[which], tout, gp, cp, device="cpu", ref_projected=True,
                               **KW)
    assert trep.n_projected_reads == jrep.n_projected_reads > 0
    for f in ("n_projection_fallback_reads", "n_projection_fallback_groups",
              "n_projection_unanchored_reads", "n_consensus", "n_valid_reads", "mate_aware"):
        assert getattr(trep, f) == getattr(jrep, f), f
    compare_per_base(jax_read_bam(jout)[1], read_bam(tout)[1], per_base=False)


def test_umi_whitelist_matches_jax(bams, tmp_path):
    from duplexumiconsensusreads_torch.io.convert import load_umi_whitelist

    d, paths = bams
    mol = np.asarray(paths["single_truth"].mol_umi)
    half = mol.shape[1] // 2
    chars = np.frombuffer(b"ACGT", np.uint8)
    lines = {bytes(chars[r]).decode() for r in np.concatenate([mol[:, :half], mol[:, half:]])}
    wl = tmp_path / "wl.txt"
    wl.write_text("\n".join(sorted(lines)) + "\n")
    codes = load_umi_whitelist(str(wl))
    gp, cp, _ = params_for("config5")
    jout, tout = str(tmp_path / "j.bam"), str(tmp_path / "t.bam")
    jrep = jax_call(paths["single"], jout, JG(**vars(gp)), JC(**vars(cp)), umi_whitelist=codes,
                    **KW)
    trep = call_consensus_file(paths["single"], tout, gp, cp, device="cpu",
                               umi_whitelist=codes, **KW)
    assert trep.n_umi_corrected == jrep.n_umi_corrected > 0
    assert trep.n_dropped_whitelist == jrep.n_dropped_whitelist
    assert trep.n_consensus == jrep.n_consensus
    compare_per_base(jax_read_bam(jout)[1], read_bam(tout)[1], per_base=False)


def test_whole_file_max_reads_matches_jax(bams, tmp_path):
    _, paths = bams
    gp, cp, _ = params_for("config5")
    jout, tout = str(tmp_path / "j.bam"), str(tmp_path / "t.bam")
    jrep = jax_call(paths["mates"], jout, JG(**vars(gp)), JC(**vars(cp)), max_reads=2, **KW)
    trep = call_consensus_file(paths["mates"], tout, gp, cp, device="cpu", max_reads=2, **KW)
    assert trep.n_downsampled_reads == jrep.n_downsampled_reads > 0
    compare_per_base(jax_read_bam(jout)[1], read_bam(tout)[1], per_base=False)


@pytest.mark.parametrize("extra", [
    ["--ref-projected", "--chunk-reads", "100"],
    ["--umi-whitelist", "WL", "--chunk-reads", "100"],
    ["--umi-whitelist", "BADWL"],
    ["--write-index", "-o", "OUT.sam"],
    ["--max-reads", "-1"],
    ["--ref-projected", "--input-npz"],
], ids=["ref-projected-stream", "whitelist-stream", "bad-whitelist", "index-needs-bam",
        "max-reads", "ref-projected-npz"])
def test_cli_refusals_use_the_jax_wording(bams, tmp_path, extra):
    d, paths = bams
    wl, bad = tmp_path / "wl.txt", tmp_path / "bad.txt"
    wl.write_text("ACGTAC\n")
    bad.write_text("ACGTAC\nACGT\n")
    inp = paths["single"]
    if "--input-npz" in extra:
        extra = [x for x in extra if x != "--input-npz"]
        inp = str(tmp_path / "x.npz")
    extra = [{"WL": str(wl), "BADWL": str(bad)}.get(x, x) for x in extra]
    out = str(tmp_path / "o.bam")
    if "-o" in extra:
        out = str(tmp_path / extra[extra.index("-o") + 1])
        extra = [x for x in extra if x not in ("-o", "OUT.sam")]
    argv = ["call", inp, "-o", out, "--config", "config5", *extra]
    with pytest.raises(SystemExit) as theirs:
        jax_main(argv)
    with pytest.raises(SystemExit) as ours:
        cli_main(argv + ["--device", "cpu"])
    assert str(ours.value) == str(theirs.value) != ""
    assert not os.path.exists(out)
