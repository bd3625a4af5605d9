"""Random draws: the port's device path against the JAX package's and
the oracle (the contracts of tests/test_property.py).

For each seeded (config, seed) draw of that suite, the same batch is
bucketed by both packages (identical buckets), and every bucket runs
through the port's ``run_bucket`` (``segment_gemm``'s plain version on
the CPU) and the JAX package's (its CPU default method): integer
outputs identical, bases identical but at counted ties, quals within
one per strand. The port's rows are also held against the oracle at
the JAX suite's own tolerance. Streaming equals the whole file on
random indel inputs, and paired-end flags are transparent to both
packages' codecs, Python and native.
"""

from __future__ import annotations

import numpy as np
import pytest

from duplexumiconsensusreads_tpu.bucketing import build_buckets as jax_build_buckets
from duplexumiconsensusreads_tpu.cli.main import main as jax_main
from duplexumiconsensusreads_tpu.io import records_to_readbatch as jax_convert
from duplexumiconsensusreads_tpu.ops import run_bucket as jax_run_bucket
from duplexumiconsensusreads_tpu.ops import spec_for_buckets as jax_spec
from duplexumiconsensusreads_tpu.runtime.executor import default_ssc_method
from duplexumiconsensusreads_tpu.simulate import SimConfig
from duplexumiconsensusreads_torch import oracle
from duplexumiconsensusreads_torch import types as pt
from duplexumiconsensusreads_torch.bucketing import build_buckets
from duplexumiconsensusreads_torch.cli.main import main as cli_main
from duplexumiconsensusreads_torch.io import read_bam, records_to_readbatch, simulated_bam
from duplexumiconsensusreads_torch.ops import ConsensusCaller, run_bucket, spec_for_buckets
from duplexumiconsensusreads_torch.simulate import simulate_batch
from chip_smoke import tie_kinds
from test_property import _random_case
from test_torch_cli import assert_parity

FIELDS = ("bases", "quals", "umi", "pos_key", "strand_ab", "valid")
# per-bucket outputs compared as integers (the rest: bases/quals at the bar)
CALLS = ("cons_base", "cons_qual")


def _bucket_parity(ours: dict, theirs: dict, duplex: bool) -> tuple[int, int]:
    """One bucket's outputs, the port's against the JAX package's: every
    key but the calls identical, the calls at the parity bar. Returns
    (tie cycles, cycles)."""
    assert ours.keys() >= set(CALLS)
    for k, v in ours.items():
        if k in CALLS or k not in theirs:
            continue
        np.testing.assert_array_equal(v.numpy(), np.asarray(theirs[k]), err_msg=k)
    sa, sb = ours["cons_base"].numpy(), np.asarray(theirs["cons_base"])
    qa = ours["cons_qual"].numpy().astype(int)
    qb = np.asarray(theirs["cons_qual"]).astype(int)
    tol = 2 if duplex else 1
    tie = np.logical_or.reduce(list(tie_kinds(sa, sb, qa, qb, tol, duplex).values()))
    assert not ((sa != sb) & ~tie).any(), "bases differ outside a tie"
    assert (np.where(tie, 0, np.abs(qa - qb)) <= tol).all()
    return int(tie.sum()), sa.size


def _oracle_bar(dev_b, dev_q, o_b, o_q, duplex: bool) -> None:
    """tests/test_property.py's bar between a device row and the oracle
    row of the same family."""
    b_diff = dev_b != o_b
    if b_diff.any():
        assert dev_q[b_diff].max() <= 3 and o_q[b_diff].max() <= 3
    dq = np.abs(dev_q - o_q)
    rough = dq > (2 if duplex else 1)
    if rough.any():
        mn = np.minimum(dev_q, o_q)[rough]
        assert ((mn <= 10) | (mn >= 25)).all()
        assert rough.mean() <= 0.2 and dq[rough].max() <= 12


@pytest.mark.parametrize("trial", range(12))
def test_pipeline_matches_jax_and_the_oracle_random(trial):
    cfg, gp, cp = _random_case(np.random.default_rng(1000 + trial))
    batch, _ = simulate_batch(cfg)
    pgp, pcp = pt.GroupingParams(**vars(gp)), pt.ConsensusParams(**vars(cp))
    duplex = cp.mode == "duplex"
    fams = oracle.group_reads(batch, pgp)
    ora = ConsensusCaller(pcp, backend="cpu")(batch, fams)
    capacity = 8192 if cp.error_model else 256
    adjacency = gp.strategy == "adjacency"
    buckets = build_buckets(batch, capacity=capacity, adjacency=adjacency)
    jbuckets = jax_build_buckets(batch, capacity=capacity, adjacency=adjacency)
    assert [b.read_index.tolist() for b in buckets] == [b.read_index.tolist() for b in jbuckets]
    spec = spec_for_buckets(buckets, pgp, pcp, "segment_gemm")
    jspec = jax_spec(jbuckets, gp, cp, default_ssc_method())
    oracle_ids = np.asarray(fams.molecule_id if duplex else fams.family_id)
    n_tie = n_cyc = n_checked = 0
    for bk, jbk in zip(buckets, jbuckets):
        out = run_bucket(bk, spec, device="cpu")
        t, c = _bucket_parity(out, jax_run_bucket(jbk, jspec), duplex)
        n_tie, n_cyc = n_tie + t, n_cyc + c
        out = {k: v.numpy() for k, v in out.items()}
        ids = out["molecule_id"] if duplex else out["family_id"]
        for slot in np.nonzero(bk.valid & (bk.read_index >= 0))[0]:
            dev_id, o_id = ids[slot], int(oracle_ids[bk.read_index[slot]])
            if dev_id < 0 or o_id < 0:
                continue
            assert bool(out["cons_valid"][dev_id]) == bool(ora.valid[o_id])
            if ora.valid[o_id]:
                _oracle_bar(out["cons_base"][dev_id], out["cons_qual"][dev_id].astype(int),
                            ora.bases[o_id], ora.quals[o_id].astype(int), duplex)
                n_checked += 1
    assert n_tie * 1000 <= max(n_cyc, 1)
    if int(np.asarray(ora.valid).sum()) > 0:
        assert n_checked > 0


@pytest.mark.parametrize("trial", range(6))
def test_streamed_call_matches_whole_file_and_jax_random(trial, tmp_path):
    """Random indel inputs: the port's stream equals its whole-file call
    in positions, seq, qual and UMIs, and the JAX CLI's whole-file call
    at the parity bar."""
    rng = np.random.default_rng(7000 + trial)
    cfg = SimConfig(n_molecules=int(rng.integers(40, 150)), read_len=int(rng.integers(25, 70)),
                    n_positions=int(rng.integers(2, 10)),
                    mean_family_size=int(rng.integers(1, 6)),
                    umi_error=float(rng.uniform(0, 0.03)),
                    indel_error=float(rng.choice([0.0, 0.05])), duplex=True,
                    seed=int(rng.integers(0, 1 << 30)))
    path = str(tmp_path / "in.bam")
    simulated_bam(cfg, path=path, sort=True)
    common = ["--config", "config3", "--capacity", "128"]
    whole, stream, jax_out = (str(tmp_path / f"{k}.bam") for k in ("w", "s", "j"))
    assert cli_main(["call", path, "-o", whole, "--device", "cpu", *common]) == 0
    assert cli_main(["call", path, "-o", stream, "--device", "cpu", "--chunk-reads",
                     str(int(rng.integers(50, 400))), *common]) == 0
    assert jax_main(["call", path, "-o", jax_out, *common]) == 0
    _, rw = read_bam(whole)
    _, rs = read_bam(stream)
    assert len(rw) == len(rs)
    for f in ("pos", "seq", "qual"):
        np.testing.assert_array_equal(getattr(rw, f), getattr(rs, f), err_msg=f)
    assert list(rw.umi) == list(rs.umi)
    if len(rw):
        assert_parity(jax_out, whole, duplex=True)


def test_paired_end_flags_roundtrip_alike(tmp_path):
    cfg = SimConfig(n_molecules=60, duplex=True, umi_error=0.02, seed=44)
    batches = []
    for paired_end in (False, True):
        path = str(tmp_path / f"pe{paired_end}.bam")
        simulated_bam(cfg, path=path, paired_end=paired_end)
        _, recs = read_bam(path)
        assert all(f & 0x1 for f in recs.flags) == paired_end
        batches += [records_to_readbatch(recs, duplex=True)[0], jax_convert(recs, duplex=True)[0]]
    for f in FIELDS:
        for b in batches[1:]:
            np.testing.assert_array_equal(np.asarray(getattr(b, f)),
                                          np.asarray(getattr(batches[0], f)), err_msg=f)


def test_paired_end_native_parity_alike(tmp_path):
    from duplexumiconsensusreads_tpu.io.native_reader import read_bam_native as jax_native
    from duplexumiconsensusreads_torch.io.native_reader import read_bam_native

    path = str(tmp_path / "pe.bam")
    simulated_bam(SimConfig(n_molecules=40, duplex=True, seed=9), path=path, paired_end=True)
    _, b_nat, _ = read_bam_native(path, duplex=True)
    _, jb_nat, _ = jax_native(path, duplex=True)
    b_py, _ = records_to_readbatch(read_bam(path)[1], duplex=True)
    for f in FIELDS:
        for b in (jb_nat, b_py):
            np.testing.assert_array_equal(np.asarray(getattr(b, f)),
                                          np.asarray(getattr(b_nat, f)), err_msg=f)
