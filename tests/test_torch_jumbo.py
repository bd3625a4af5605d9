"""Oversized position groups and jumbo families: the port against the
JAX package (the contracts of tests/test_jumbo.py).

The same seeded batch goes through the JAX ``call_batch_tpu`` (on the
CPU here) and the port's ``call_batch(device="cpu")``, and through both
packages' ``build_buckets``: bucket layouts, counters and every integer
output identical, bases identical but at counted ties, quals within one
per strand (two for a duplex qual). Where the JAX test holds its device
path against the oracle, the port's is held against it too.

ROADMAP Faults 20 is pinned here: on the seed-43 cluster input one
duplex cycle (pos 2000, cycle 40) is N at qual 2 in the port and A at
qual 2 in the JAX package and in both oracles. Its strands disagree,
and the strand quals, one apart at the Phred floor between the
engines (Faults 1), are equal in the port only. The decision: within
the bar, counted as a tie of ``chip_smoke.tie_kinds``, at most 1 such
cycle in this input's 8,928.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import pytest

from chip_smoke import tie_kinds
from duplexumiconsensusreads_tpu.bucketing import build_buckets as jax_build_buckets
from duplexumiconsensusreads_tpu.cli.main import main as jax_main
from duplexumiconsensusreads_tpu.runtime.executor import RunReport as JaxReport
from duplexumiconsensusreads_tpu.runtime.executor import call_batch_cpu as jax_oracle_call
from duplexumiconsensusreads_tpu.runtime.executor import call_batch_tpu
from duplexumiconsensusreads_tpu.simulate import SimConfig, simulate_batch
from duplexumiconsensusreads_tpu.types import ConsensusParams as JC
from duplexumiconsensusreads_tpu.types import GroupingParams as JG
from duplexumiconsensusreads_tpu.types import ReadBatch as JaxBatch
from duplexumiconsensusreads_torch import types as pt
from duplexumiconsensusreads_torch.bucketing import buckets as port_buckets
from duplexumiconsensusreads_torch.bucketing import build_buckets
from duplexumiconsensusreads_torch.cli.main import main as cli_main
from duplexumiconsensusreads_torch.io import read_bam
from duplexumiconsensusreads_torch.runtime.executor import RunReport, call_batch, call_batch_cpu

# integer outputs of call_batch: depth stats, validity, position, UMI,
# mate, pair, fragment end (then the per-base arrays, when asked for)
EXACT = (2, 3, 4, 5, 6, 7, 8)
PAIR = 7


def pair_partition(pair) -> np.ndarray:
    """Pair ids renumbered by first appearance (-1, no pair, kept): the
    device path numbers pairs per bucket and the oracle per batch, so
    against an oracle the rows each pair links are what must agree."""
    pair = np.asarray(pair)
    first = {}
    return np.array([-1 if p < 0 else first.setdefault(p, len(first)) for p in pair.tolist()],
                    np.int64)


def to_port(obj, cls):
    """The same field values in the port's dataclass (arrays copied, so
    neither side sees the other's in-place edits)."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        out[f.name] = np.array(v) if isinstance(v, np.ndarray) else v
    return cls(**out)


def call_parity(ours, theirs, duplex: bool, max_ties: int = 0, oracle: bool = False) -> dict:
    """call_batch's tuple from the port (``ours``) against the JAX
    package's or (``oracle``) a call_batch_cpu's at the parity bar: row
    for row, integers identical (pair ids as a partition against an
    oracle), bases identical but at ties, quals within 1 (2 for a duplex
    qual). Ties are counted by kind (chip_smoke.tie_kinds) and may
    number at most ``max_ties``. Returns the counts by kind."""
    assert len(ours) == len(theirs)
    assert len(ours[0]) == len(theirs[0])
    for i in EXACT + tuple(range(9, len(ours))):
        a, b = np.asarray(ours[i]), np.asarray(theirs[i])
        if i == PAIR and oracle:
            a, b = pair_partition(a), pair_partition(b)
        np.testing.assert_array_equal(a, b, err_msg=str(i))
    sa, sb = np.asarray(ours[0]), np.asarray(theirs[0])
    qa, qb = np.asarray(ours[1]).astype(int), np.asarray(theirs[1]).astype(int)
    tol = 2 if duplex else 1
    masks = tie_kinds(sa, sb, qa, qb, tol, duplex)
    tie = np.logical_or.reduce(list(masks.values()))
    assert not ((sa != sb) & ~tie).any(), "bases differ outside a tie"
    assert (np.where(tie, 0, np.abs(qa - qb)) <= tol).all()
    kinds = {k: int(m.sum()) for k, m in masks.items()}
    assert tie.sum() <= max_ties, kinds
    return kinds


def both_calls(batch, gp, cp, capacity, report=None, jax_report=None):
    """(the port's call_batch, the JAX call_batch_tpu) on one batch, each
    under warnings-as-errors (the JAX suite's precondition)."""
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ours = call_batch(to_port(batch, pt.ReadBatch), pt.GroupingParams(**vars(gp)),
                          pt.ConsensusParams(**vars(cp)), capacity=capacity, report=report,
                          device="cpu")
        theirs = call_batch_tpu(batch, gp, cp, capacity=capacity, report=jax_report)
    return ours, theirs


def assert_oracle_bar(ours, oracle):
    """The JAX suite's bar against the oracle: positions, UMIs, bases and
    depth equal; quals within 3, within 1 on over 97 % of cycles."""
    for i in (0, 2, 4, 5):
        np.testing.assert_array_equal(ours[i], oracle[i], err_msg=str(i))
    dq = np.abs(ours[1].astype(int) - oracle[1].astype(int))
    assert (dq <= 3).all() and (dq <= 1).mean() > 0.97


def _oversized(n_molecules: int, seed: int):
    batch, _ = simulate_batch(SimConfig(n_molecules=n_molecules, n_positions=2,
                                        mean_family_size=4, umi_error=0.04, duplex=True,
                                        seed=seed))
    pos = np.asarray(batch.pos_key)[np.asarray(batch.valid, bool)]
    assert np.unique(pos, return_counts=True)[1].max() > 3 * 256
    return batch


def test_oversized_position_group_adjacency_matches_jax_and_the_oracle():
    batch = _oversized(220, 42)
    gp, cp = JG(strategy="adjacency", paired=True), JC(mode="duplex", min_duplex_reads=1)
    ours, theirs = both_calls(batch, gp, cp, 256)
    call_parity(ours, theirs, duplex=True)
    assert_oracle_bar(ours, jax_oracle_call(batch, gp, cp))


@pytest.mark.parametrize("strategy", ["cluster", "adjacency"])
def test_faults20_duplex_call_flipped_by_strand_quals_is_a_counted_tie(strategy):
    """ROADMAP Faults 20 on tests/test_jumbo.py's seed-43 input: the port
    may differ from the JAX package and from both oracles (which agree
    with each other) at one duplex cycle only, N against a base or
    another base at qual 2, and everywhere else the outputs agree."""
    batch = _oversized(200, 43)
    gp, cp = JG(strategy=strategy, paired=True), JC(mode="duplex", min_duplex_reads=1)
    ours, theirs = both_calls(batch, gp, cp, 256)
    jax_oracle = jax_oracle_call(batch, gp, cp)
    port_oracle = call_batch_cpu(to_port(batch, pt.ReadBatch), pt.GroupingParams(**vars(gp)),
                                 pt.ConsensusParams(**vars(cp)))
    for i in range(9):
        np.testing.assert_array_equal(port_oracle[i], jax_oracle[i])
    assert ours[0].size == 8_928
    # the JAX device path calls the oracle's bases here
    np.testing.assert_array_equal(theirs[0], jax_oracle[0])
    for other, oracle in ((theirs, False), (jax_oracle, True)):
        kinds = call_parity(ours, other, duplex=True, max_ties=1, oracle=oracle)
        assert kinds["qual_move"] == 0


def test_faults1_one_read_family_floor_is_where_the_flip_comes_from():
    """The strand-level cause of Faults 20: a one-read family of qual 24
    gets strand qual 23 in the port on this CPU and 24 in the JAX
    package. Both are inside Faults 1's one-apart bar."""
    import jax.numpy as jnp
    import torch

    from duplexumiconsensusreads_tpu.kernels import consensus as jk
    from duplexumiconsensusreads_torch.kernels import consensus as pk

    q = np.arange(94, dtype=np.uint8)
    bases = np.zeros((94, 4), np.uint8)
    quals = np.repeat(q[:, None], 4, 1)
    fid = np.arange(94, dtype=np.int32)
    valid = np.ones(94, bool)
    kw = dict(f_max=128, max_qual=93, max_input_qual=93)
    j = np.asarray(jk.ssc_kernel(jnp.asarray(bases), jnp.asarray(quals), jnp.asarray(fid),
                                 jnp.asarray(valid), method="segment", **kw)[1])[:94, 0]
    p = pk.ssc_kernel(*(torch.from_numpy(a)[None] for a in (bases, quals, fid, valid)),
                      **kw)[1][0, :94, 0].numpy()
    assert (j[24], p[24]) == (24, 23)
    assert np.abs(j.astype(int) - p.astype(int)).max() <= 1


def test_oversized_group_buckets_equal_jax():
    batch, _ = simulate_batch(SimConfig(n_molecules=150, n_positions=1, umi_error=0.03,
                                        duplex=True, seed=5))
    gp = JG(strategy="adjacency", paired=True)
    theirs = jax_build_buckets(batch, capacity=128, grouping=gp)
    ours = build_buckets(to_port(batch, pt.ReadBatch), capacity=128,
                         grouping=pt.GroupingParams(**vars(gp)))
    assert any(b.preclustered for b in ours)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert (a.capacity, a.preclustered, a.n_unique_umi) == (
            b.capacity, b.preclustered, b.n_unique_umi)
        assert a.capacity >= 128
        assert a.capacity & (a.capacity - 1) == 0 or a.capacity == 128
        for f in ("pos", "umi", "strand_ab", "frag_end", "valid", "bases", "quals",
                  "read_index"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


def _one_position(n, l, u, seed, umi_jitter=0.0, mixed_strands=False):
    rng = np.random.default_rng(seed)
    umi = np.tile(rng.integers(0, 4, size=u, dtype=np.uint8), (n, 1))
    if umi_jitter:
        off = rng.random(n) < umi_jitter
        col = rng.integers(0, u, size=n)
        umi[off, col[off]] = (umi[off, col[off]] + 1) % 4
    batch = JaxBatch(
        bases=np.tile(rng.integers(0, 4, size=l, dtype=np.uint8), (n, 1)),
        quals=rng.integers(20, 40, size=(n, l), dtype=np.uint8), umi=umi,
        pos_key=np.full(n, 5000, np.int64),
        strand_ab=rng.random(n) < 0.5 if mixed_strands else np.ones(n, bool),
        frag_end=np.zeros(n, bool), valid=np.ones(n, bool))
    return batch, rng


def test_jumbo_family_exact_matches_jax_and_the_oracle():
    """One exact family of 700 reads at capacity 256: ONE consensus from
    a pow2(700) = 1024 bucket, in both packages and the oracle."""
    batch, rng = _one_position(700, 40, 6, 11)
    err = rng.random(batch.bases.shape) < 0.05
    batch.bases[err] = (batch.bases[err] + 1) % 4
    gp, cp = JG(strategy="exact"), JC(mode="single_strand", min_reads=2)
    ours_bk = build_buckets(to_port(batch, pt.ReadBatch), capacity=256,
                            grouping=pt.GroupingParams(**vars(gp)))
    assert [b.capacity for b in ours_bk] == [b.capacity for b in
                                             jax_build_buckets(batch, capacity=256, grouping=gp)]
    assert [b.capacity for b in ours_bk] == [1024]
    ours, theirs = both_calls(batch, gp, cp, 256)
    call_parity(ours, theirs, duplex=False)
    oracle = jax_oracle_call(batch, gp, cp)
    assert len(ours[0]) == len(oracle[0]) == 1
    np.testing.assert_array_equal(ours[0], oracle[0])
    np.testing.assert_array_equal(ours[2], oracle[2])


def test_jumbo_cluster_adjacency_duplex_matches_jax_and_the_oracle():
    """An adjacency cluster of 600 reads (15 % one UMI base off) at
    capacity 256: a preclustered jumbo bucket in both packages."""
    batch, _ = _one_position(600, 32, 12, 13, umi_jitter=0.15, mixed_strands=True)
    gp, cp = JG(strategy="adjacency", paired=True), JC(mode="duplex", min_duplex_reads=1)
    ours, theirs = both_calls(batch, gp, cp, 256)
    call_parity(ours, theirs, duplex=True)
    assert_oracle_bar(ours, jax_oracle_call(batch, gp, cp))


def test_precluster_fallback_does_not_duplicate_reads(monkeypatch):
    """Past PRECLUSTER_MAX_UNIQUE the group falls back (warned, counted)
    and the next group does not re-emit its reads: the same buckets and
    counters as the JAX package's under the same limit."""
    import duplexumiconsensusreads_tpu.bucketing.buckets as jax_bmod

    monkeypatch.setattr(jax_bmod, "PRECLUSTER_MAX_UNIQUE", 4)
    monkeypatch.setattr(port_buckets, "PRECLUSTER_MAX_UNIQUE", 4)
    rng = np.random.default_rng(3)
    n1, n2, l, u = 40, 10, 16, 6
    batch = JaxBatch(
        bases=rng.integers(0, 4, size=(n1 + n2, l), dtype=np.uint8),
        quals=np.full((n1 + n2, l), 30, np.uint8),
        umi=rng.integers(0, 4, size=(n1 + n2, u), dtype=np.uint8),
        pos_key=np.r_[np.full(n1, 1000, np.int64), np.full(n2, 2000, np.int64)],
        strand_ab=np.ones(n1 + n2, bool), frag_end=np.zeros(n1 + n2, bool),
        valid=np.ones(n1 + n2, bool))
    gp = JG(strategy="adjacency", paired=True)
    counters, jax_counters = {}, {}
    with pytest.warns(UserWarning, match="precluster limit"):
        ours = build_buckets(to_port(batch, pt.ReadBatch), capacity=16,
                             grouping=pt.GroupingParams(**vars(gp)), counters=counters)
    with pytest.warns(UserWarning, match="precluster limit"):
        theirs = jax_build_buckets(batch, capacity=16, grouping=gp, counters=jax_counters)
    assert counters == jax_counters
    assert counters["n_precluster_fallback_groups"] == 1
    assert counters["n_precluster_fallback_reads"] == n1
    seen = np.concatenate([bk.read_index[bk.read_index >= 0] for bk in ours])
    assert len(seen) == len(np.unique(seen)) == n1 + n2
    assert [b.read_index.tolist() for b in ours] == [b.read_index.tolist() for b in theirs]


def test_fallback_counters_in_report_equal_jax():
    """A 600-read family at capacity 4 (jumbo limit 256) is hard-cut into
    3 pieces, each its own record, in both packages; a standard workload
    leaves every fallback counter at 0."""
    batch, _ = _one_position(600, 24, 6, 7)
    batch.quals[:] = 30
    gp, cp = JG(strategy="exact"), JC(mode="single_strand")
    rep, jrep = RunReport(), JaxReport()
    with pytest.warns(UserWarning, match="jumbo bucket limit"):
        ours = call_batch(to_port(batch, pt.ReadBatch), pt.GroupingParams(**vars(gp)),
                          pt.ConsensusParams(**vars(cp)), capacity=4, report=rep, device="cpu")
    with pytest.warns(UserWarning, match="jumbo bucket limit"):
        theirs = call_batch_tpu(batch, gp, cp, capacity=4, report=jrep)
    call_parity(ours, theirs, duplex=False)
    assert len(ours[0]) == 3
    for k in port_buckets.FALLBACK_COUNTERS:
        assert getattr(rep, k) == getattr(jrep, k), k
    assert (rep.n_jumbo_hardcut_families, rep.n_jumbo_hardcut_splits) == (1, 3)
    sim, _ = simulate_batch(SimConfig(n_molecules=120, duplex=True, umi_error=0.02, seed=5))
    rep2 = RunReport()
    call_batch(to_port(sim, pt.ReadBatch), pt.GroupingParams("adjacency", paired=True),
               pt.ConsensusParams(mode="duplex"), capacity=512, report=rep2, device="cpu")
    for k in port_buckets.FALLBACK_COUNTERS:
        assert getattr(rep2, k) == 0, k


def test_streaming_oversized_group_matches_whole_file_and_jax(tmp_path):
    """An oversized group streamed in 200-read chunks equals the port's
    whole-file call byte for byte in seq and qual, and the JAX CLI's
    whole-file call at the parity bar."""
    from test_torch_cli import assert_parity

    inp = str(tmp_path / "in.bam")
    assert cli_main(["simulate", "--out", inp, "--molecules", "160", "--positions", "2",
                     "--umi-error", "0.03", "--sorted", "--seed", "9"]) == 0
    common = ["--config", "config3", "--capacity", "128"]
    out = {k: str(tmp_path / f"{k}.bam") for k in ("whole", "stream", "jax")}
    assert cli_main(["call", inp, "-o", out["whole"], "--device", "cpu", *common]) == 0
    assert cli_main(["call", inp, "-o", out["stream"], "--device", "cpu", "--chunk-reads",
                     "200", *common]) == 0
    assert jax_main(["call", inp, "-o", out["jax"], *common]) == 0
    _, rw = read_bam(out["whole"])
    _, rs = read_bam(out["stream"])
    assert len(rw) == len(rs) > 0
    for f in ("pos", "seq", "qual"):
        np.testing.assert_array_equal(getattr(rw, f), getattr(rs, f), err_msg=f)
    assert assert_parity(out["jax"], out["whole"], duplex=True) == 0


def _records(seq, qual):
    from duplexumiconsensusreads_torch.io.bam import BamRecords

    n, l = seq.shape
    return BamRecords(
        names=[f"c{i}" for i in range(n)], flags=np.zeros(n, np.uint16),
        ref_id=np.zeros(n, np.int32), pos=np.arange(n, dtype=np.int32) * 10,
        mapq=np.full(n, 60, np.uint8), next_ref_id=np.full(n, -1, np.int32),
        next_pos=np.full(n, -1, np.int32), tlen=np.zeros(n, np.int32),
        lengths=np.full(n, l, np.int32), seq=seq, qual=qual,
        cigars=[[(l, "M")]] * n, umi=["ACGTAA"] * n, aux_raw=[b"RXZACGTAA\x00"] * n)


@pytest.mark.parametrize("other_base", [4, 1], ids=["n_call", "strand_qual_flip"])
def test_compare_records_counts_a_faults20_cycle_and_refuses_past_its_limit(other_base):
    """chip_smoke.compare_records on 10 duplex records of 1,000 cycles:
    one cycle at qual 2 on both sides, A against N (or against C), is a
    counted tie of its kind; two such cycles pass 1 in 10,000 and are
    refused; without duplex_ties the one cycle is a seq mismatch."""
    from chip_smoke import compare_records

    rng = np.random.default_rng(0)
    seq = rng.integers(0, 4, (10, 1000)).astype(np.uint8)
    qual = rng.integers(30, 90, (10, 1000)).astype(np.uint8)
    seq[3, 40], qual[3, 40] = 0, 2
    a = _records(seq, qual)
    seq_b, qual_b = seq.copy(), qual.copy()
    seq_b[3, 40] = other_base
    qual_b[:, :] += (rng.random(qual.shape) < 0.5).astype(np.uint8) * 2
    qual_b[3, 40] = 2
    out = compare_records(a, _records(seq_b, qual_b), qual_tol=2, duplex_ties=True)
    kind = "n_call" if other_base == 4 else "strand_qual_flip"
    assert out["tie_cycles"] == out["tie_kinds"][kind] == 1
    assert sum(out["tie_kinds"].values()) == 1 and out["max_qual_diff"] == 2
    with pytest.raises(AssertionError, match="consensus records differ in seq"):
        compare_records(a, _records(seq_b, qual_b), qual_tol=2)
    seq_b[7, 900], qual_b[7, 900], qual[7, 900] = other_base, 2, 2
    seq[7, 900] = 2
    with pytest.raises(AssertionError, match="more than 1 in 10,000"):
        compare_records(_records(seq, qual), _records(seq_b, qual_b), qual_tol=2,
                        duplex_ties=True)
