"""The benchmark's generator: deterministic, with the same sizes for
every seed, and cut into chunks as the program's streaming call cuts
its input."""

from __future__ import annotations

import numpy as np
import pytest

from portbench.gen.sim import simulate
from portbench.reference.partition import chunk_bounds

SIM = dict(n_molecules=900, block_molecules=300, read_len=150, umi_len=6, n_positions=12,
           mean_family_size=4, max_family_size=16, base_error=0.01, cycle_error_slope=0.002,
           umi_error=0.01, qual_lo=20, qual_hi=40, duplex=True)
FIELDS = ("pos", "umi", "strand_ab", "bases", "quals")


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 12345, 2**40 + 3])
def test_same_seed_same_reads(seed):
    a, b = simulate(SIM, seed), simulate(SIM, seed, threads=1)
    assert all(np.array_equal(getattr(a, f), getattr(b, f)) for f in FIELDS)
    other = simulate(SIM, seed + 1)
    assert not np.array_equal(a.bases, other.bases) and not np.array_equal(a.umi, other.umi)
    # the same sizes for every seed: positions and read counts
    assert a.n == other.n and np.array_equal(a.pos, other.pos)


def test_reads_follow_the_model():
    r = simulate(SIM, 5)
    assert (np.diff(r.pos) >= 0).all()
    assert r.bases.shape[1] == 150 and r.umi.shape[1] == 12
    assert 20 <= r.quals.min() and r.quals.max() <= 40
    assert 0.3 < r.strand_ab.mean() < 0.7
    # four reads a strand on average, two strands a molecule
    assert 6.0 < r.n / SIM["n_molecules"] < 9.0


def _write_bam(path, r, duplex):
    """The reads as a coordinate-sorted BAM, by the program's own writer."""
    from duplexumiconsensusreads_torch.io.bam import BamHeader, write_bam
    from duplexumiconsensusreads_torch.io.convert import readbatch_to_records
    from duplexumiconsensusreads_torch.types import ReadBatch

    batch = ReadBatch(bases=r.bases, quals=r.quals, umi=r.umi, pos_key=r.pos.astype(np.int64),
                      strand_ab=r.strand_ab, frag_end=np.zeros(r.n, bool),
                      valid=np.ones(r.n, bool))
    header = BamHeader.synthetic(ref_lengths=(10_000_000,), sort_order="coordinate")
    write_bam(path, header, readbatch_to_records(batch, duplex=duplex))


def test_chunks_are_the_streaming_executors(tmp_path):
    from duplexumiconsensusreads_torch.runtime.stream import iter_batch_chunks

    r = simulate(SIM, 3)
    path = str(tmp_path / "in.bam")
    _write_bam(path, r, True)
    for chunk_reads in (500, 1234, r.n // 2, r.n + 5):
        sizes = [b.n_reads for _, b, _ in iter_batch_chunks(path, chunk_reads, True)]
        assert sizes == [b - a for a, b in chunk_bounds(r.pos, chunk_reads)]
