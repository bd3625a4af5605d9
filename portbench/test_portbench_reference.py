"""The plain reference against the program's CPU path (the plain
kernels, driven as the resident cells drive the card) on tiny inputs,
and the control it fails."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench.gen.sim import simulate
from portbench.lib import cell, compare
from portbench.reference.consensus import expected_records
from portbench.reference.grouping import directional_seeds
from portbench.reference.partition import all_buckets, chunk_bounds

BASE = dict(read_len=150, umi_len=6, max_family_size=16, base_error=0.01, qual_lo=20,
            qual_hi=40)
CASES = {
    "duplex_cycle": (
        dict(BASE, n_molecules=1200, block_molecules=400, n_positions=16, mean_family_size=4,
             cycle_error_slope=0.002, umi_error=0.01, duplex=True),
        dict(strategy="adjacency", max_hamming=1, count_ratio=2, paired=True),
        dict(mode="duplex", min_reads=1, min_duplex_reads=1, max_qual=90, max_input_qual=50,
             min_input_qual=10, error_model="cycle")),
    "single_strand_exact": (
        dict(BASE, n_molecules=1200, block_molecules=600, n_positions=3, mean_family_size=6,
             cycle_error_slope=0.0, umi_error=0.0, duplex=False),
        dict(strategy="exact", max_hamming=1, count_ratio=2, paired=False),
        dict(mode="single_strand", min_reads=1, min_duplex_reads=1, max_qual=90,
             max_input_qual=50, min_input_qual=10, error_model=None)),
    "duplex_min_reads": (
        dict(BASE, n_molecules=800, block_molecules=400, n_positions=10, mean_family_size=3,
             cycle_error_slope=0.0, umi_error=0.02, duplex=True),
        dict(strategy="adjacency", max_hamming=1, count_ratio=2, paired=True),
        dict(mode="duplex", min_reads=2, min_duplex_reads=2, max_qual=60, max_input_qual=35,
             min_input_qual=22, error_model=None)),
}
# the program's CPU path adds the float32 evidence in another order than
# its kernel on the card (blockseg), so against the reference a quality
# may move at a Phred boundary; grouping, depths and bases may not
CPU_LIMITS = {"unit_mismatch": 0, "depth_mismatch": 0, "base_mismatch_share": 0,
              "qual_mismatch_share": 1e-3}
# the cell whose limits each case's control has to fail
CASE_CELL = {"duplex_cycle": "ctdna_duplex.resident", "single_strand_exact": "amplicon_ss.resident"}


@pytest.mark.parametrize("chunk_reads", [0, 3000])
@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_agrees_with_the_program(case, chunk_reads):
    """Every bucket of the resident driver's classes, stepped on the CPU,
    against the reference."""
    import torch

    sim, g, c = CASES[case]
    driver = cell.load_module(f"{cell.PKG}/drivers/resident.py", "t_resident")
    ctx = cell.Ctx(name=case, workload={}, config={"sim": sim, "grouping": g, "consensus": c,
                                                    "capacity": 512},
                   traffic={"chunk_reads": chunk_reads, "warm_passes": 1}, seed=99,
                   seconds=0.0, trace=False, device=torch.device("cpu"))
    with torch.no_grad():
        driver.setup(ctx)
        r = ctx.reads
        buckets = [b for b, _ in all_buckets(r.pos, r.umi, chunk_reads, 512,
                                             g["strategy"] != "exact")]
        observed = driver.observe(ctx, buckets)
    assert ctx.counters["buckets_found"] == len(buckets)
    assert ctx.counters["classes_compared"] == ctx.counters["classes"]
    numbers = compare.compare(expected_records(r, buckets, g, c), observed)
    assert numbers["units"] > 100
    assert compare.judge(numbers, CPU_LIMITS)[0], numbers


@pytest.mark.parametrize("case", sorted(CASES))
def test_buckets_are_the_programs(case):
    from duplexumiconsensusreads_torch.bucketing import build_buckets
    from duplexumiconsensusreads_torch.types import GroupingParams, ReadBatch

    sim, g, _ = CASES[case]
    r = simulate(sim, 4)
    for a, b in chunk_bounds(r.pos, 2500):
        n = b - a
        batch = ReadBatch(bases=r.bases[a:b], quals=r.quals[a:b], umi=r.umi[a:b],
                          pos_key=r.pos[a:b], strand_ab=r.strand_ab[a:b],
                          frag_end=np.zeros(n, bool), valid=np.ones(n, bool))
        prog = [(bk.read_index[bk.valid] + a, bk.capacity)
                for bk in build_buckets(batch, capacity=512, grouping=GroupingParams(**g))]
        ref = all_buckets(r.pos[a:b], r.umi[a:b], 0, 512, g["strategy"] != "exact")
        assert len(prog) == len(ref)
        for (pi, pc), (ri, rc) in zip(prog, ref):
            assert pc == rc and np.array_equal(pi, ri + a)


def test_directional_seeds_are_umi_tools():
    from duplexumiconsensusreads_torch.oracle.grouping import directional_seeds as oracle

    rng = np.random.default_rng(0)
    for _ in range(20):
        true = rng.integers(0, 4, (int(rng.integers(1, 6)), 6), dtype=np.uint8)
        reads = true[rng.integers(0, len(true), 200)]
        err = rng.random(reads.shape) < 0.03
        reads = np.where(err, (reads + 1) % 4, reads).astype(np.uint8)
        uu, cnt = np.unique(reads, axis=0, return_counts=True)
        for ratio in (2, 0):
            got, _ = directional_seeds(uu, cnt, 1, ratio)
            assert np.array_equal(got, oracle(uu, cnt, 1, ratio))


@pytest.mark.parametrize("case", sorted(CASE_CELL))
def test_control_fails_the_check(case):
    """The reference in bfloat16, a precision below the configuration's
    float32, in the program's place: the cell's check has to refuse it."""
    sim, g, c = CASES[case]
    r = simulate(sim, 21)
    buckets = [b for b, _ in all_buckets(r.pos, r.umi, 0, 512, g["strategy"] != "exact")]
    ref = expected_records(r, buckets, g, c)
    ctl = expected_records(r, buckets, g, c, dtype=torch.bfloat16)
    numbers = compare.compare(ref, ctl)
    limits = cell.load_json(cell.PKG, "limits", CASE_CELL[case] + ".json")
    assert not compare.judge(numbers, limits)[0]
    assert numbers["qual_mismatch_share"] > limits["qual_mismatch_share"]
