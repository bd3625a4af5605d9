"""The port's NumPy oracle against the JAX package's, and its own
contract against the simulator's truth (the contracts of
tests/test_oracle.py).

Every case runs the same seeded batch through both packages' oracle
(``group_reads``, ``call_consensus``, the cycle error model): the
outputs are identical, array for array. The truth claims of the JAX
suite (grouping recovers molecules, consensus beats the raw error,
duplex beats single strand, the cycle caps fall with the cycle, N
bases carry no evidence, cluster merges where directional splits) are
then checked on the port's outputs.
"""

from __future__ import annotations

import numpy as np

from duplexumiconsensusreads_tpu import oracle as jax_oracle
from duplexumiconsensusreads_tpu import types as jt
from duplexumiconsensusreads_torch import oracle
from duplexumiconsensusreads_torch import types as pt
from duplexumiconsensusreads_torch.constants import BASE_N, N_REAL_BASES
from duplexumiconsensusreads_torch.simulate import SimConfig, simulate_batch
from test_torch_jumbo import to_port

FAMS = ("family_id", "molecule_id", "pair_id", "n_families", "n_molecules")
CONS = ("bases", "quals", "depth", "valid", "err")


def group(batch, **kw):
    """The port's oracle grouping, asserted equal to the JAX oracle's."""
    gp = pt.GroupingParams(**kw)
    fams = oracle.group_reads(batch, gp)
    theirs = jax_oracle.group_reads(to_port(batch, jt.ReadBatch), jt.GroupingParams(**kw))
    for f in FAMS:
        np.testing.assert_array_equal(np.asarray(getattr(fams, f)),
                                      np.asarray(getattr(theirs, f)), err_msg=f)
    return fams


def call(batch, fams, **kw):
    """The port's oracle consensus, asserted equal to the JAX oracle's."""
    cons = oracle.call_consensus(batch, fams, pt.ConsensusParams(**kw))
    theirs = jax_oracle.call_consensus(to_port(batch, jt.ReadBatch),
                                       to_port(fams, jt.FamilyAssignment),
                                       jt.ConsensusParams(**kw))
    for f in CONS:
        a, b = getattr(cons, f), getattr(theirs, f)
        if a is None or b is None:
            assert a is None and b is None, f
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=f)
    return cons


def test_exact_grouping_recovers_molecules_alike():
    batch, truth = simulate_batch(SimConfig(n_molecules=40, duplex=False, umi_error=0.0, seed=1))
    fam = np.asarray(group(batch, strategy="exact", paired=False).family_id)
    for f in np.unique(fam[fam >= 0]):
        assert len(np.unique(truth.read_mol[fam == f])) == 1
    for m in np.unique(truth.read_mol):
        assert len(np.unique(fam[truth.read_mol == m])) == 1


def test_adjacency_grouping_heals_umi_errors_alike():
    batch, truth = simulate_batch(SimConfig(n_molecules=30, duplex=False, umi_error=0.03,
                                            mean_family_size=6, seed=2))
    exact = group(batch, strategy="exact")
    adj = group(batch, strategy="adjacency", max_hamming=1)
    assert int(adj.n_families) < int(exact.n_families)
    fam = np.asarray(adj.family_id)
    correct = sum(np.unique(truth.read_mol[fam == f], return_counts=True)[1].max()
                  for f in range(int(adj.n_families)))
    assert correct / batch.n_reads > 0.95


def _error_rate(cons, ids, truth) -> float:
    errs = total = 0
    for f in range(len(cons.valid)):
        if not cons.valid[f]:
            continue
        mol = truth.read_mol[np.nonzero(ids == f)[0][0]]
        called = cons.bases[f] < N_REAL_BASES
        total += called.sum()
        errs += (cons.bases[f][called] != truth.mol_seq[mol][called]).sum()
    assert total > 0
    return errs / total


def test_ss_consensus_beats_raw_error_rate_alike():
    cfg = SimConfig(n_molecules=50, duplex=False, base_error=0.02, mean_family_size=6, seed=3)
    batch, truth = simulate_batch(cfg)
    fams = group(batch, strategy="exact")
    cons = call(batch, fams, mode="single_strand", min_reads=3)
    assert _error_rate(cons, np.asarray(fams.family_id), truth) < cfg.base_error / 4


def test_duplex_consensus_better_than_single_strand_alike():
    batch, truth = simulate_batch(SimConfig(n_molecules=120, duplex=True, base_error=0.08,
                                            mean_family_size=5, seed=4))
    fams = group(batch, strategy="exact", paired=True)
    ss = call(batch, fams, mode="single_strand", min_reads=2)
    dx = call(batch, fams, mode="duplex", min_reads=2, min_duplex_reads=2)
    e_ss = _error_rate(ss, np.asarray(fams.family_id), truth)
    e_dx = _error_rate(dx, np.asarray(fams.molecule_id), truth)
    assert e_dx < e_ss and e_dx < 2e-3


def test_duplex_quality_boost_on_agreement_alike():
    batch, _ = simulate_batch(SimConfig(n_molecules=20, duplex=True, base_error=0.001, seed=5))
    fams = group(batch, strategy="exact", paired=True)
    ss = call(batch, fams, mode="single_strand")
    dx = call(batch, fams, mode="duplex")
    assert dx.quals[dx.valid].mean() > ss.quals[ss.valid].mean()


def test_cycle_error_model_caps_late_cycles_alike():
    batch, _ = simulate_batch(SimConfig(n_molecules=80, duplex=False, base_error=0.002,
                                        cycle_error_slope=0.002, mean_family_size=8,
                                        read_len=60, seed=6))
    fams = group(batch, strategy="exact")
    ss = call(batch, fams, mode="single_strand")
    cap = oracle.fit_cycle_error_model(batch, fams, ss)
    jb, jf = to_port(batch, jt.ReadBatch), to_port(fams, jt.FamilyAssignment)
    jss = jax_oracle.call_consensus(jb, jf, jt.ConsensusParams(mode="single_strand"))
    np.testing.assert_array_equal(cap, jax_oracle.fit_cycle_error_model(jb, jf, jss))
    assert cap[:10].mean() > cap[-10:].mean() + 3
    adj = oracle.apply_cycle_error_model(np.asarray(batch.quals), cap)
    np.testing.assert_array_equal(adj, jax_oracle.apply_cycle_error_model(batch.quals, cap))
    assert (adj <= np.asarray(batch.quals)).all() and (adj[:, -5:] <= cap[-5:][None, :]).all()


def test_min_reads_filters_small_families_alike():
    batch, _ = simulate_batch(SimConfig(n_molecules=30, duplex=False, mean_family_size=2, seed=7))
    fams = group(batch, strategy="exact")
    cons = call(batch, fams, min_reads=3)
    fam = np.asarray(fams.family_id)
    sizes = np.bincount(fam[fam >= 0], minlength=int(fams.n_families))
    np.testing.assert_array_equal(cons.valid, sizes >= 3)


def test_n_bases_carry_no_evidence_alike():
    batch, _ = simulate_batch(SimConfig(n_molecules=20, duplex=False, n_frac=0.2, seed=8))
    fams = group(batch, strategy="exact")
    cons = call(batch, fams)
    sel = np.nonzero(np.asarray(fams.family_id) == 0)[0]
    depth_expected = (np.asarray(batch.bases)[sel] < N_REAL_BASES).sum(axis=0)
    np.testing.assert_array_equal(cons.depth[0], depth_expected)
    assert (cons.bases[0][depth_expected == 0] == BASE_N).all()


def test_cluster_merges_where_directional_splits_alike():
    """Two Hamming-1 UMIs with counts 5 and 4: adjacency keeps two
    molecules (no directional edge either way), cluster collapses them
    to one, in both packages' oracle."""
    n, L = 9, 20
    batch = pt.ReadBatch.empty(n, L, 4)
    batch.umi[:5] = np.array([0, 1, 2, 3], np.uint8)
    batch.umi[5:] = np.array([0, 1, 2, 0], np.uint8)
    batch.bases[:] = 1
    batch.quals[:] = 30
    batch.valid[:] = True
    batch.strand_ab[:] = True
    batch.pos_key[:] = 7
    assert int(group(batch, strategy="adjacency").n_molecules) == 2
    clu = group(batch, strategy="cluster")
    assert int(clu.n_molecules) == 1
    assert len(set(np.asarray(clu.family_id)[batch.valid])) == 1
