"""The torch port's consensus kernels against the JAX package's.

ssc_kernel (full, fit and want_err columns) on the same numpy inputs:
integer outputs (depth, family size and validity, disagreement counts)
and consensus bases must be identical; quals may move by one, because
pow/log1p/log/exp/log10 differ by ULPs between XLA and torch and a
one-read family's Phred sits exactly on its floor boundary.
duplex_merge_strided is pure integer logic and must be bit-identical.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from duplexumiconsensusreads_tpu.kernels.consensus import (
    duplex_kernel as jax_duplex,
    duplex_merge_strided as jax_merge,
    ssc_kernel as jax_ssc,
)
from duplexumiconsensusreads_tpu.oracle import group_reads
from duplexumiconsensusreads_tpu.simulate import SimConfig, simulate_batch
from duplexumiconsensusreads_tpu.types import GroupingParams
from duplexumiconsensusreads_torch.kernels.consensus import (
    duplex_kernel,
    duplex_merge_strided,
    ssc_kernel,
)

F_MAX = 256


def _inputs(seed, min_qual_n=False):
    batch, _ = simulate_batch(
        SimConfig(n_molecules=70, read_len=32, n_positions=6, duplex=False,
                  n_frac=0.02, seed=seed)
    )
    fams = group_reads(batch, GroupingParams(strategy="exact"))
    bases = np.asarray(batch.bases)
    quals = np.asarray(batch.quals)
    if min_qual_n:
        quals = np.where(bases == 4, 0, quals).astype(np.uint8)  # qual-0 N cycles
    fid = np.asarray(fams.family_id).astype(np.int32)
    valid = np.asarray(batch.valid)
    valid[::17] = False  # invalid reads contribute nowhere
    return bases, quals, fid, valid


def _port(bases, quals, fid, valid, **kw):
    t = [torch.from_numpy(np.ascontiguousarray(x))[None] for x in (bases, quals, fid, valid)]
    return [o[0].numpy() for o in ssc_kernel(*t, **kw)]


@pytest.mark.parametrize("jax_method", ["pallas_interpret", "matmul"])
@pytest.mark.parametrize("want_err", [False, True])
@pytest.mark.parametrize("min_input_qual", [0, 25])
def test_ssc_full_matches_jax(jax_method, want_err, min_input_qual):
    x = _inputs(1, min_qual_n=True)
    kw = dict(f_max=F_MAX, min_reads=2, min_input_qual=min_input_qual, want_err=want_err)
    want = [np.asarray(o) for o in jax_ssc(*x, method=jax_method, **kw)]
    got = _port(*x, **kw)
    names = ["cons_base", "cons_qual", "depth", "fam_size", "fam_valid", "err"]
    assert len(got) == len(want)
    for name, w, g in zip(names, want, got):
        assert g.dtype == w.dtype, name
        if name == "cons_qual":
            assert np.abs(g.astype(int) - w.astype(int)).max() <= 1
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    assert want[4].sum() > 10


@pytest.mark.parametrize("min_input_qual", [0, 25])
def test_ssc_fit_columns_match_jax(min_input_qual):
    x = _inputs(2)
    kw = dict(f_max=F_MAX, min_reads=2, min_input_qual=min_input_qual, columns="fit")
    want = [np.asarray(o) for o in jax_ssc(*x, method="matmul", **kw)]
    got = _port(*x, **kw)
    assert len(got) == 3
    for name, w, g in zip(("cons_base", "fam_size", "fam_valid"), want, got):
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("method", ["segment_gemm", "segment", "matmul"])
def test_port_methods_agree_exactly_on_integers(method):
    x = _inputs(3)
    ref = _port(*x, f_max=F_MAX, method="segment_gemm")
    got = _port(*x, f_max=F_MAX, method=method)
    for i, (r, g) in enumerate(zip(ref, got)):
        if i == 1:  # cons_qual: the matmul sums in another order
            assert np.abs(r - g).max() <= 1
        else:
            np.testing.assert_array_equal(r, g)


def test_argmax_ties_go_to_the_first_maximum():
    # two reads, same qual, disagreeing A vs C at every cycle: the
    # log-likelihoods of A and C tie exactly and both sides call A
    bases = np.array([[0, 0, 0], [1, 1, 1]], np.uint8)
    quals = np.full((2, 3), 30, np.uint8)
    fid = np.zeros(2, np.int32)
    valid = np.ones(2, bool)
    want = [np.asarray(o) for o in jax_ssc(bases, quals, fid, valid, f_max=2)]
    got = _port(bases, quals, fid, valid, f_max=2)
    assert (got[0][0] == 0).all()
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_unknown_method_and_columns_raise():
    x = _inputs(4)
    with pytest.raises(ValueError):
        _port(*x, f_max=F_MAX, method="blockseg")
    with pytest.raises(ValueError):
        _port(*x, f_max=F_MAX, columns="fit_counts")


@pytest.mark.parametrize("want_err", [False, True])
@pytest.mark.parametrize("min_duplex_reads", [1, 2])
def test_duplex_merge_strided_bit_identical(want_err, min_duplex_reads):
    rng = np.random.default_rng(5)
    m, l = 40, 16
    cb = rng.integers(0, 5, (2 * m, l)).astype(np.int32)
    cq = rng.integers(2, 60, (2 * m, l)).astype(np.int32)
    cq[cb == 4] = 2
    dep = rng.integers(0, 6, (2 * m, l)).astype(np.int32)
    size = rng.integers(0, 4, 2 * m).astype(np.int32)
    fv = size >= 1
    err = rng.integers(0, 3, (2 * m, l)).astype(np.int32)
    kw = dict(m_max=m, min_duplex_reads=min_duplex_reads, max_qual=90, want_err=want_err)
    want = jax.jit(lambda *a: jax_merge(*a, **kw))(cb, cq, dep, size, fv, err)
    got = duplex_merge_strided(
        *(torch.from_numpy(a)[None] for a in (cb, cq, dep, size, fv, err)), **kw
    )
    assert len(got) == len(want)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(w))


@pytest.mark.parametrize("want_err", [False, True])
@pytest.mark.parametrize("min_duplex_reads", [1, 2])
def test_duplex_kernel_bit_identical(want_err, min_duplex_reads):
    rng = np.random.default_rng(8)
    f, m, r, l = 48, 20, 160, 12
    cb = rng.integers(0, 5, (f, l)).astype(np.int32)
    cq = rng.integers(2, 60, (f, l)).astype(np.int32)
    dep = rng.integers(0, 6, (f, l)).astype(np.int32)
    fv = rng.random(f) > 0.2
    err = rng.integers(0, 3, (f, l)).astype(np.int32)
    mol = rng.integers(-1, m, r).astype(np.int32)
    strand = rng.random(r) > 0.5
    # a molecule's strands map to families 2m / 2m+1 (sometimes shared)
    fam = np.where(mol >= 0, mol * 2 + (~strand) * (rng.random(r) > 0.1), -1).astype(np.int32)
    valid = rng.random(r) > 0.05
    kw = dict(m_max=m, min_duplex_reads=min_duplex_reads, max_qual=90, want_err=want_err)
    want = jax.jit(lambda *a: jax_duplex(*a, **kw))(cb, cq, dep, fv, fam, mol, strand, valid, err)
    got = duplex_kernel(
        *(torch.from_numpy(a)[None] for a in (cb, cq, dep, fv, fam, mol, strand, valid, err)), **kw
    )
    assert len(got) == len(want)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(w))
    assert np.asarray(want[3]).sum() > 0
