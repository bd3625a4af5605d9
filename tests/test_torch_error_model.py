"""The torch port's per-cycle error model against the JAX package's.

fit_cycle_cap_kernel and apply_cycle_cap are integer tallies plus f32
multiply/compare against the shared threshold table: bit-identical.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from duplexumiconsensusreads_tpu.kernels.error_model import (
    apply_cycle_cap as jax_apply,
    fit_cycle_cap_kernel as jax_fit,
)
from duplexumiconsensusreads_torch.kernels.error_model import (
    apply_cycle_cap,
    fit_cycle_cap_kernel,
)
from duplexumiconsensusreads_torch.utils.phred import phred_cap_thresholds as port_thr
from duplexumiconsensusreads_tpu.utils.phred import phred_cap_thresholds as jax_thr


def _case(seed, n_b=3, r=200, l=40, f=64):
    rng = np.random.default_rng(seed)
    cons = rng.integers(0, 5, (n_b, f, l)).astype(np.int32)
    fid = rng.integers(-1, f, (n_b, r)).astype(np.int32)
    bases = np.take_along_axis(cons, np.maximum(fid, 0)[:, :, None], axis=1).astype(np.uint8)
    # per-cycle error rates rising along the read, plus N/PAD cycles
    flip = rng.random((n_b, r, l)) < np.linspace(0.001, 0.2, l)
    bases = np.where(flip, rng.integers(0, 6, (n_b, r, l)), bases).astype(np.uint8)
    valid = rng.random((n_b, r)) > 0.1
    fam_valid = rng.random((n_b, f)) > 0.2
    return bases, fid, valid, cons, fam_valid


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("max_phred_cap", [40, 60])
def test_fit_cycle_cap_bit_identical(seed, max_phred_cap):
    bases, fid, valid, cons, fam_valid = _case(seed)
    got = fit_cycle_cap_kernel(
        *(torch.from_numpy(a) for a in (bases, fid, valid, cons, fam_valid)),
        max_phred_cap=max_phred_cap,
    ).numpy()
    assert got.dtype == np.int32 and got.shape == (3, 40)
    for b in range(3):
        want = np.asarray(
            jax_fit(bases[b], fid[b], valid[b], cons[b], fam_valid[b], max_phred_cap=max_phred_cap)
        )
        np.testing.assert_array_equal(got[b], want)
    assert len(np.unique(got)) > 3  # the caps actually vary by cycle


def test_apply_cycle_cap_bit_identical():
    rng = np.random.default_rng(9)
    quals = rng.integers(0, 60, (2, 50, 30)).astype(np.uint8)
    cap = rng.integers(2, 45, (2, 30)).astype(np.int32)
    got = apply_cycle_cap(torch.from_numpy(quals), torch.from_numpy(cap)).numpy()
    assert got.dtype == np.uint8
    for b in range(2):
        np.testing.assert_array_equal(got[b], np.asarray(jax_apply(quals[b], cap[b])))


def test_threshold_table_identical():
    for cap in (40, 60, 93):
        assert port_thr(cap).tobytes() == jax_thr(cap).tobytes()
