"""segment_gemm (the torch port's ssc reduction) against the JAX package.

The port's plain version (the kernel's CPU path) is held against the
Pallas kernel in interpret mode and against ``jax.ops.segment_sum`` on
the same numpy inputs. Tolerance rtol 1e-5 / atol 1e-5: the three sum
the same f32 values in different orders. The CUDA kernel itself is
held against the plain version on the card in test_torch_cuda.py.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from duplexumiconsensusreads_tpu.kernels.pallas_ssc import segment_gemm as jax_segment_gemm
from duplexumiconsensusreads_torch.kernels import segment_gemm as sg

N_B, R, C, F = 3, 256, 70, 64


def _ids(kind: str, rng) -> np.ndarray:
    """(N_B, R) i32 ids of one layout the ssc passes produce."""
    if kind == "sorted":
        fid = np.sort(rng.integers(0, F, (N_B, R)), axis=1)
    elif kind == "unsorted":
        fid = rng.integers(0, F, (N_B, R))
    elif kind == "strided_duplex":
        # molecule*2 + strand: a unit's AB and BA reads interleave, ids
        # banded per position group but not contiguous runs
        mol = np.sort(rng.integers(0, F // 2, (N_B, R)), axis=1)
        fid = mol * 2 + rng.integers(0, 2, (N_B, R))
    elif kind == "dead":
        fid = rng.integers(0, F, (N_B, R))
        fid[rng.random((N_B, R)) < 0.3] = -1
    elif kind == "overflow":
        fid = rng.integers(0, F + 8, (N_B, R))  # ids >= f_max go nowhere
        fid[:, -5:] = F  # the callers' overflow id
    else:
        raise ValueError(kind)
    return fid.astype(np.int32)


KINDS = ("sorted", "unsorted", "strided_duplex", "dead", "overflow")


@pytest.fixture
def rng():
    return np.random.default_rng(11)


def _reference(big, fid):
    out = np.zeros((big.shape[0], F, big.shape[2]), np.float64)
    for b in range(big.shape[0]):
        for r in range(big.shape[1]):
            if 0 <= fid[b, r] < F:
                out[b, fid[b, r]] += big[b, r]
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_plain_matches_pallas_interpret_and_segment_sum(kind, rng):
    big = rng.standard_normal((N_B, R, C)).astype(np.float32)
    fid = _ids(kind, rng)
    got = sg.segment_gemm_plain(torch.from_numpy(big), torch.from_numpy(fid), F).numpy()
    assert got.shape == (N_B, F, C) and got.dtype == np.float32
    for b in range(N_B):
        pallas = np.asarray(jax_segment_gemm(big[b], fid[b], f_max=F, interpret=True))
        ids = np.where((fid[b] >= 0) & (fid[b] < F), fid[b], F)
        segsum = np.asarray(jax.ops.segment_sum(big[b], ids, num_segments=F + 1))[:F]
        np.testing.assert_allclose(got[b], pallas, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got[b], segsum, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, _reference(big, fid), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", KINDS)
def test_batched_equals_per_bucket_bitwise(kind, rng):
    big = torch.from_numpy(rng.standard_normal((N_B, R, C)).astype(np.float32))
    fid = torch.from_numpy(_ids(kind, rng))
    whole = sg.segment_gemm_plain(big, fid, F)
    for b in range(N_B):
        one = sg.segment_gemm_plain(big[b : b + 1], fid[b : b + 1], F)
        assert torch.equal(whole[b : b + 1], one)


def test_family_without_rows_is_exact_zero(rng):
    big = -rng.random((1, R, C)).astype(np.float32) - 0.5  # strictly negative
    fid = np.full((1, R), 3, np.int32)
    fid[0, ::2] = 9
    out = sg.segment_gemm(torch.from_numpy(big), torch.from_numpy(fid), F).numpy()
    empty = np.setdiff1d(np.arange(F), [3, 9])
    assert (out[0, empty] == 0.0).all() and not np.signbit(out[0, empty]).any()
    assert (out[0, [3, 9]] < 0).all()


def test_cpu_tensor_takes_plain_version_without_launch(rng):
    big = torch.from_numpy(rng.standard_normal((N_B, R, C)).astype(np.float32))
    fid = torch.from_numpy(_ids("unsorted", rng))
    before = sg.segment_gemm.launches
    out = sg.segment_gemm(big, fid, F)
    assert sg.segment_gemm.launches == before
    assert torch.equal(out, sg.segment_gemm_plain(big, fid, F))


@pytest.mark.parametrize(
    "big_dtype, fid_dtype, big_shape, fid_shape, err",
    [
        (torch.float64, torch.int32, (2, 8, 4), (2, 8), TypeError),
        (torch.float32, torch.int64, (2, 8, 4), (2, 8), TypeError),
        (torch.float32, torch.int32, (8, 4), (8,), ValueError),
        (torch.float32, torch.int32, (2, 8, 4), (2, 7), ValueError),
    ],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(
    big_dtype, fid_dtype, big_shape, fid_shape, err
):
    big = torch.zeros(big_shape, dtype=big_dtype)
    fid = torch.zeros(fid_shape, dtype=fid_dtype)
    with pytest.raises(err):
        sg.segment_gemm(big, fid, 4)
