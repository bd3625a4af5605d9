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


# ---------------------------------------------------------------- row layout


def _cat_evidence(bases, quals, ok, want_err, want_depth):
    """The evidence block as torch.cat of its columns (its form before
    the padded buffer)."""
    from duplexumiconsensusreads_torch.kernels import consensus

    n, r, l = bases.shape
    contrib, real = consensus._contributions(bases, quals, ok, 50, 0)
    cols = [contrib.reshape(n, r, 4 * l)]
    if want_depth:
        cols.append(real)
    cols.append(ok.to(torch.float32)[..., None])
    if want_err:
        oh = ((bases[..., None] == torch.arange(4, dtype=bases.dtype)) & (real > 0)[..., None])
        cols.append(oh.to(torch.float32).reshape(n, r, 4 * l))
    return torch.cat(cols, dim=-1)


@pytest.mark.parametrize("mode", ["fit", "full", "err"])
@pytest.mark.parametrize("l", [150, 37])
def test_padded_evidence_view_equals_concatenated_columns(mode, l):
    from duplexumiconsensusreads_torch.kernels import consensus

    rng = np.random.default_rng(l)
    bases = torch.from_numpy(rng.integers(0, 6, (2, 40, l)).astype(np.uint8))
    quals = torch.from_numpy(rng.integers(0, 60, (2, 40, l)).astype(np.uint8))
    ok = torch.from_numpy(rng.random((2, 40)) < 0.8)
    want_err, want_depth = mode == "err", mode != "fit"
    got = consensus._evidence_columns(bases, quals, ok, 50, 0, want_err, want_depth)
    want = _cat_evidence(bases, quals, ok, want_err, want_depth)
    c = {"fit": 4 * l + 1, "full": 5 * l + 1, "err": 9 * l + 1}[mode]
    assert got.shape == want.shape == (2, 40, c)
    assert got.stride() == (40 * -(-c // 4) * 4, -(-c // 4) * 4, 1)
    # byte for byte: -0.0, and the NaN of an invalid read's qual-0
    # cycle (-inf * 0), come through as they are
    assert got.contiguous().numpy().tobytes() == want.numpy().tobytes()
    sg.check_kernel_layout(got)


@pytest.mark.parametrize("method", ["segment_gemm", "matmul", "segment", "blockseg", "runsum"])
def test_every_ssc_method_sums_the_view_as_its_contiguous_copy(method, rng):
    from duplexumiconsensusreads_torch.kernels import consensus

    big = sg.pad_rows(torch.from_numpy(rng.standard_normal((N_B, R, C + 1)).astype(np.float32)))
    assert not big.is_contiguous() and torch.equal(big, big.contiguous())
    fid = torch.from_numpy(np.sort(_ids("overflow", rng), axis=1).astype(np.int32))
    fid = torch.where(fid >= F, F, fid)
    got = consensus._reduce(big, fid, F, method, blockseg_t=32)
    want = consensus._reduce(big.contiguous(), fid, F, method, blockseg_t=32)
    assert got.numpy().tobytes() == want.numpy().tobytes()


def test_kernel_layout_check_raises_on_strides_it_does_not_take():
    ok = sg.padded_rows(2, 8, 751, "cpu")
    sg.check_kernel_layout(ok)
    sg.check_kernel_layout(torch.zeros(2, 8, 12))  # contiguous, C % 4 == 0
    buf = torch.zeros(2, 8, 752)
    bad = {
        "odd contiguous row stride": torch.zeros(2, 8, 751),
        "column stride": torch.zeros(2, 12, 8).transpose(1, 2),
        "16-byte start": buf[..., 1:],
        "storage ends inside the last chunk": torch.zeros(15 * 752 + 751)
        .as_strided((2, 8, 751), (8 * 752, 752, 1)),
    }
    for name, x in bad.items():
        with pytest.raises(ValueError):
            sg.check_kernel_layout(x)
            pytest.fail(name)


# (N, f_max, C) of every segment_gemm launch chip_smoke.py holds: the
# whole file, the per-base width, ladder rungs 2048/512/256 and the
# bench phase's 14 shapes, and beside them tail classes of 1-5 buckets
# at every f_max 8-2048
SMOKE_SHAPES = sorted(
    {(280, 1024, 751), (280, 1024, 1351), (224, 1024, 751), (62, 256, 751), (120, 128, 751),
     (1, 64, 601), (1, 256, 601), (1, 512, 601), (280, 1024, 601), (5, 2048, 601), (1, 8, 751),
     (1, 16, 751), (1, 64, 751), (5, 256, 751), (91, 512, 751), (5, 2048, 751), (1, 2048, 751),
     (49, 4096, 751)}
    | {(n, f, c) for n in range(1, 6) for f in (8, 16, 32, 64, 128, 256, 512, 1024, 2048)
       for c in (601, 751)}
)


@pytest.mark.parametrize("n, f_max, c", SMOKE_SHAPES)
def test_tile_chooser_never_shrinks_the_grid_and_fills_the_card(n, f_max, c):
    ct, ft = sg.choose_tiles(n, f_max, c)
    assert (ct, ft) in sg.TILES
    blocks = sg.grid_blocks(n, f_max, c, ct, ft)
    # the first kernel's grid: 128 columns x 64 families a block
    assert blocks >= -(-c // 128) * -(-f_max // 64) * n
    assert all(ct_ <= 128 and ft_ <= 64 for ct_, ft_ in sg.TILES)
    most = sg.grid_blocks(n, f_max, c, *sg.TILES[-1])
    assert blocks >= min(sg.MIN_BLOCKS, most)
    # and no smaller tile than that needs
    if (ct, ft) != sg.TILES[0]:
        prev = sg.TILES[sg.TILES.index((ct, ft)) - 1]
        assert sg.grid_blocks(n, f_max, c, *prev) < sg.MIN_BLOCKS
