"""Tests of the torch port that need an NVIDIA card (``cuda`` marker).

The hand-written CUDA kernels have no CPU mode, so these tests skip
without a card. This file imports neither jax nor the JAX package, so
it runs on a machine that has only PyTorch:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(``--noconftest``: the suite's conftest configures jax.)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from duplexumiconsensusreads_torch.kernels import segment_gemm as sg

N_B, R, C, F = 3, 256, 70, 64
KINDS = ("sorted", "unsorted", "strided_duplex", "dead", "overflow")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _ids(kind: str, rng) -> np.ndarray:
    if kind == "sorted":
        fid = np.sort(rng.integers(0, F, (N_B, R)), axis=1)
    elif kind == "unsorted":
        fid = rng.integers(0, F, (N_B, R))
    elif kind == "strided_duplex":
        fid = np.sort(rng.integers(0, F // 2, (N_B, R)), axis=1) * 2 + rng.integers(0, 2, (N_B, R))
    elif kind == "dead":
        fid = rng.integers(0, F, (N_B, R))
        fid[rng.random((N_B, R)) < 0.3] = -1
    else:  # overflow: ids >= f_max go nowhere
        fid = rng.integers(0, F + 8, (N_B, R))
        fid[:, -5:] = F
    return fid.astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_cuda_kernel_matches_plain_bitwise(kind, cuda):
    rng = np.random.default_rng(11)
    big = torch.from_numpy(rng.standard_normal((N_B, R, C)).astype(np.float32)).to(cuda)
    fid = torch.from_numpy(_ids(kind, rng)).to(cuda)
    before = sg.segment_gemm.launches
    got = sg.segment_gemm(big, fid, F)
    torch.cuda.synchronize()
    assert sg.segment_gemm.launches == before + 1
    # same f32 adds in the same (ascending row) order: bit-identical
    assert torch.equal(got, sg.segment_gemm_plain(big, fid, F))


@pytest.mark.cuda
def test_cuda_wrapper_raises_instead_of_falling_back(cuda):
    big = torch.zeros(2, 8, 6, device=cuda)
    fid = torch.zeros(2, 8, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        sg.segment_gemm(big.transpose(1, 2).contiguous().transpose(1, 2), fid, 4)
    with pytest.raises(ValueError):
        sg.segment_gemm(big, fid.cpu(), 4)


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["config1", "config5"])
def test_cuda_pipeline_matches_cpu(config, cuda):
    from duplexumiconsensusreads_torch.bucketing import build_buckets, stack_buckets
    from duplexumiconsensusreads_torch.cli.main import params_for
    from duplexumiconsensusreads_torch.interop import stacked_from_numpy
    from duplexumiconsensusreads_torch.ops.pipeline import fused_pipeline, pack_stacked
    from duplexumiconsensusreads_torch.runtime.executor import partition_buckets
    from duplexumiconsensusreads_torch.simulate import SimConfig, simulate_batch

    gp, cp, _ = params_for(config)
    duplex = cp.mode == "duplex"
    batch, _ = simulate_batch(SimConfig(n_molecules=100, read_len=32, n_positions=16,
                                        umi_error=0.02, duplex=duplex, seed=5))
    cbuckets, spec = max(partition_buckets(build_buckets(batch, capacity=128, grouping=gp),
                                           gp, cp, packed_io=True), key=lambda c: len(c[0]))
    st = pack_stacked(stack_buckets(cbuckets)) if spec.packed_io else stack_buckets(cbuckets)
    before = sg.segment_gemm.launches
    got = fused_pipeline(*stacked_from_numpy(st, cuda).values(), spec)
    torch.cuda.synchronize()
    assert sg.segment_gemm.launches > before
    want = fused_pipeline(*stacked_from_numpy(st, "cpu").values(),
                          dataclasses.replace(spec, ssc_method="segment"))
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key].cpu()
        if key == "cons_qual":
            # CUDA and CPU transcendentals differ by ULPs: one per strand
            assert (g.int() - w.int()).abs().max() <= (2 if duplex else 1)
        else:
            assert torch.equal(g, w), key
