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


@pytest.mark.cuda
def test_cuda_stream_is_invariant_and_packs_like_the_cpu(cuda, tmp_path):
    from duplexumiconsensusreads_torch.cli.main import params_for
    from duplexumiconsensusreads_torch.io import simulated_bam
    from duplexumiconsensusreads_torch.runtime import executor
    from duplexumiconsensusreads_torch.runtime.stream import stream_call_consensus
    from duplexumiconsensusreads_torch.simulate import SimConfig

    gp, cp, _ = params_for("config5")
    path = str(tmp_path / "in.bam")
    simulated_bam(SimConfig(n_molecules=120, read_len=40, n_positions=8, umi_error=0.02,
                            duplex=True, paired_reads=True, seed=11), path=path, sort=True)
    outs = {}
    before = sg.segment_gemm.launches
    for name, knobs in (("auto", {}), ("off", dict(packed="off", d2h_packed="off",
                                                   drain_workers=1, ingest_overlap="off"))):
        out = str(tmp_path / f"{name}.bam")
        rep = stream_call_consensus(path, out, gp, cp, capacity=128, chunk_reads=150,
                                    device="cuda", **knobs)
        assert rep.n_chunks >= 3
        outs[name] = open(out, "rb").read()
    assert outs["auto"] == outs["off"]
    assert sg.segment_gemm.launches > before
    # the compaction on the card gives the CPU's wire bytes
    rng = np.random.default_rng(3)
    n_b, f, l = 4, 16, 40
    n_mol = torch.from_numpy(rng.integers(0, f + 1, n_b).astype(np.int32))
    out = {
        "n_families": n_mol * 2, "n_molecules": n_mol,
        "family_id": torch.from_numpy(rng.integers(-1, 2 * f, (n_b, 64)).astype(np.int32)),
        "molecule_id": torch.from_numpy(rng.integers(-1, f, (n_b, 64)).astype(np.int32)),
        "cons_valid": torch.from_numpy(rng.random((n_b, f)) < 0.8),
        "cons_base": torch.from_numpy(rng.integers(0, 5, (n_b, f, l)).astype(np.uint8)),
        "cons_qual": torch.from_numpy(rng.integers(2, 90, (n_b, f, l)).astype(np.uint8)),
        "cons_mate": torch.from_numpy(rng.integers(0, 2, (n_b, f)).astype(np.uint8)),
        "cons_end": torch.from_numpy(rng.integers(0, 2, (n_b, f)).astype(np.uint8)),
        "depth_max": torch.from_numpy(rng.integers(0, 300, (n_b, f)).astype(np.int32)),
        "depth_min_pos": torch.from_numpy(rng.integers(0, 300, (n_b, f)).astype(np.int32)),
        "cons_pair": torch.from_numpy(rng.integers(-1, 99, (n_b, f)).astype(np.int32)),
    }
    spec = type("S", (), {"consensus": cp})()
    k_pad = 64
    want = executor.fetch_outputs(executor.start_fetch(
        executor.pack_fetch_outputs(out, spec, k_pad), keys=executor.PACKED_FETCH_KEYS))
    got = executor.fetch_outputs(executor.start_fetch(
        executor.pack_fetch_outputs({k: v.to(cuda) for k, v in out.items()}, spec, k_pad),
        keys=executor.PACKED_FETCH_KEYS))
    for k in executor.PACKED_FETCH_KEYS:
        assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes(), k


@pytest.mark.cuda
def test_cuda_blockseg_is_identical_run_to_run(cuda):
    # blockseg adds a family's block partials in block order (no
    # order-dependent atomic adds): two runs give the same bytes, and
    # the integers equal the CPU run's
    from duplexumiconsensusreads_torch.kernels.consensus import ssc_kernel

    rng = np.random.default_rng(7)
    n_b, r, l = 6, 512, 40
    # families of up to 90 reads span three or more blocks of T=32
    fid = np.sort(rng.integers(0, 12, (n_b, r)), axis=1).astype(np.int32)
    bases = rng.integers(0, 5, (n_b, r, l)).astype(np.uint8)
    quals = rng.integers(2, 41, (n_b, r, l)).astype(np.uint8)
    valid = rng.random((n_b, r)) < 0.95
    args = [torch.from_numpy(x) for x in (bases, quals, fid, valid)]
    kw = dict(f_max=32, method="blockseg", blockseg_t=32, want_err=True)
    runs = [[o.cpu() for o in ssc_kernel(*(a.to(cuda) for a in args), **kw)] for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert a.numpy().tobytes() == b.numpy().tobytes()
    cpu = ssc_kernel(*args, **kw)
    for i, (g, w) in enumerate(zip(runs[0], cpu)):
        if i == 1:  # cons_qual: CUDA and CPU transcendentals differ by ULPs
            assert (g.int() - w.int()).abs().max() <= 1
        else:
            assert torch.equal(g, w), i


@pytest.mark.cuda
def test_cuda_kernel_runs_a_class_past_the_grid_z_limit(cuda):
    # a rung-32 class of more buckets than a CUDA grid's z extent runs
    # as consecutive launches, bit-identical to the plain version
    n_b, r, c, f = sg.MAX_GRID_Z + 4465, 32, 8, 16
    g = torch.Generator(device=cuda).manual_seed(3)
    big = torch.randn(n_b, r, c, device=cuda, generator=g)
    fid = torch.sort(torch.randint(-1, f + 1, (n_b, r), device=cuda, generator=g), 1).values
    fid = fid.to(torch.int32).contiguous()
    before = sg.segment_gemm.launches
    got = sg.segment_gemm(big, fid, f)
    torch.cuda.synchronize()
    assert sg.segment_gemm.launches == before + 2
    assert torch.equal(got, sg.segment_gemm_plain(big, fid, f))
