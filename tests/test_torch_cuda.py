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
    # rows 16 bytes apart, as the kernel copies them (C = 70 is not)
    big = sg.pad_rows(torch.from_numpy(rng.standard_normal((N_B, R, C)).astype(np.float32)).to(cuda))
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
    # a row stride that is not a multiple of 4 floats
    with pytest.raises(ValueError):
        sg.segment_gemm(torch.zeros(2, 8, 7, device=cuda), fid, 4)


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


# ---------------------------------------------- segment_gemm: tiles and tails


@pytest.mark.cuda
@pytest.mark.parametrize("tile", ((128, 64),) + sg.TILES)
@pytest.mark.parametrize("kind", KINDS)
def test_cuda_kernel_matches_plain_at_every_tile(tile, kind, cuda, monkeypatch):
    rng = np.random.default_rng(5)
    big = sg.pad_rows(torch.from_numpy(rng.standard_normal((N_B, R, 151)).astype(np.float32))
                      .to(cuda))
    fid = torch.from_numpy(_ids(kind, rng)).to(cuda)
    monkeypatch.setattr(sg, "choose_tiles", lambda n, f, c: tile)
    got = sg.segment_gemm(big, fid, F)
    torch.cuda.synchronize()
    assert torch.equal(got, sg.segment_gemm_plain(big, fid, F))


@pytest.mark.cuda
@pytest.mark.parametrize("n_b, r, c, f_max", [(1, 2048, 751, 8), (2, 4096, 601, 16),
                                              (3, 2048, 751, 64), (5, 4096, 751, 2048),
                                              (2, 5000, 37, 8)])
def test_cuda_kernel_matches_plain_on_tail_classes(n_b, r, c, f_max, cuda):
    # a tail class: few buckets, few families at the head of each bucket,
    # the rest of the rows padding with the overflow id (and a bucket
    # taller than the kernel's id chunk, 4096 rows)
    rng = np.random.default_rng(r + f_max)
    live = rng.integers(1, r // 4, n_b)
    fid = np.full((n_b, r), f_max, np.int32)
    for b, k in enumerate(live):
        fid[b, :k] = np.sort(rng.integers(0, f_max, k))
    fid[0, -3:] = -1
    big = sg.pad_rows(torch.from_numpy(rng.standard_normal((n_b, r, c)).astype(np.float32))
                      .to(cuda))
    fid_t = torch.from_numpy(fid).to(cuda)
    got = sg.segment_gemm(big, fid_t, f_max)
    torch.cuda.synchronize()
    assert torch.equal(got, sg.segment_gemm_plain(big, fid_t, f_max))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_cuda_kernel_matches_plain_on_buckets_taller_than_an_id_chunk(kind, cuda):
    # 9000 rows: the kernel lists each 4096-row id chunk's rows of its
    # families in turn, and a family's sum runs on across chunks
    rng = np.random.default_rng(13)
    n_b, r, c = 2, 9000, 68
    fid = np.concatenate([_ids(kind, rng) for _ in range(-(-r // R) * 2)], axis=1)
    fid = np.ascontiguousarray(fid.reshape(-1)[: n_b * r].reshape(n_b, r))
    big = torch.from_numpy(rng.standard_normal((n_b, r, c)).astype(np.float32)).to(cuda)
    fid_t = torch.from_numpy(fid).to(cuda)
    got = sg.segment_gemm(big, fid_t, F)
    torch.cuda.synchronize()
    assert torch.equal(got, sg.segment_gemm_plain(big, fid_t, F))


# ----------------------------------------------------- the grouping fixpoint

I32_MAX = 2**31 - 1
FIXPOINT_KINDS = ("groups", "chain_up", "chain_down", "empty", "all_invalid", "dense",
                  "unsorted")


def fixpoint_case(kind: str, n: int, u: int, rng):
    """(edge, s0, u_pos) numpy for n buckets of u slots: position groups
    in ascending slot order (shuffled for "unsorted"), invalid slots at
    the tail, edges only within a group, s0 = rank * u + slot."""
    edge = np.zeros((n, u, u), bool)
    u_pos = np.full((n, u), I32_MAX, np.int32)
    rank = np.full((n, u), u, np.int64)
    for b in range(n):
        n_valid = 0 if kind == "all_invalid" else int(rng.integers(u // 2, u + 1))
        if kind in ("chain_up", "chain_down", "dense"):
            n_valid, sizes = u, [u]
        else:
            sizes = []
            while sum(sizes) < n_valid:
                sizes.append(int(min(rng.integers(1, 65), n_valid - sum(sizes))))
        pos = np.repeat(np.arange(len(sizes), dtype=np.int32) * 3, sizes)
        if kind == "unsorted":
            pos = rng.permutation(pos)
        u_pos[b, :n_valid] = pos
        rank[b, :n_valid] = rng.permutation(n_valid)
        same = u_pos[b, :, None] == u_pos[b, None, :]
        if kind in ("groups", "unsorted"):
            edge[b] = same & (rng.random((u, u)) < 0.05)
        elif kind == "dense":
            edge[b] = same
        elif kind in ("chain_up", "chain_down"):
            k = np.arange(u - 1)
            # the chain starts at its least key: slot 0 climbing, or the
            # last slot walking down one slot per ascending sweep
            if kind == "chain_up":
                edge[b, k, k + 1] = True
                rank[b] = np.arange(u)
            else:
                edge[b, k + 1, k] = True
                rank[b] = np.arange(u)[::-1]
        edge[b] &= ~np.eye(u, dtype=bool)
        edge[b] &= (u_pos[b] != I32_MAX)[:, None] & (u_pos[b] != I32_MAX)[None, :]
    s0 = (rank * u + np.arange(u)).astype(np.int32)
    return edge, s0, u_pos


@pytest.mark.cuda
@pytest.mark.parametrize("kind", FIXPOINT_KINDS)
@pytest.mark.parametrize("n, u", [(6, 64), (3, 256), (3, 1024), (2, 2048)])
def test_cuda_fixpoint_matches_plain(kind, n, u, cuda):
    # "dense" at u 1024 and 2048 has more in-group edges than the
    # kernel's list holds: it sweeps over the edge grid instead
    from duplexumiconsensusreads_torch.kernels import cluster_fixpoint as cf

    edge, s0, u_pos = (torch.from_numpy(a).to(cuda)
                       for a in fixpoint_case(kind, n, u, np.random.default_rng(u)))
    if kind == "dense" and u >= 1024:
        assert int(edge[0].sum()) > cf.default_list_cap(u)
    before = cf.propagate_min.launches
    got = cf.propagate_min(edge, s0, u_pos)
    torch.cuda.synchronize()
    assert cf.propagate_min.launches == before + 1
    want = cf.propagate_min_plain(edge, s0, u_pos)
    assert torch.equal(got, want)
    if kind == "chain_down":
        assert (got % u == u - 1).all()


@pytest.mark.cuda
@pytest.mark.parametrize("strategy", ["adjacency", "cluster"])
def test_cuda_group_kernel_matches_cpu_without_a_host_sync(strategy, cuda):
    from duplexumiconsensusreads_torch.bucketing import build_buckets, stack_buckets
    from duplexumiconsensusreads_torch.kernels import cluster_fixpoint as cf
    from duplexumiconsensusreads_torch.kernels.grouping import group_kernel
    from duplexumiconsensusreads_torch.simulate import SimConfig, simulate_batch
    from duplexumiconsensusreads_torch.types import GroupingParams

    batch, _ = simulate_batch(SimConfig(n_molecules=300, read_len=20, n_positions=12,
                                        umi_error=0.03, duplex=True, seed=9))
    gp = GroupingParams(strategy=strategy, paired=True)
    st = stack_buckets([b for b in build_buckets(batch, capacity=256, grouping=gp)
                        if b.capacity == 256 and not b.preclustered])
    args = [torch.from_numpy(np.ascontiguousarray(st[k]))
            for k in ("pos", "umi", "strand_ab", "frag_end", "valid")]
    kw = dict(strategy=strategy, paired=True, u_max=256, presorted=True,
              count_ratio=gp.effective_count_ratio)
    want = group_kernel(*args, **kw)
    dev_args = [a.to(cuda) for a in args]
    torch.cuda.synchronize()
    before = cf.propagate_min.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = group_kernel(*dev_args, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert cf.propagate_min.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
