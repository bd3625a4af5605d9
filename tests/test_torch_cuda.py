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

from chip_smoke import cluster_case, largest_tensor
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
    on = (big.device.index, torch.cuda.current_stream(big.device).cuda_stream)
    before_on = sg.segment_gemm.stream_launches.get(on, 0)
    got = sg.segment_gemm(big, fid, F)
    torch.cuda.synchronize()
    assert sg.segment_gemm.launches == before + 1
    assert sg.segment_gemm.stream_launches[on] == before_on + 1
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
def test_cuda_stream_runs_reuse_their_streams(cuda, tmp_path):
    """Each run hands its transfer streams back and the next run takes
    the same stream objects (torch keeps a cuBLAS workspace per (handle,
    stream) pair for good: new streams per run grew allocated memory by
    ~100 MB a run on an H100)."""
    from duplexumiconsensusreads_torch.cli.main import params_for
    from duplexumiconsensusreads_torch.io import simulated_bam
    from duplexumiconsensusreads_torch.parallel import sharded
    from duplexumiconsensusreads_torch.runtime.stream import stream_call_consensus
    from duplexumiconsensusreads_torch.simulate import SimConfig

    gp, cp, _ = params_for("config5")
    path = str(tmp_path / "in.bam")
    simulated_bam(SimConfig(n_molecules=120, read_len=40, n_positions=8, umi_error=0.02,
                            duplex=True, paired_reads=True, seed=11), path=path, sort=True)
    pooled = []
    for i in range(2):
        stream_call_consensus(path, str(tmp_path / f"o{i}.bam"), gp, cp, capacity=128,
                              chunk_reads=150, device="cuda")
        pooled.append({id(st) for free in sharded._STREAM_POOL.values() for st in free})
    assert pooled[0] and pooled[0] <= pooled[1]


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


# ------------------------------------------------- grouping's directional cluster

CLUSTER_CASES = [("groups", u, umi_len, h, r) for u in (8, 64, 512) for umi_len in (12, 18)
                 for h in (0, 1, 2) for r in (0, 2)] + [
    ("chain_up", 512, 12, 1, 1), ("chain_down", 512, 18, 1, 1), ("dense", 512, 12, 12, 0),
    ("dense", 2048, 12, 12, 0), ("unsorted", 512, 12, 1, 2), ("unsorted", 2048, 18, 2, 0),
    ("groups", 16384, 12, 1, 2), ("groups", 512, 36, 2, 2), ("groups", 512, 48, 3, 2),
    ("size31", 512, 12, 1, 2), ("size32", 512, 12, 1, 2), ("size33", 512, 12, 1, 2),
    ("size512", 512, 12, 1, 2), ("size512", 512, 12, 1, 0), ("reversed", 512, 12, 1, 2),
    ("reversed", 2048, 18, 2, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind, u, umi_len, max_hamming, count_ratio", CLUSTER_CASES)
def test_cuda_directional_cluster_matches_plain(kind, u, umi_len, max_hamming, count_ratio, cuda):
    # tolerance 0 on seed, mid_of_slot and n_mol; "dense" has more
    # in-group edges than the kernel's list holds (its sweeps read the
    # kept edge masks at u 512, run the edge test again at u 2048),
    # u 16384 reads its table from global memory; W 3 and 4 words; groups
    # of exactly 31, 32, 33 and 512 slots; "unsorted" and "reversed"
    # (words falling within a group) take the id pair passes
    from duplexumiconsensusreads_torch.kernels import cluster_fixpoint as cf

    n = 2 if u >= 2048 else 3
    words, pos, cnt = (torch.from_numpy(a).to(cuda) for a in
                       cluster_case(kind, n, u, umi_len, np.random.default_rng(u + umi_len))[1:])
    before = cf.directional_cluster.launches
    on = (pos.device.index, torch.cuda.current_stream(pos.device).cuda_stream)
    before_on = cf.directional_cluster.stream_launches.get(on, 0)
    got = cf.directional_cluster(words, pos, cnt, umi_len, max_hamming, count_ratio)
    torch.cuda.synchronize()
    assert cf.directional_cluster.launches == before + 1
    assert cf.directional_cluster.stream_launches[on] == before_on + 1
    want = cf.directional_cluster_plain(words, pos, cnt, umi_len, max_hamming, count_ratio)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if kind == "dense":
        edge, _ = cf.cluster_edges_plain(words, pos, cnt, umi_len, max_hamming, count_ratio)
        assert 2 * int(edge[0].sum()) > cf.cluster_plan(u, words.shape[-1])[1]
    if u == cf.MAX_U:
        assert not cf.cluster_plan(u, words.shape[-1])[0]


@pytest.mark.cuda
def test_cuda_concurrent_launches_of_two_table_sizes(cuda):
    # the streaming executor's transfer threads launch classes of other
    # table sizes at once: neither may find the kernel's shared-memory
    # limit lowered under what it asks (each launch used to set it to its
    # own size)
    import threading

    from duplexumiconsensusreads_torch.kernels import cluster_fixpoint as cf

    tabs = [tuple(torch.from_numpy(a).to(cuda) for a in
                  cluster_case("groups", n, u, 12, np.random.default_rng(u))[1:])
            for n, u in ((8, 512), (2, 2048))]
    wants = [cf.directional_cluster_plain(*t, 12, 1, 2) for t in tabs]
    errors = []

    def launch(t, want):
        try:
            stream = torch.cuda.Stream()
            with torch.cuda.stream(stream):
                for _ in range(200):
                    got = cf.directional_cluster(*t, 12, 1, 2)
                stream.synchronize()
            assert all(torch.equal(g, w) for g, w in zip(got, want))
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=launch, args=tw) for tw in zip(tabs, wants)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not errors, errors


@pytest.mark.cuda
def test_cuda_main_class_is_resident_in_one_wave(cuda):
    # 512 threads a block and the plan's shared memory leave four blocks
    # an SM at the main class's table: its 280 buckets in one wave
    from duplexumiconsensusreads_torch.kernels import cluster_fixpoint as cf

    per_sm = cf.cluster_blocks_per_sm(512, 1)
    assert per_sm == cf.BLOCKS_PER_SM
    assert per_sm * torch.cuda.get_device_properties(0).multi_processor_count >= 280


@pytest.mark.cuda
def test_cuda_directional_cluster_raises_instead_of_falling_back(cuda):
    from duplexumiconsensusreads_torch.kernels import cluster_fixpoint as cf

    words, pos, cnt = (torch.from_numpy(a).to(cuda) for a in
                       cluster_case("groups", 1, cf.MAX_U * 2, 12, np.random.default_rng(0))[1:])
    with pytest.raises(ValueError, match="u_max"):
        cf.directional_cluster(words, pos, cnt, 12, 1, 2)


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
    before = cf.directional_cluster.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = group_kernel(*dev_args, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    # one directional_cluster launch per dispatch class, and no (N, U, U)
    # tensor: no torch operation of the call creates one
    assert cf.directional_cluster.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    size, _ = largest_tensor(lambda: group_kernel(*dev_args, **kw))
    assert 0 < size < dev_args[0].shape[0] * 256 * 256


@pytest.mark.cuda
def test_cuda_mesh_lanes_give_the_one_lane_bytes(cuda, tmp_path):
    """The mesh path on the card: the stream at one lane and at two (two
    lanes of the visible cards, or two streams of cuda:0 on a one-card
    machine), with cycle lanes too, gives the same bytes, and both
    kernels launch on every lane's card."""
    from duplexumiconsensusreads_torch.cli.main import params_for
    from duplexumiconsensusreads_torch.io import simulated_bam
    from duplexumiconsensusreads_torch.kernels import cluster_fixpoint
    from duplexumiconsensusreads_torch.parallel import mesh
    from duplexumiconsensusreads_torch.runtime.stream import stream_call_consensus
    from duplexumiconsensusreads_torch.simulate import SimConfig

    gp, cp, _ = params_for("config5")
    path = str(tmp_path / "in.bam")
    simulated_bam(SimConfig(n_molecules=120, read_len=40, n_positions=8, umi_error=0.02,
                            duplex=True, seed=11), path=path, sort=True)
    inner = mesh.device_pool
    if torch.cuda.device_count() < 2:
        mesh.device_pool = lambda device="cuda", devices=None: [torch.device("cuda", 0)] * 2
    try:
        outs = {}
        for name, kw in (("one", dict(n_devices=1)), ("two", dict(n_devices=2)),
                         ("cycle", dict(n_devices=2, cycle_shards=2))):
            before = (sg.segment_gemm.launches, cluster_fixpoint.directional_cluster.launches)
            out = str(tmp_path / f"{name}.bam")
            rep = stream_call_consensus(path, out, gp, cp, capacity=128, chunk_reads=150,
                                        device="cuda", **kw)
            assert rep.n_devices == kw["n_devices"]
            assert sg.segment_gemm.launches > before[0]
            assert cluster_fixpoint.directional_cluster.launches > before[1]
            outs[name] = open(out, "rb").read()
    finally:
        mesh.device_pool = inner
    assert outs["one"] == outs["two"] == outs["cycle"]


@pytest.mark.cuda
def test_cuda_two_lane_stream_runs_keep_memory_flat(cuda, tmp_path, monkeypatch):
    """Over repeated two-lane stream runs (two cards, or two lanes of
    cuda:0) the cards' allocated memory stays flat once the first runs
    have paired the transfer workers' cuBLAS handles with the pooled
    lane streams (Faults 16: a workspace per new (handle, stream) pair
    grew it by tens of MB a run)."""
    from duplexumiconsensusreads_torch.cli.main import params_for
    from duplexumiconsensusreads_torch.io import simulated_bam
    from duplexumiconsensusreads_torch.parallel import mesh
    from duplexumiconsensusreads_torch.runtime.stream import stream_call_consensus
    from duplexumiconsensusreads_torch.simulate import SimConfig

    pool = ([torch.device("cuda", 0), torch.device("cuda", 1)] if torch.cuda.device_count() >= 2
            else [torch.device("cuda", 0)] * 2)
    gp, cp, _ = params_for("config5")
    path = str(tmp_path / "in.bam")
    simulated_bam(SimConfig(n_molecules=120, read_len=40, n_positions=8, umi_error=0.02,
                            duplex=True, paired_reads=True, seed=11), path=path, sort=True)
    monkeypatch.setattr(mesh, "device_pool", lambda device="cuda", devices=None: pool)
    allocated = []
    for i in range(6):
        stream_call_consensus(path, str(tmp_path / f"o{i}.bam"), gp, cp, capacity=128,
                              chunk_reads=150, device="cuda", n_devices=2)
        torch.cuda.synchronize()
        allocated.append(sum(torch.cuda.memory_allocated(d) for d in set(pool)))
    assert max(allocated[2:]) - min(allocated[2:]) < 32 << 20, allocated
