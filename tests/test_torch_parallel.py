"""The torch port's mesh (parallel/mesh.py) and sharded pipeline
(parallel/sharded.py) on CPU lanes, against the JAX package's
tests/test_parallel.py.

- ``make_mesh`` raises in the JAX words, on a pool of the same size.
- ``sharded_pipeline`` on 8 data lanes equals one lane exactly.
- Cycle sharding at (4, 2), (2, 4) and (1, 8) on read_len 64 equals one
  lane byte for byte: the port splits the cycles by hand and joins the
  cross-cycle reductions on the host (parallel/sharded.py), which is
  exact; JAX holds its GSPMD form only to ``_assert_equivalent``'s
  tolerance (tests/test_parallel.py:45-60), which the port's result
  therefore meets too. The sub-byte H2D rung's bit planes split on
  byte boundaries and decode to the cycle slices.
- Two lanes against JAX's ``sharded_pipeline`` on its two virtual
  devices, at the parity bar (integers exact; bases and quals as
  tests/test_torch_cli.py:assert_parity allows: quals within one per
  strand, strand ties counted, ROADMAP Faults 1 and 4).
- ``call --devices 8 --cycle-shards 2`` through the CLI.
- The per-device packed D2H: each lane's compaction, joined on the
  host, is byte for byte the JAX package's one-device wire at two
  shards and its ``_pack_d2h_shmap`` wire on two devices.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from duplexumiconsensusreads_tpu.bucketing import build_buckets as jax_build_buckets
from duplexumiconsensusreads_tpu.bucketing import stack_buckets as jax_stack_buckets
from duplexumiconsensusreads_tpu.ops import spec_for_buckets as jax_spec_for_buckets
from duplexumiconsensusreads_tpu.parallel import make_mesh as jax_make_mesh
from duplexumiconsensusreads_tpu.parallel import sharded_pipeline as jax_sharded_pipeline
from duplexumiconsensusreads_tpu.runtime import executor as jax_executor
from duplexumiconsensusreads_tpu.simulate import SimConfig, simulate_batch
from duplexumiconsensusreads_tpu.types import ConsensusParams as JC
from duplexumiconsensusreads_tpu.types import GroupingParams as JG
from duplexumiconsensusreads_torch.bucketing import build_buckets, pad_buckets, stack_buckets
from duplexumiconsensusreads_torch.ops.pipeline import (
    _decode_packed,
    qual_alphabet,
    spec_for_buckets,
    subbyte_qbits_for,
)
from duplexumiconsensusreads_torch.parallel import (
    make_mesh,
    presharded_pipeline,
    put_lanes,
    sharded_pipeline,
    stage_lanes,
)
from duplexumiconsensusreads_torch.parallel.mesh import CPU_LANES, device_pool
from duplexumiconsensusreads_torch.parallel.sharded import (
    cycle_bounds,
    gather_outputs,
    lane_specs,
)
from duplexumiconsensusreads_torch.runtime import executor
from duplexumiconsensusreads_torch.types import ConsensusParams, GroupingParams

CPU = torch.device("cpu")
GP = GroupingParams(strategy="adjacency", paired=True)
CP = ConsensusParams(mode="duplex", error_model="cycle")


def _workload(read_len=64):
    """The JAX test's workload: 160 duplex molecules, 16 positions,
    capacity 256, config5; the same buckets for both packages."""
    cfg = SimConfig(n_molecules=160, read_len=read_len, n_positions=16, umi_error=0.02,
                    duplex=True, seed=77)
    batch, _ = simulate_batch(cfg)
    buckets = build_buckets(batch, capacity=256, adjacency=True)
    return cfg, batch, buckets, spec_for_buckets(buckets, GP, CP)


@pytest.fixture(scope="module")
def work():
    return _workload()


def _run(buckets, spec, mesh):
    return gather_outputs(sharded_pipeline(buckets, spec, mesh), mesh)


def _assert_identical(ref, out, n):
    assert set(ref) == set(out)
    for k in ref:
        assert np.asarray(ref[k])[:n].tobytes() == np.asarray(out[k])[:n].tobytes(), k


def _assert_equivalent(ref, out, n):
    """JAX's bar for a partitioned run (tests/test_parallel.py:45-60)."""
    for k in ("family_id", "molecule_id", "cons_base", "cons_depth", "cons_valid"):
        np.testing.assert_array_equal(ref[k][:n], out[k][:n], err_msg=k)
    q_ref, q_out = ref["cons_qual"][:n].astype(int), out["cons_qual"][:n].astype(int)
    diff = q_ref != q_out
    assert diff.mean() < 1e-4
    if diff.any():
        assert q_ref[diff].min() > 60 and q_out[diff].min() > 60


@pytest.mark.parametrize("n", [2, CPU_LANES])
def test_mesh_validation_in_the_jax_words(n):
    """Past the pool and not divisible: the JAX messages, word for word
    (the JAX side on its two virtual devices, the port on a pool of the
    same size; the port's CPU pool holds CPU_LANES lanes)."""
    pool = [CPU] * n
    with pytest.raises(ValueError, match="divisible") as ours:
        make_mesh(n, cycle_shards=n + 1, devices=pool)
    with pytest.raises(ValueError, match="requested") as past:
        make_mesh(n + 1, devices=pool)
    assert str(past.value) == f"requested {n + 1} devices, have {n}"
    assert str(ours.value) == f"n_devices {n} not divisible by cycle_shards {n + 1}"
    if n == len(jax.devices()):
        with pytest.raises(ValueError) as theirs:
            jax_make_mesh(n, cycle_shards=n + 1)
        assert str(theirs.value) == str(ours.value)
        with pytest.raises(ValueError) as theirs:
            jax_make_mesh(n + 1)
        assert str(theirs.value) == str(past.value)
    assert len(device_pool("cpu")) == CPU_LANES
    with pytest.raises(ValueError, match="indexed"):
        make_mesh(1, devices=[torch.device("cuda")])


def test_mesh_shape_and_lanes():
    m = make_mesh(8, cycle_shards=2, devices=[CPU] * 8)
    assert m.axis_names == ("data", "cycle")
    assert (m.n_data, m.n_cycle, m.size) == (4, 2, 8)
    assert m.devices == [CPU] * 8 and m.grid[3] == (CPU, CPU)
    one = make_mesh(3, devices=[CPU] * 8)
    assert one.axis_names == ("data",) and (one.n_data, one.n_cycle) == (3, 1)
    assert hash(one) == hash(make_mesh(3, devices=[CPU] * 8))


def test_data_sharding_matches_single_lane(work):
    _, _, buckets, spec = work
    ref = _run(buckets, spec, make_mesh(1, devices=[CPU]))
    out = _run(buckets, spec, make_mesh(8, devices=[CPU] * 8))
    _assert_identical(ref, out, len(buckets))


@pytest.mark.parametrize("shape", [(4, 2), (2, 4), (1, 8)])
def test_cycle_sharding_matches(work, shape):
    d, c = shape
    _, _, buckets, spec = work
    ref = _run(buckets, spec, make_mesh(1, devices=[CPU]))
    mesh = make_mesh(d * c, cycle_shards=c, devices=[CPU] * (d * c))
    assert mesh.axis_names == ("data", "cycle")
    out = _run(buckets, spec, mesh)
    _assert_identical(ref, out, len(buckets))
    _assert_equivalent(ref, out, len(buckets))


def test_cycle_bounds():
    assert cycle_bounds(64, 8) == [(i * 8, i * 8 + 8) for i in range(8)]
    assert cycle_bounds(150, 2) == [(0, 80), (80, 150)]
    assert cycle_bounds(36, 1) == [(0, 36)]
    with pytest.raises(ValueError, match="too short"):
        cycle_bounds(36, 8)


@pytest.mark.parametrize("rung", ["subbyte", "byte"])
def test_packed_cycle_lanes_decode_to_the_cycle_slices(rung):
    """The H2D rungs split by hand: each cycle lane's packed block
    decodes to exactly its cycles of the unpacked arrays."""
    _, _, buckets, _ = _workload(read_len=150)
    lut = qual_alphabet(buckets) if rung == "subbyte" else None
    qbits = subbyte_qbits_for(len(lut)) if lut else None
    assert (qbits is not None) == (rung == "subbyte")
    spec = spec_for_buckets(buckets, GP, CP, packed_io=True, packed_qbits=qbits, qual_lut=lut)
    plain = stack_buckets(buckets, multiple_of=2)
    mesh = make_mesh(4, cycle_shards=2, devices=[CPU] * 4)
    bounds = cycle_bounds(150, 2)
    for i, (blk, lspec) in enumerate(zip(stage_lanes(buckets, mesh, spec), lane_specs(spec, mesh))):
        d, (l0, l1) = divmod(i, 2)[0], bounds[i % 2]
        per = plain["pos"].shape[0] // 2
        t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in blk.items()}
        pos = t["pos"].view(torch.int16) if blk["pos"].dtype == np.uint16 else t["pos"]
        *_, valid, bases, quals = _decode_packed(pos, t["umi"], t["strand_ab"], t["bases"], lspec)
        sl = slice(d * per, (d + 1) * per)
        ok = plain["valid"][sl].astype(bool)[..., None] & (plain["bases"][sl, :, l0:l1] < 4)
        np.testing.assert_array_equal(bases.numpy()[ok], plain["bases"][sl, :, l0:l1][ok])
        np.testing.assert_array_equal(quals.numpy()[ok], plain["quals"][sl, :, l0:l1][ok])


def test_subbyte_cycle_mesh_pipeline_identical():
    """The sub-byte rung through presharded_pipeline on a cycle mesh:
    the lanes' specs carry their own cycle counts; the join is the
    one-lane output."""
    _, _, buckets, _ = _workload(read_len=150)
    lut = qual_alphabet(buckets)
    spec = spec_for_buckets(buckets, GP, CP, packed_io=True,
                            packed_qbits=subbyte_qbits_for(len(lut)), qual_lut=lut)
    ref = _run_packed(buckets, spec, make_mesh(1, devices=[CPU]))
    out = _run_packed(buckets, spec, make_mesh(4, cycle_shards=2, devices=[CPU] * 4))
    _assert_identical(ref, out, len(buckets))


def _run_packed(buckets, spec, mesh):
    args = put_lanes(stage_lanes(buckets, mesh, spec), mesh, spec)
    return gather_outputs(presharded_pipeline(args, spec, mesh), mesh)


def _jax_workload():
    cfg = SimConfig(n_molecules=160, read_len=64, n_positions=16, umi_error=0.02,
                    duplex=True, seed=77)
    batch, _ = simulate_batch(cfg)
    jb = jax_build_buckets(batch, capacity=256, adjacency=True)
    jgp, jcp = JG(**vars(GP)), JC(**dataclasses.asdict(CP))
    return jb, jax_spec_for_buckets(jb, jgp, jcp)


@pytest.mark.skipif(len(jax.devices()) < 2, reason="needs the suite's two JAX devices")
def test_two_lanes_match_jax_two_devices(work):
    """The port's two-lane sharded pipeline against JAX's on its
    two-device mesh, on the same buckets: ids, depths, validity and the
    molecule counts exact; bases equal but at strand ties; quals within
    one per strand (ROADMAP Faults 1, 4)."""
    _, _, buckets, spec = work
    jb, jspec = _jax_workload()
    jout = jax_sharded_pipeline(jax_stack_buckets(jb, multiple_of=2), jspec, jax_make_mesh(2))
    jout = {k: np.asarray(v) for k, v in jout.items()}
    out = _run(buckets, spec, make_mesh(2, devices=[CPU] * 2))
    n = len(buckets)
    for k in ("family_id", "molecule_id", "n_families", "n_molecules", "cons_valid",
              "cons_depth", "depth_max", "depth_min_pos", "cons_mate", "cons_pair"):
        np.testing.assert_array_equal(out[k][:n], jout[k][:n], err_msg=k)
    # the parity bar of tests/test_torch_cli.py:assert_parity: a strand
    # tie moves a duplex call's base, or its qual by up to 2 * 3 + 2
    same = out["cons_base"][:n] == jout["cons_base"][:n]
    dq = np.abs(out["cons_qual"][:n].astype(int) - jout["cons_qual"][:n].astype(int))
    tie = ~same | (dq > 2)
    assert (dq[same] <= 8).all()
    assert tie.sum() * 1000 <= tie.size


def test_cli_devices_and_cycle_shards(tmp_path):
    """``--devices 8 --cycle-shards 2`` (the JAX test's argv) on CPU
    lanes: records equal the one-lane call's."""
    from duplexumiconsensusreads_torch.cli.main import main
    from duplexumiconsensusreads_torch.io import read_bam, simulated_bam

    bam = str(tmp_path / "x.bam")
    simulated_bam(SimConfig(n_molecules=40, duplex=True, seed=6), path=bam)
    outs = {}
    for name, extra in (("mesh", ["--devices", "8", "--cycle-shards", "2"]), ("one", [])):
        outs[name] = str(tmp_path / f"{name}.bam")
        assert main(["call", bam, "-o", outs[name], "--config", "config3", "--capacity", "256",
                     "--device", "cpu", *extra]) == 0
    (_, a), (_, b) = read_bam(outs["mesh"]), read_bam(outs["one"])
    assert len(a) == len(b) > 0
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert (list(x) == list(y)) if isinstance(x, list) else np.array_equal(x, y), f.name


# ---- the per-device packed D2H (the counterpart of _pack_d2h_shmap)

@pytest.fixture(scope="module")
def packed_case(work):
    """Two-lane pipeline outputs of the config5 workload, the class's
    k_pad at two shards, and the one-device stacked outputs."""
    _, _, buckets, spec = work
    spec = dataclasses.replace(spec, consensus=ConsensusParams(mode="duplex"))
    mesh = make_mesh(2, devices=[CPU] * 2)
    lanes = sharded_pipeline(buckets, spec, mesh)
    whole = sharded_pipeline(pad_buckets(buckets, 2), spec, make_mesh(1, devices=[CPU]))[0]
    k_pad = executor.d2h_k_pad(buckets, spec, 2)
    return buckets, spec, mesh, lanes, whole, k_pad


def _jax_duplex_spec():
    return jax_spec_for_buckets(
        jax_build_buckets(_workload()[1], capacity=256, adjacency=True),
        JG(**vars(GP)), JC(mode="duplex"),
    )


def _joined_wire(packed_case):
    """The port's per-lane compaction of the two-lane outputs, joined
    on the host."""
    from duplexumiconsensusreads_torch.parallel.sharded import combine_lane_outputs

    _, spec, mesh, lanes, _, k_pad = packed_case
    per_lane = executor.pack_fetch_outputs(lanes, spec, k_pad, mesh=mesh)
    assert len(per_lane) == 2
    return combine_lane_outputs([{k: v.numpy() for k, v in p.items()} for p in per_lane], mesh)


def test_per_device_wire_equals_the_one_device_wire(packed_case):
    """The JAX package's one-device compaction at two shards (the
    shards compacted in turn on one device) sends the port's per-lane
    wire, byte for byte, and the host unpack restores the outputs."""
    buckets, spec, mesh, lanes, whole, k_pad = packed_case
    joined = _joined_wire(packed_case)
    one = jax_executor.pack_fetch_outputs(
        {k: jax.numpy.asarray(v.numpy()) for k, v in whole.items()}, _jax_duplex_spec(), k_pad, 2
    )
    assert set(joined) == set(one) == set(executor.PACKED_FETCH_KEYS)
    for k in one:
        t = np.asarray(one[k])
        assert joined[k].dtype == t.dtype and joined[k].shape == t.shape, k
        assert joined[k].tobytes() == t.tobytes(), k
    assert joined["cons_q"].shape[0] == 2 * k_pad
    # the host unpack restores the unpacked outputs from it
    full = executor.unpack_fetch_outputs(joined, buckets, spec, n_shards=2)
    ref = {k: v.numpy() for k, v in whole.items()}
    keep = ref["cons_valid"]
    for k in ("cons_base", "cons_qual"):
        np.testing.assert_array_equal(full[k][keep], ref[k][keep].astype(full[k].dtype))


@pytest.mark.skipif(len(jax.devices()) < 2, reason="needs the suite's two JAX devices")
def test_per_device_wire_equals_jax_shard_map_wire(packed_case):
    """The same outputs through JAX's per-shard compaction on its
    two-device mesh (``pack_fetch_outputs(..., mesh=mesh)``, the
    ``_pack_d2h_shmap`` form): the wire bytes are the port's."""
    _, _, _, _, whole, k_pad = packed_case
    jmesh = jax_make_mesh(2)
    sh = NamedSharding(jmesh, PartitionSpec("data"))
    jout = {k: jax.device_put(v.numpy(), sh) for k, v in whole.items()}
    theirs = jax_executor.pack_fetch_outputs(jout, _jax_duplex_spec(), k_pad, 2, mesh=jmesh)
    ours = _joined_wire(packed_case)
    assert set(ours) == set(theirs)
    for k in ours:
        t = np.asarray(theirs[k])
        assert ours[k].dtype == t.dtype and ours[k].shape == t.shape, k
        assert ours[k].tobytes() == t.tobytes(), k


def test_released_streams_are_reused_before_new_ones_are_made(monkeypatch):
    """A run hands its CUDA streams back and a later thread holding the
    same cuBLAS handle takes them: torch keeps a cuBLAS workspace per
    (handle, stream) pair for good, so new streams per run, or a stream
    paired with a new handle, would grow the card's memory run by run."""
    import types

    from duplexumiconsensusreads_torch.parallel import sharded

    monkeypatch.setattr(sharded, "_STREAM_POOL", {})
    made = []
    handle = [11]
    monkeypatch.setattr(sharded, "_pool_key", lambda d: (torch.device(d), handle[0]))
    monkeypatch.setattr(torch.cuda, "Stream", lambda d: made.append(d) or
                        types.SimpleNamespace(device=torch.device(d)))
    first = sharded._acquire_stream(torch.device("cuda", 0))
    assert len(made) == 1
    sharded.release_streams([first, None])
    assert sharded._acquire_stream(torch.device("cuda", 0)) is first
    assert len(made) == 1  # reused, not made anew
    sharded.release_streams([first])
    handle[0] = 12  # a thread with another handle gets a stream of its own
    other = sharded._acquire_stream(torch.device("cuda", 0))
    assert other is not first and len(made) == 2
    assert sharded._acquire_stream(torch.device("cuda", 1)) is not first and len(made) == 3
