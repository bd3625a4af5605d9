"""The port's graph cache (runtime/graphs.py) and pinned staging rings
(runtime/pinned.py) on the CPU.

On the card the fused step and the packed-D2H epilogue are captured as
CUDA graphs; here a stand-in backend takes the capture's place: its
capture runs the step once with the kernel launches going into the
capture's tally, and its replay runs the step again on the static
inputs with its launches discarded, writing into the captured outputs.
So the cache's own logic runs as on the card: first sight eager,
capture on the second sight, replays after; the launch counts a replay
adds; LRU eviction; the key separating two streams; a failed capture
raising. Replayed outputs are held bit for bit against the eager step
and, for the packed epilogue and the streaming call, against the JAX
package. The pinned rings are held with an unpinned allocator and
stand-in events. The card runs the same paths in chip_smoke.py's
``graphs`` phase.
"""

from __future__ import annotations

import json
import threading

import numpy as np
import pytest
import torch

import duplexumiconsensusreads_tpu.runtime.executor as jx
from duplexumiconsensusreads_tpu.io import read_bam as jax_read_bam
from duplexumiconsensusreads_tpu.io import simulated_bam
from duplexumiconsensusreads_tpu.runtime.stream import stream_call_consensus as jax_stream
from duplexumiconsensusreads_tpu.simulate import SimConfig
from duplexumiconsensusreads_tpu.types import ConsensusParams as JC
from duplexumiconsensusreads_tpu.types import GroupingParams as JG
from duplexumiconsensusreads_torch.bucketing import build_buckets, stack_buckets
from duplexumiconsensusreads_torch.interop import ARRAY_KEYS, host_shapes, stacked_from_numpy
from duplexumiconsensusreads_torch.io import read_bam
from duplexumiconsensusreads_torch.kernels import build
from duplexumiconsensusreads_torch.kernels import cluster_fixpoint as cf
from duplexumiconsensusreads_torch.kernels import segment_gemm as sg
from duplexumiconsensusreads_torch.ops import pipeline
from duplexumiconsensusreads_torch.parallel import sharded
from duplexumiconsensusreads_torch.parallel.mesh import make_mesh
from duplexumiconsensusreads_torch.runtime import executor as tx
from duplexumiconsensusreads_torch.runtime import graphs, pinned
from duplexumiconsensusreads_torch.runtime.executor import call_batch
from duplexumiconsensusreads_torch.runtime.stream import stream_call_consensus
from duplexumiconsensusreads_torch.simulate import simulate_batch
from duplexumiconsensusreads_torch.types import ConsensusParams, GroupingParams

from test_torch_stream import _compare

GP = GroupingParams(strategy="adjacency", paired=True)
CP = ConsensusParams(mode="duplex")
JAX_SIM = dict(n_molecules=70, n_positions=10, umi_error=0.02, seed=52)


class StandIn:
    """The card's capture and replay, stood in for on the CPU. A lane is
    (device index, stream): ``stream`` when set, else the calling
    thread's name (the streaming executor's threads each own a stream,
    and a run's threads take the streams an earlier run's handed back,
    as its pool's threads take their names)."""

    def __init__(self):
        self.stream = None
        self.captures = self.replays = self.retired = 0
        self.fail = False
        self.oom = 0  # captures left to run out of memory
        self.reserve = self.grow = 0  # the card's reservation, and its growth a call
        self.released = 0
        self.free, self.total = 1 << 40, 1 << 40  # the card's memory, every process's use

    def lane(self, device):
        return device.index, (threading.current_thread().name if self.stream is None
                               else self.stream)

    def current_stream(self, device):
        return None

    def new_pool(self, device):
        return object()

    def reserved(self, device):
        self.reserve += self.grow
        return self.reserve

    def release(self, device):
        self.released += 1

    def mem_info(self, device):
        return self.free, self.total

    def capture(self, fn, lane):
        if self.fail:
            raise RuntimeError("stream capture failed: operation not permitted")
        if self.oom:
            self.oom -= 1
            raise torch.OutOfMemoryError("CUDA out of memory")
        self.captures += 1
        out = fn()
        return (fn, out), out

    def replay(self, handle):
        fn, out = handle
        self.replays += 1
        with build.tally_launches():  # a replay launches from the device
            new = fn()
        for k, v in new.items():
            out[k].copy_(v)

    def retire(self, lane):
        self.retired += 1


@pytest.fixture
def stand_in():
    b = StandIn()
    graphs.use_backend(b)
    graphs.reset_counts()
    try:
        yield b
    finally:
        graphs.use_backend(None)


def _classes(seed=5, n_molecules=100, capacity=128, packed_io=True):
    batch, _ = simulate_batch(SimConfig(n_molecules=n_molecules, read_len=40, n_positions=12,
                                        umi_error=0.02, duplex=True, seed=seed))
    buckets = build_buckets(batch, capacity=capacity, grouping=GP)
    return tx.partition_buckets(buckets, GP, CP, packed_io=packed_io, device="cpu")


def _stacked(cbuckets, spec):
    st = stack_buckets(cbuckets)
    if spec.packed_io:
        pipeline.pack_stacked(st, spec)
    return st


def _eager(st, spec):
    args = stacked_from_numpy(st, "cpu")
    return {k: v.clone() for k, v in pipeline.fused_pipeline(*(args[k] for k in ARRAY_KEYS),
                                                              spec).items()}


def _step(st, spec):
    out, mode = graphs.run_step(stacked_from_numpy(st, "cpu"), spec, ARRAY_KEYS)
    return {k: v.clone() for k, v in out.items()}, mode[0]


def _key(spec, st):
    return spec, graphs.signature(host_shapes(st))


def _same(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert torch.equal(a[k], b[k]), k


def test_cpu_runs_eagerly_without_an_injected_backend():
    (cb, spec), *_ = _classes()
    st = _stacked(cb, spec)
    graphs.reset_counts()
    for _ in range(3):
        out, mode = graphs.run_step(stacked_from_numpy(st, "cpu"), spec, ARRAY_KEYS)
        assert mode == ("eager", 0.0) and not isinstance(out, graphs.GraphOutputs)
    assert graphs.read_counts()["step"]["eager"] == 0  # never reached the cache


@pytest.fixture
def counted(monkeypatch):
    """fused_pipeline launching two segment_gemm and one
    directional_cluster kernel per call on the lane's stream, as the
    card's step does per class."""
    real = pipeline.fused_pipeline

    def step(*a):
        for w in (sg.segment_gemm, sg.segment_gemm, cf.directional_cluster):
            build.count_launch(w, None, "s")
        return real(*a)

    monkeypatch.setattr(pipeline, "fused_pipeline", step)
    for w in (sg.segment_gemm, cf.directional_cluster):
        monkeypatch.setattr(w, "launches", 0)
        monkeypatch.setattr(w, "stream_launches", {})


def test_first_sight_eager_then_capture_then_replays_count_each_launch_once(stand_in, counted):
    (cb, spec), *_ = _classes()
    st = _stacked(cb, spec)
    stand_in.stream = 7
    modes = []
    for i in range(4):
        _, mode = _step(st, spec)
        modes.append(mode)
        # one call's launches each time: the capture's go to its tally,
        # the replay after it adds them once
        assert sg.segment_gemm.launches == 2 * (i + 1)
        assert cf.directional_cluster.launches == i + 1
    assert modes == ["eager", "captured", "replayed", "replayed"]
    assert stand_in.captures == 1 and stand_in.replays == 3
    # eager launches count on the wrapper's stream, replays on the lane's
    assert sg.segment_gemm.stream_launches == {(None, "s"): 2, (None, 7): 6}
    c = graphs.read_counts()["step"]
    assert (c["eager"], c["captured"], c["replayed"]) == (1, 1, 2)


def test_replays_equal_the_eager_step_bit_for_bit_with_new_inputs(stand_in):
    part = _classes()
    other = _classes(seed=6)
    (cb_a, spec_a), (cb_b, spec_b) = part[0], other[0]
    st_a, st_b = _stacked(cb_a, spec_a), _stacked(cb_b, spec_b)
    if _key(spec_a, st_a) != _key(spec_b, st_b):
        # the second input must share the first's class to reach its graph
        st_b = _stacked(cb_a[::-1], spec_a)
    assert _key(spec_a, st_b) == _key(spec_a, st_a)
    want_a, want_b = _eager(st_a, spec_a), _eager(st_b, spec_a)
    assert any(not torch.equal(want_a[k], want_b[k]) for k in want_a)
    got = [_step(st, spec_a) for st in (st_a, st_a, st_b, st_a, st_b)]
    assert [m for _, m in got] == ["eager", "captured", "replayed", "replayed", "replayed"]
    for (out, _), want in zip(got, (want_a, want_a, want_b, want_a, want_b)):
        _same(out, want)  # no stale static buffer between replays


def test_classes_interleaved_on_one_lane_and_one_class_on_two_streams(stand_in):
    (cb_a, spec_a), (cb_b, spec_b), *_ = _classes(n_molecules=300)
    st_a, st_b = _stacked(cb_a, spec_a), _stacked(cb_b, spec_b)
    want = {"a": _eager(st_a, spec_a), "b": _eager(st_b, spec_b)}
    stand_in.stream = 1
    seq = ["a", "b", "a", "b", "a", "b"]
    modes = []
    for name in seq:
        out, mode = _step(*((st_a, spec_a) if name == "a" else (st_b, spec_b)))
        _same(out, want[name])
        modes.append(mode)
    assert modes == ["eager", "eager", "captured", "captured", "replayed", "replayed"]
    # a second stream: its own first sight, its own static buffers
    stand_in.stream = 2
    assert _step(st_a, spec_a)[1] == "eager"
    assert _step(st_a, spec_a)[1] == "captured"
    lanes = graphs._LANES
    g1 = lanes[(None, 1)].graphs[_key(spec_a, st_a)]
    g2 = lanes[(None, 2)].graphs[_key(spec_a, st_a)]
    assert g1 is not g2
    assert all(g1.inputs[k] is not g2.inputs[k] for k in ARRAY_KEYS)
    assert all(g1.outputs[k].data_ptr() != g2.outputs[k].data_ptr() for k in g1.outputs
               if g1.outputs[k].numel())


def test_class_slot_is_kept_per_class_and_handed_out_in_turn(monkeypatch):
    """The streaming executor's slot of a dispatch class: fixed at its
    first sight, new classes in turn, forgotten least recent first."""
    from duplexumiconsensusreads_torch.runtime import stream

    monkeypatch.setattr(stream, "_SLOT_OF", stream.OrderedDict())
    monkeypatch.setattr(stream, "_SLOT_NEXT", stream.itertools.count())
    monkeypatch.setattr(stream, "MAX_SLOT_CLASSES", 3)
    (cb, spec), *_ = _classes()
    keys = [(spec, n, 128) for n in (243, 252, 255)]
    assert [stream.class_slot(k) % 4 for k in keys] == [0, 1, 2]
    assert [stream.class_slot(k) % 4 for k in keys[::-1]] == [2, 1, 0]
    assert stream.class_slot((spec, 256, 128)) % 4 == 3
    # the least recently met (255) was forgotten: met anew, a new ticket
    assert stream.class_slot(keys[0]) == 0
    assert stream.class_slot(keys[2]) == 4 and stream.class_slot(keys[2]) % 4 == 0


def test_class_slots_do_not_move_with_the_hash_seed(tmp_path):
    """Which classes share a slot is the same in every process, whatever
    PYTHONHASHSEED (a spec's hash changes with it)."""
    import os
    import subprocess
    import sys

    code = (
        "from duplexumiconsensusreads_torch.runtime import executor as tx, stream\n"
        "from test_torch_graphs import _classes\n"
        "keys = [(spec, len(cb), 128) for cb, spec in _classes(n_molecules=300)]\n"
        "keys += [(spec, n, 128) for _, spec in _classes()[:1] for n in (243, 252, 255)]\n"
        "print([stream.class_slot(k) % 4 for k in keys + keys[::-1]])\n"
    )
    here = os.path.dirname(os.path.abspath(__file__))
    got = []
    for seed in ("1", "2"):
        env = {**os.environ, "PYTHONHASHSEED": seed,
               "PYTHONPATH": os.pathsep.join([here, os.path.dirname(here)])}
        got.append(subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                                  capture_output=True, text=True, check=True).stdout)
    assert got[0] == got[1] and got[0].startswith("[0, 1, 2")


def test_classes_a_few_buckets_apart_take_graphs_of_their_own(stand_in, counted):
    """Graphs key on the exact bucket count: nothing is padded, and each
    class's replays launch what its eager step launched."""
    part = tx.partition_buckets(
        build_buckets(simulate_batch(SimConfig(n_molecules=400, read_len=40, n_positions=30,
                                               umi_error=0.02, duplex=True, seed=8))[0],
                      capacity=64, grouping=GP),
        GP, CP, packed_io=True, device="cpu")
    cb, spec = max(part, key=lambda p: len(p[0]))
    assert len(cb) >= 18
    st17, st18 = _stacked(cb[:17], spec), _stacked(cb[1:19], spec)
    assert _key(spec, st17) != _key(spec, st18)
    stand_in.stream = 41
    want = {17: _eager(st17, spec), 18: _eager(st18, spec)}
    got = [(n, *_step(st, spec)) for n, st in ((18, st18), (17, st17)) * 3]
    assert [m for *_, m in got] == ["eager"] * 2 + ["captured"] * 2 + ["replayed"] * 2
    for n, out, _ in got:
        assert out["family_id"].shape[0] == n
        _same(out, want[n])
    lane = graphs._LANES[(None, 41)]
    assert [g.inputs["pos"].shape[0] for g in lane.graphs.values()] == [18, 17]
    assert graphs.read_counts()["classes"] == 2
    assert sg.segment_gemm.launches == 2 * (len(want) + len(got))  # want's eager steps too


def test_lru_evicts_the_least_recent_graph_and_recaptures_it(stand_in, monkeypatch):
    monkeypatch.setattr(graphs, "MAX_GRAPHS", 2)
    part = _classes(n_molecules=400)
    assert len(part) >= 3
    classes = [(_stacked(cb, spec), spec) for cb, spec in part[:3]]
    stand_in.stream = 3
    for st, spec in classes:
        assert _step(st, spec)[1] == "eager"
    for st, spec in classes:
        assert _step(st, spec)[1] == "captured"
    lane = graphs._LANES[(None, 3)]
    keys = [_key(spec, st) for st, spec in classes]
    assert list(lane.graphs) == keys[1:]
    assert stand_in.retired == 1
    # the evicted class was seen before: it captures again, no eager run
    st0, spec0 = classes[0]
    out, mode = _step(st0, spec0)
    assert mode == "captured"
    _same(out, _eager(st0, spec0))
    assert list(lane.graphs) == [keys[2], keys[0]]


def test_a_capture_past_the_device_budget_drops_the_least_recent_idle_lane(stand_in,
                                                                          monkeypatch):
    monkeypatch.setattr(graphs, "MAX_DEVICE_POOL_BYTES", 1200)
    (cb, spec), *_ = _classes()
    st = _stacked(cb, spec)
    stand_in.grow = 500  # each reservation read: a capture grows the pool 500 bytes
    for lane in (21, 22):
        stand_in.stream = lane
        assert [_step(st, spec)[1] for _ in range(2)] == ["eager", "captured"]
    assert {k[1] for k in graphs._LANES} == {21, 22}
    assert graphs._LANES[(None, 21)].pool_bytes == 500
    # lane 21 is busy (its thread holds it): a capture past the budget
    # on lane 23 may not drop it, and drops the next least recent, 22
    busy = graphs._LANES[(None, 21)]
    busy.lock.acquire()
    try:
        stand_in.stream = 23
        retired = stand_in.retired
        assert [_step(st, spec)[1] for _ in range(2)] == ["eager", "captured"]
        assert stand_in.retired == retired + 1 and stand_in.released == 1
        assert {k[1] for k in graphs._LANES} == {21, 23}
        assert graphs.read_counts()["lanes_dropped"] == 1
    finally:
        busy.lock.release()
    # the dropped lane starts anew: its class is a first sight again
    stand_in.stream = 22
    assert _step(st, spec)[1] == "eager"


def test_a_card_short_of_free_memory_cuts_the_budget_to_what_a_lane_holds(stand_in):
    """Several processes share a card: a capture that leaves less than
    CARD_FREE_SHARE of it free drops this process's idle lanes, though
    its own pools are far inside MAX_DEVICE_POOL_BYTES."""
    (cb, spec), *_ = _classes()
    st = _stacked(cb, spec)
    stand_in.grow = 500
    for lane in (61, 62):
        stand_in.stream = lane
        assert [_step(st, spec)[1] for _ in range(2)] == ["eager", "captured"]
    assert {k[1] for k in graphs._LANES} == {61, 62}
    # the other processes leave a fifth of the card free, under the
    # quarter kept free: each trim drops the least recent idle lane (the
    # stand-in's card never gets the memory back, so each finds it short)
    stand_in.free, stand_in.total = 200, 1000
    stand_in.stream = 63
    assert [_step(st, spec)[1] for _ in range(2)] == ["eager", "captured"]
    assert {k[1] for k in graphs._LANES} == {63}
    c = graphs.read_counts()
    assert c["lanes_dropped"] == 2 and c["card_free_min"] == 0.2
    assert c["pool_peak_bytes"] == 1000  # two lanes of 500 before the card ran short


def test_a_capture_out_of_memory_makes_room_and_captures_once_more(stand_in):
    part = _classes(n_molecules=300)
    (cb_a, spec_a), (cb_b, spec_b) = part[0], part[1]
    st_a, st_b = _stacked(cb_a, spec_a), _stacked(cb_b, spec_b)
    stand_in.grow = 1
    stand_in.stream = 31
    for st, spec in ((st_a, spec_a), (st_a, spec_a), (st_b, spec_b)):
        _step(st, spec)
    stand_in.stream = 32
    _step(st_a, spec_a)
    stand_in.oom = 1
    out, mode = _step(st_a, spec_a)
    assert mode == "captured"
    _same(out, _eager(st_a, spec_a))
    assert (None, 31) not in graphs._LANES  # the idle lane went
    assert stand_in.released >= 1
    # out of memory twice: raised, never run eagerly
    stand_in.stream = 33
    _step(st_a, spec_a)
    stand_in.oom = 2
    with pytest.raises(torch.OutOfMemoryError):
        _step(st_a, spec_a)
    assert graphs.read_counts()["step"]["eager"] == 4


def test_a_failed_capture_raises_and_never_runs_eagerly(stand_in, counted):
    (cb, spec), *_ = _classes()
    st = _stacked(cb, spec)
    stand_in.stream = 4
    assert _step(st, spec)[1] == "eager"
    stand_in.fail = True
    before = sg.segment_gemm.launches
    with pytest.raises(RuntimeError, match="capture failed"):
        _step(st, spec)
    assert sg.segment_gemm.launches == before
    assert graphs.read_counts()["step"]["eager"] == 1
    stand_in.fail = False
    assert _step(st, spec)[1] == "captured"


def test_static_inputs_take_the_h2d_directly(stand_in):
    (cb, spec), *_ = _classes()
    st = _stacked(cb, spec)
    shapes = host_shapes(st)
    stand_in.stream = 5
    cpu = torch.device("cpu")
    assert graphs.bound_inputs(spec, shapes, ARRAY_KEYS, cpu) is None
    _step(st, spec)
    _step(st, spec)
    static = graphs.bound_inputs(spec, shapes, ARRAY_KEYS, cpu)
    assert static is not None
    args = stacked_from_numpy(st, "cpu", out=static)
    assert all(args[k] is static[k] for k in ARRAY_KEYS)
    out, mode = graphs.run_step(args, spec, ARRAY_KEYS)
    assert mode[0] == "replayed"
    _same({k: v.clone() for k, v in out.items()}, _eager(st, spec))
    # the mesh's H2D looks the graph up for each lane
    mesh = make_mesh(1, devices=[cpu])
    (lane_args,) = sharded.put_lanes(sharded.stage_lanes(cb, mesh, spec), mesh, spec)
    assert lane_args["pos"] is not static["pos"]  # the CPU stages nothing


def test_epilogue_graph_per_k_pad_equals_eager_and_the_jax_wire(stand_in):
    import jax.numpy as jnp

    (cb, spec), *_ = _classes()
    st = _stacked(cb, spec)
    stand_in.stream = 6
    duplex = spec.consensus.mode == "duplex"
    k_pad = tx.d2h_k_pad(cb, spec)
    eager = {k: v.clone() for k, v in tx._pack_d2h(_eager(st, spec), duplex, k_pad).items()}
    _step(st, spec)  # eager step: its epilogue runs eagerly
    out, _ = graphs.run_step(stacked_from_numpy(st, "cpu"), spec, ARRAY_KEYS)
    assert isinstance(out, graphs.GraphOutputs) and out.graph() is not None
    seen = []
    for kp in (k_pad, k_pad, k_pad, 2 * k_pad, 2 * k_pad, k_pad):
        graphs.reset_counts()
        packed = tx.pack_fetch_outputs(out, spec, kp)
        c = graphs.read_counts()["epilogue"]
        seen.append(next(m for m in graphs.MODES if c[m]))
        if kp == k_pad:
            _same({k: v.clone() for k, v in packed.items()}, eager)
    assert seen == ["eager", "captured", "replayed", "eager", "captured", "replayed"]
    assert len(out.graph().epilogues) == 2
    wire = tx.fetch_outputs(tx.start_fetch(tx.pack_fetch_outputs(out, spec, k_pad),
                                           keys=tx.PACKED_FETCH_KEYS))
    want = jx._pack_d2h_fn()({k: jnp.asarray(v.numpy()) for k, v in out.items()},
                             duplex, k_pad, 1)
    for k in tx.PACKED_FETCH_KEYS:
        assert wire[k].tobytes() == np.asarray(want[k]).tobytes(), k


def test_whole_file_call_replays_on_repeat_with_identical_outputs(stand_in):
    batch, _ = simulate_batch(SimConfig(n_molecules=150, read_len=40, n_positions=12,
                                        umi_error=0.02, duplex=True, seed=9))
    stand_in.stream = 8
    runs = []
    for _ in range(3):
        graphs.reset_counts()
        runs.append((call_batch(batch, GP, CP, capacity=128, device="cpu"),
                     graphs.read_counts()["step"]))
    n = runs[0][1]["eager"]
    assert n > 0
    assert [(c["eager"], c["captured"], c["replayed"]) for _, c in runs] == [
        (n, 0, 0), (0, n, 0), (0, 0, n)]
    for out, _ in runs[1:]:
        for a, b in zip(out, runs[0][0]):
            np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def stream_input(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_graphs")
    path = str(d / "in.bam")
    simulated_bam(SimConfig(**JAX_SIM), path=path, sort=True)
    return d, path


def test_stream_through_graphs_equals_eager_and_jax(stand_in, stream_input, tmp_path):
    d, path = stream_input
    kw = dict(capacity=128, chunk_reads=48)
    with graphs.disabled():
        eager = str(tmp_path / "eager.bam")
        stream_call_consensus(path, eager, GP, CP, device="cpu", **kw)
    outs, counts = [], []
    for i in range(2):
        out = str(tmp_path / f"graphs_{i}.bam")
        trace = str(tmp_path / f"graphs_{i}.jsonl")
        graphs.reset_counts()
        rep = stream_call_consensus(path, out, GP, CP, device="cpu", trace_path=trace, **kw)
        counts.append(graphs.read_counts())
        outs.append(out)
        assert rep.n_chunks >= 4
    with open(eager, "rb") as f:
        ref = f.read()
    for out in outs:
        with open(out, "rb") as f:
            assert f.read() == ref
    # the second run meets the first run's classes on its threads' lanes
    assert counts[1]["step"]["replayed"] + counts[1]["step"]["captured"] > 0
    with open(trace) as f:
        events = [r for r in map(json.loads, f) if r.get("name") == "jit_compile"]
    assert events and {e["mode"] for e in events} <= set(graphs.MODES)
    assert all(e["capture_s"] >= 0 for e in events)
    jout = str(d / "jax.bam")
    jax_stream(path, jout, JG(strategy="adjacency", paired=True), JC(mode="duplex"),
               n_devices=1, **kw)
    _compare(read_bam(outs[-1])[1], jax_read_bam(jout)[1], duplex=True)


class Event:
    def __init__(self, done=False):
        self.done = done

    def query(self):
        return self.done


@pytest.fixture
def ring(monkeypatch):
    monkeypatch.setattr(pinned, "_alloc", lambda shape, dtype: torch.empty(shape, dtype=dtype))
    pinned.clear()
    yield
    pinned.clear()


def test_pinned_ring_reuses_a_buffer_only_once_fenced_done_and_unreferenced(ring):
    lane = (0, 11)
    a = pinned.take((4, 3), torch.int32, lane, depth=2)
    ptr = a.data_ptr()
    ev = Event()
    pinned.fence([a], ev)
    view = a.numpy()[1:]
    del a
    b = pinned.take((4, 3), torch.int32, lane, depth=2)  # a's copies still run
    assert b.data_ptr() != ptr
    ev.done = True
    c = pinned.take((4, 3), torch.int32, lane, depth=2)  # a numpy view still reads it
    assert c.data_ptr() != ptr
    del view
    d = pinned.take((4, 3), torch.int32, lane, depth=2)
    assert d.data_ptr() == ptr and d.shape == (4, 3) and d.is_contiguous()
    # another lane or shape has a ring of its own
    assert pinned.take((4, 3), torch.int32, (0, 12)).data_ptr() != ptr
    assert pinned.stats()["reused"] == 1


def test_pinned_ring_drops_unfenced_buffers_and_keeps_at_most_depth(ring):
    lane = (0, 13)
    a = pinned.take((8,), torch.uint8, lane, depth=1)
    ptr = a.data_ptr()
    del a  # never fenced: a failed dispatch
    assert pinned.take((8,), torch.uint8, lane, depth=1).data_ptr() != ptr
    bufs = [pinned.take((8,), torch.uint8, lane, depth=1) for _ in range(3)]
    ev = Event(done=True)
    pinned.fence(bufs, ev)
    ptrs = {t.data_ptr() for t in bufs}
    del bufs
    got = [pinned.take((8,), torch.uint8, lane, depth=1) for _ in range(3)]
    assert sum(t.data_ptr() in ptrs for t in got) == 1  # a ring of depth 1
    assert pinned.stats()["dropped"] >= 3


def test_start_fetch_fences_its_buffers_and_the_h2d_staging(ring, monkeypatch):
    """On a CUDA tensor start_fetch takes its D2H targets from the
    lane's ring and fences them and the dispatch's H2D staging with its
    event; modelled here with a stand-in tensor type."""
    recorded = []

    class Ev:
        def record(self, stream):
            recorded.append(stream)

        def query(self):
            return True

    class Dev:
        is_cuda = True
        device = torch.device("cpu")

        def __init__(self, t):
            self.t, self.shape, self.dtype = t, t.shape, t.dtype

    monkeypatch.setattr(tx.torch.cuda, "Event", Ev)
    monkeypatch.setattr(tx.torch.cuda, "current_stream", lambda device=None: "lane")
    monkeypatch.setattr(pinned, "lane_of", lambda device: (0, "lane"))
    monkeypatch.setattr(torch.Tensor, "copy_", lambda self, v, non_blocking=False:
                        torch.Tensor.fill_(self, 0) if isinstance(v, Dev) else None)
    staging = [pinned.take((5,), torch.int32, (0, "lane"))]
    out = {"x": Dev(torch.arange(6, dtype=torch.int32))}
    sel = tx.start_fetch(out, keys=("x",), staging=staging, depth=3)
    assert recorded == ["lane"] and sel.staging is staging
    assert sel["x"]._dut_fence.event is sel.event
    assert staging[0]._dut_fence.event is sel.event


def test_pinned_rings_keep_at_most_max_free_bytes_dropping_the_first_freed(ring, monkeypatch):
    monkeypatch.setattr(pinned, "MAX_FREE_BYTES", 64)
    ev = Event(done=True)
    old = pinned.take((48,), torch.uint8, (0, 14), depth=4)  # another shape's ring
    new = pinned.take((32,), torch.uint8, (0, 14), depth=4)
    ptr_old, ptr_new = old.data_ptr(), new.data_ptr()
    pinned.fence([old, new], ev)
    del old
    pinned.take((8,), torch.uint8, (0, 14))  # recycles the first: 48 free bytes
    assert pinned.stats()["free_bytes"] == 48
    del new
    pinned.take((8,), torch.uint8, (0, 14))  # 80 > 64: the first freed goes
    assert pinned.stats()["free_bytes"] == 32
    assert pinned.take((32,), torch.uint8, (0, 14)).data_ptr() == ptr_new
    assert pinned.take((48,), torch.uint8, (0, 14)).data_ptr() != ptr_old
