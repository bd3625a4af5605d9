"""The streaming dispatch's host staging on the CPU.

- ``stack_buckets`` and ``pack_stacked`` writing into buffers the caller
  gives equal the JAX package's ``stack_buckets`` and ``pack_stacked``
  byte for byte, on the unpacked, byte and sub-byte (5- and 7-bit per
  cycle) rungs, with and without mesh pad buckets;
  ``parallel/sharded.py:stage_lanes`` (each lane's block written once
  into its staging buffers) equals the JAX stack and pack split into
  lane blocks, on one lane, four data lanes with pad buckets and a
  two-lane cycle mesh.
- A dispatch stages its class before it takes the class's stream slot
  and issues the H2D copies holding it (stand-in slot locks on the CPU,
  which has none), with bytes equal to a run without slots; a class of
  one bucket count meets one slot.
- Two threads' eager steps on one graph lane do not wait on each other
  (a stand-in capture backend, tests/test_torch_graphs.py's).

All comparisons are exact: these are integer layouts and output bytes.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

from duplexumiconsensusreads_tpu.bucketing import build_buckets as jax_build_buckets
from duplexumiconsensusreads_tpu.bucketing import stack_buckets as jax_stack
from duplexumiconsensusreads_tpu.ops.pipeline import pack_stacked as jax_pack_stacked
from duplexumiconsensusreads_tpu.runtime import executor as jx
from duplexumiconsensusreads_tpu.types import ConsensusParams as JC
from duplexumiconsensusreads_tpu.types import GroupingParams as JG
from duplexumiconsensusreads_torch.bucketing import STACKED_KEYS, build_buckets, stack_buckets
from duplexumiconsensusreads_torch.interop import ARRAY_KEYS
from duplexumiconsensusreads_torch.io import simulated_bam
from duplexumiconsensusreads_torch.ops import pipeline
from duplexumiconsensusreads_torch.parallel import sharded
from duplexumiconsensusreads_torch.parallel.mesh import make_mesh
from duplexumiconsensusreads_torch.runtime import graphs
from duplexumiconsensusreads_torch.runtime import stream as tstream
from duplexumiconsensusreads_torch.runtime import executor as tx
from duplexumiconsensusreads_torch.simulate import SimConfig, simulate_batch
from duplexumiconsensusreads_torch.types import ConsensusParams, GroupingParams

from test_torch_graphs import StandIn

GP = GroupingParams(strategy="adjacency", paired=True)
CP = ConsensusParams(mode="duplex")
CPU = torch.device("cpu")
# rung: (packed_io, simulated qual range); the sub-byte widths follow
# from the alphabet: 4 quals take 3 index bits (5 bits a cycle), 21 take
# 5 (7 bits a cycle)
RUNGS = {
    "off": (False, {}),
    "byte": (True, {}),
    "subbyte5": (True, dict(qual_lo=30, qual_hi=33)),
    "subbyte7": (True, dict(qual_lo=20, qual_hi=40)),
}
QBITS = {"off": None, "byte": None, "subbyte5": 3, "subbyte7": 5}


def _classes(rung: str, seed: int = 11):
    """The port's and the JAX package's classes of one seeded batch,
    read_len 150 (so a cycle mesh splits the cycles on byte bounds)."""
    packed_io, sim = RUNGS[rung]
    batch, _ = simulate_batch(SimConfig(n_molecules=120, read_len=150, n_positions=14,
                                        umi_error=0.02, duplex=True, seed=seed, **sim))
    buckets = build_buckets(batch, capacity=128, grouping=GP)
    jbuckets = jax_build_buckets(batch, capacity=128, grouping=JG(**vars(GP)))
    alpha = pipeline.qual_alphabet(buckets) if QBITS[rung] else None
    part = tx.partition_buckets(buckets, GP, CP, packed_io=packed_io, qual_alphabet=alpha,
                                device="cpu")
    jpart = jx.partition_buckets(jbuckets, JG(**vars(GP)), JC(**vars(CP)), packed_io=packed_io,
                                 qual_alphabet=alpha)
    assert len(part) == len(jpart)
    for (_, spec), (_, jspec) in zip(part, jpart):
        assert spec.packed_io == packed_io and spec.packed_qbits == QBITS[rung]
        assert (spec.packed_qbits, spec.qual_lut) == (jspec.packed_qbits, jspec.qual_lut)
    return part, jpart


def _jax_wire(jcb, jspec, multiple_of: int) -> dict:
    st = jax_stack(jcb, multiple_of=multiple_of)
    if jspec.packed_io:
        jax_pack_stacked(st, jspec)
    return {k: np.asarray(st[k]) for k in ARRAY_KEYS}


def _lane_split(wire: dict, mesh, spec) -> list[dict]:
    """The JAX wire as the lanes take it, in lane order: data lane d's
    contiguous bucket block, restricted to cycle lane c's cycles (the
    sub-byte rung's bit planes by whole bytes of cycles)."""
    per = wire["pos"].shape[0] // mesh.n_data
    out = []
    for d in range(mesh.n_data):
        block = {k: v[d * per : (d + 1) * per] for k, v in wire.items()}
        if mesh.n_cycle == 1:
            out.append(block)
            continue
        cycles = spec.cycles_len if spec.packed_qbits else block["bases"].shape[-1]
        for l0, l1 in sharded.cycle_bounds(cycles, mesh.n_cycle):
            part = dict(block)
            if spec.packed_qbits:
                b, r, w = block["bases"].shape
                planes = block["bases"].reshape(b, r, 2 + spec.packed_qbits, -1)
                part["bases"] = planes[..., l0 // 8 : -(-l1 // 8)].reshape(b, r, -1)
            else:
                part["bases"] = block["bases"][..., l0:l1]
            if block["quals"].shape[-1]:
                part["quals"] = block["quals"][..., l0:l1]
            out.append(part)
    return out


def _same_bytes(got: dict, want: dict, keys=ARRAY_KEYS):
    for k in keys:
        g = np.asarray(got[k])
        assert g.dtype == want[k].dtype and g.shape == want[k].shape, k
        assert g.tobytes() == want[k].tobytes(), k


def _filled(like: np.ndarray, byte: int) -> np.ndarray:
    a = np.empty_like(like)
    a.view(np.uint8)[...] = byte
    return a


@pytest.mark.parametrize("multiple_of", [1, 4])
@pytest.mark.parametrize("rung", sorted(RUNGS))
def test_stack_and_pack_into_given_buffers_equal_jax(rung, multiple_of):
    part, jpart = _classes(rung)
    for (cb, spec), (jcb, jspec) in zip(part, jpart):
        n = len(cb) + (-len(cb)) % multiple_of
        fresh = stack_buckets(cb, multiple_of=multiple_of)
        # buffers full of a byte no layout writes everywhere: a missed
        # element shows
        given = {k: _filled(fresh[k], 0xA5) for k in STACKED_KEYS}
        st = stack_buckets(cb, multiple_of=multiple_of, out=given)
        assert all(st[k] is given[k] for k in STACKED_KEYS)
        assert st["n_real_buckets"] == len(cb) and st["pos"].shape[0] == n
        jst = jax_stack(jcb, multiple_of=multiple_of)
        _same_bytes(st, {k: np.asarray(jst[k]) for k in STACKED_KEYS}, STACKED_KEYS)
        if not spec.packed_io:
            continue
        wire = pipeline.pack_stacked(stack_buckets(cb, multiple_of=multiple_of), spec)
        out = {k: _filled(wire[k], 0x5A) for k in ARRAY_KEYS}
        packed = pipeline.pack_stacked(st, spec, out=out)
        assert packed is st and all(packed[k] is out[k] for k in ARRAY_KEYS)
        _same_bytes(packed, _jax_wire(jcb, jspec, multiple_of))


MESHES = {
    "one_lane": dict(n=1),
    "four_data_lanes": dict(n=4),
    "two_cycle_lanes": dict(n=2, cycle_shards=2),
}


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("rung", sorted(RUNGS))
def test_stage_lanes_equals_the_jax_stack_split_over_the_lanes(rung, mesh_name):
    kw = dict(MESHES[mesh_name])
    mesh = make_mesh(kw.pop("n"), devices=[CPU] * 4, **kw)
    part, jpart = _classes(rung)
    padded = False
    for (cb, spec), (jcb, jspec) in zip(part, jpart):
        want = _lane_split(_jax_wire(jcb, jspec, mesh.n_data), mesh, spec)
        got = sharded.stage_lanes(cb, mesh, spec)
        assert len(got) == len(want) == mesh.size
        for g, w in zip(got, want):
            _same_bytes(g, {k: np.ascontiguousarray(v) for k, v in w.items()})
        padded |= len(cb) % mesh.n_data != 0
    assert padded == (mesh.n_data == 4)  # the data lanes' classes carry pad buckets


class SlotLock:
    """A stand-in for a slot's lock that knows which thread holds it."""

    def __init__(self):
        self.lock = threading.Lock()
        self.owner = None
        self.taken = 0

    def __enter__(self):
        self.lock.acquire()
        self.owner = threading.get_ident()
        self.taken += 1

    def __exit__(self, *exc):
        self.owner = None
        self.lock.release()


@pytest.fixture
def stream_input(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_staging")
    path = str(d / "in.bam")
    simulated_bam(SimConfig(n_molecules=70, n_positions=10, umi_error=0.02, seed=52),
                  path=path, sort=True)
    return path


@pytest.mark.parametrize("n_devices", [1, 2])
def test_dispatch_stages_before_it_takes_the_class_slot(monkeypatch, stream_input, tmp_path,
                                                        n_devices):
    # small buckets in large chunks: a class recurs chunk after chunk
    # with other bucket counts
    kw = dict(capacity=32, chunk_reads=100, device="cpu", n_devices=n_devices)
    ref = str(tmp_path / "ref.bam")
    tstream.stream_call_consensus(stream_input, ref, GP, CP, **kw)

    locks = [SlotLock() for _ in range(tx.XFER_WORKERS)]
    monkeypatch.setattr(tstream, "run_slots", lambda mesh, on_cuda: [
        (lock, [None] * mesh.size) for lock in locks])
    seen = {"stage": [], "put": []}

    def held():
        return any(lock.owner == threading.get_ident() for lock in locks)

    def recorded(name, fn):
        def call(*a, **k):
            seen[name].append(held())
            return fn(*a, **k)
        return call

    # which slot each dispatch took, by class (spec, capacity) and
    # bucket count
    taken = []
    stage = sharded.stage_lanes

    def staged(buckets, mesh, spec, **kw):
        out = stage(buckets, mesh, spec, **kw)
        taken.append(((spec, buckets[0].capacity), len(buckets), kw["streams"]))
        return out

    monkeypatch.setattr(sharded, "stage_lanes", recorded("stage", staged))
    monkeypatch.setattr(sharded, "put_lane", recorded("put", sharded.put_lane))
    tstream.reset_dispatch_stats()
    out = str(tmp_path / "slots.bam")
    rep = tstream.stream_call_consensus(stream_input, out, GP, CP, **kw)
    stats = tstream.dispatch_stats()
    assert rep.n_chunks >= 4
    # every class staged with no slot held, every lane's H2D under its slot
    assert seen["stage"] and not any(seen["stage"])
    assert len(seen["put"]) == n_devices * len(seen["stage"]) and all(seen["put"])
    assert sum(lock.taken for lock in locks) == stats["dispatches"] == len(seen["stage"])
    assert stats["lanes"] == n_devices * stats["dispatches"]
    assert stats["stage_s"] > 0 and stats["slot_held_s"] > 0
    # a class of one bucket count meets one slot, chunk after chunk
    # (its graphs replay there on the card); the class recurs
    slot_of = {}
    for cls, n, streams in taken:
        slot_of.setdefault((cls, n), set()).add(id(streams))
    assert all(len(v) == 1 for v in slot_of.values())
    assert len(slot_of) < len(taken)
    with open(ref, "rb") as f, open(out, "rb") as g:
        assert f.read() == g.read()


def test_eager_steps_on_one_lane_do_not_wait_on_each_other(monkeypatch):
    backend = StandIn()
    backend.stream = 3  # both threads on one lane
    graphs.use_backend(backend)
    graphs.reset_counts()
    barrier = threading.Barrier(2, timeout=30)

    def step(*args):
        # returns only once both threads are inside their eager steps
        barrier.wait()
        return {"n": args[0] + 0}

    monkeypatch.setattr(pipeline, "fused_pipeline", step)
    errors, modes = [], []

    def run(n):
        try:
            args = {k: torch.zeros((n, 4), dtype=torch.int32) for k in ARRAY_KEYS}
            modes.append(graphs.run_step(args, None, ARRAY_KEYS)[1][0])
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)

    try:
        threads = [threading.Thread(target=run, args=(n,)) for n in (1, 2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        counts = graphs.read_counts()
    finally:
        graphs.use_backend(None)
    assert not errors, errors
    assert modes == ["eager", "eager"] and counts["step"]["eager"] == 2


def test_threads_sharing_a_lane_see_each_class_eager_once_captured_once(monkeypatch):
    """A stress of the lane's lock: more threads than cores step four
    classes on one lane, the interpreter switching threads every few
    microseconds. Each class runs eagerly at its first sight and is
    captured at its second, once each, whichever thread sees it; every
    other step replays."""
    import sys

    backend = StandIn()
    backend.stream = 5
    graphs.use_backend(backend)
    graphs.reset_counts()
    monkeypatch.setattr(pipeline, "fused_pipeline", lambda *a: {"n": a[0] * 2})
    n_threads, n_calls, shapes = 16, 25, (1, 2, 3, 4)
    errors = []

    def run(t):
        try:
            for i in range(n_calls):
                n = shapes[(t + i) % len(shapes)]
                args = {k: torch.full((n, 2), t, dtype=torch.int32) for k in ARRAY_KEYS}
                graphs.run_step(args, None, ARRAY_KEYS)
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=run, args=(t,)) for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        alive = [t for t in threads if t.is_alive()]
        counts = graphs.read_counts()
    finally:
        sys.setswitchinterval(interval)
        graphs.use_backend(None)
    assert not alive and not errors, errors
    step = counts["step"]
    assert step["eager"] == step["captured"] == len(shapes) == counts["classes"]
    assert step["replayed"] == n_threads * n_calls - 2 * len(shapes)


def test_a_lane_running_an_eager_step_is_not_dropped_for_the_budget(monkeypatch):
    """An eager step runs outside its lane's lock, but its lane is not
    idle: a capture past the device budget on another lane drops the
    next least recent idle lane instead (the stand-in's lanes are its
    threads' names here)."""
    backend = StandIn()
    graphs.use_backend(backend)
    graphs.reset_counts()
    monkeypatch.setattr(graphs, "MAX_DEVICE_POOL_BYTES", 1200)
    backend.grow = 500  # each reservation read: a capture grows the pool 500 bytes
    inside, release = threading.Event(), threading.Event()

    def step(*a):
        if a[0].shape[0] == 9:  # the class the busy lane runs eagerly
            inside.set()
            assert release.wait(30)
        return {"n": a[0] * 2}

    monkeypatch.setattr(pipeline, "fused_pipeline", step)
    modes = []

    def on(lane, n, calls=1):
        def run():
            for _ in range(calls):
                args = {k: torch.zeros((n, 2), dtype=torch.int32) for k in ARRAY_KEYS}
                modes.append((lane, graphs.run_step(args, None, ARRAY_KEYS)[1][0]))
        t = threading.Thread(target=run, name=lane)
        t.start()
        return t

    try:
        for lane in ("21", "22"):
            on(lane, 1, calls=2).join(timeout=30)
        busy = on("21", 9)
        assert inside.wait(30)
        on("22", 1).join(timeout=30)  # lane 22 now more recent than lane 21
        on("23", 1, calls=2).join(timeout=30)
        lanes = {k[1] for k in graphs._LANES}
        dropped = graphs.read_counts()["lanes_dropped"]
    finally:
        release.set()
        busy.join(timeout=30)
        graphs.use_backend(None)
    assert not busy.is_alive()
    assert modes[:4] == [("21", "eager"), ("21", "captured"), ("22", "eager"),
                         ("22", "captured")]
    assert ("22", "replayed") in modes and ("21", "eager") in modes[4:]
    assert lanes == {"21", "23"} and dropped == 1
