"""The step clock (telemetry/steps.py) through the graph cache
(runtime/graphs.py).

On the CPU a stand-in capture backend takes the card's place, as in
tests/test_torch_graphs.py, and a stand-in event source takes the
card's timing events and stamp kernel: an event is stamped with a
counter when it is recorded, and a replay runs the stamps its capture
took in, each a tick of the same counter, into the class's buffer. So
the clock's own logic runs as on the card: the stage marks of an eager
step, the call records by mode, every replay stamped and the first
moved to the capture, replays per lane, a pair left unread while it has
not completed. The ``cuda`` tests run the same on the card; this file
imports neither jax nor the JAX package:

    python -m pytest --noconftest tests/test_torch_steps.py -q
"""

from __future__ import annotations

import threading

import pytest
import torch

from duplexumiconsensusreads_torch.bucketing import build_buckets, stack_buckets
from duplexumiconsensusreads_torch.interop import ARRAY_KEYS, stacked_from_numpy
from duplexumiconsensusreads_torch.kernels import build
from duplexumiconsensusreads_torch.ops import pipeline
from duplexumiconsensusreads_torch.runtime import executor as tx
from duplexumiconsensusreads_torch.runtime import graphs
from duplexumiconsensusreads_torch.simulate import SimConfig, simulate_batch
from duplexumiconsensusreads_torch.telemetry import steps
from duplexumiconsensusreads_torch.types import ConsensusParams, GroupingParams

DUPLEX = (GroupingParams(strategy="adjacency", paired=True),
          ConsensusParams(mode="duplex", error_model="cycle"))
SINGLE = (GroupingParams(strategy="exact"), ConsensusParams(mode="single_strand"))

DUPLEX_ORDER = ["decode", "group", "cluster", "group", "evidence", "reduce", "consensus_math",
                "cycle_cap", "evidence", "reduce", "consensus_math", "duplex_merge", "row_stats",
                "end"]
SINGLE_ORDER = ["decode", "group", "evidence", "reduce", "consensus_math", "row_stats", "end"]


class Ev:
    def __init__(self):
        self.t = None
        self.complete = False


class Events:
    """Timing events and stamp buffers stood in for: an event is stamped
    with a counter when it is recorded; a capture keeps the stamps its
    marks launch and a replay runs them, each a tick of the same counter,
    as the card's stamp kernel would. ``hold`` keeps the events recorded
    from then on incomplete until :meth:`finish` (or :meth:`sync`)."""

    def __init__(self):
        self.now = 0.0
        self.hold = False
        self.held: list = []
        self.tls = threading.local()
        self.syncs = 0

    def new(self):
        return Ev()

    def record(self, ev):
        self.now += 1.0
        ev.t, ev.complete = self.now, not self.hold
        if self.hold:
            self.held.append(ev)

    def done(self, ev):
        return ev.complete

    def seconds(self, a, b):
        assert a.complete and b.complete, "read before it completed"
        return b.t - a.t

    def buffer(self, device):
        assert getattr(self.tls, "capturing", None) is None, "a buffer made inside a capture"
        return torch.zeros(2 + steps.MAX_MARKS, dtype=torch.int64)

    def stamp(self, buf, k, last):
        launched = getattr(self.tls, "capturing", None)
        assert launched is not None, "a stamp outside a capture"
        launched.append((buf, k, last))

    def run(self, stamps):
        for buf, k, last in stamps:
            self.now += 1.0
            t = int(self.now * 1e9)
            if k:
                buf[1 + k] += t - buf[0]
            buf[0] = t
            if last:
                buf[1] += 1

    def sync(self, devices):
        self.syncs += 1
        self.finish()

    def fetch(self, bufs):
        return [b.tolist() for b in bufs]

    def finish(self):
        for ev in self.held:
            ev.complete = True
        self.held.clear()
        self.hold = False


class StandIn:
    """The card's capture and replay on the CPU (as test_torch_graphs.py
    stands them in), a replay also running the stamps its capture took
    in."""

    def __init__(self, events):
        self.events = events
        self.stream = 3

    def lane(self, device):
        return device.index, self.stream

    def current_stream(self, device):
        return None

    def new_pool(self, device):
        return object()

    def reserved(self, device):
        return 0

    def release(self, device):
        pass

    def mem_info(self, device):
        return 1 << 40, 1 << 40

    def capture(self, fn, lane):
        self.events.tls.capturing = stamps = []
        try:
            out = fn()
        finally:
            self.events.tls.capturing = None
        return (fn, out, stamps), out

    def replay(self, handle):
        fn, out, stamps = handle
        with build.tally_launches():
            new = fn()
        for k, v in new.items():
            out[k].copy_(v)
        self.events.run(stamps)

    def retire(self, lane):
        pass


@pytest.fixture
def clock():
    events = Events()
    graphs.use_backend(StandIn(events))
    steps.use_events(events)
    try:
        yield events
    finally:
        graphs.use_backend(None)
        steps.use_events(None)


def _class(params, seed=5, n_molecules=80, device="cpu"):
    gp, cp = params
    batch, _ = simulate_batch(SimConfig(n_molecules=n_molecules, read_len=30, n_positions=8,
                                        umi_error=0.02, duplex=gp.paired, seed=seed))
    buckets = build_buckets(batch, capacity=128, grouping=gp)
    (cb, spec), *_ = tx.partition_buckets(buckets, gp, cp, packed_io=True, device=device)
    st = stack_buckets(cb)
    pipeline.pack_stacked(st, spec)
    return st, spec, cb


def _run(st, spec, device="cpu"):
    out, mode = graphs.run_step(stacked_from_numpy(st, device), spec, ARRAY_KEYS)
    return {k: v.clone() for k, v in out.items()}, mode[0]


def _graph():
    """The one step graph of the one lane."""
    (lane,) = graphs._LANES.values()
    (g,) = lane.graphs.values()
    return g


def _entries(kind="step"):
    return {e["mode"]: e for e in steps.read()["calls"] if e["kind"] == kind}


def _same(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("params,order", [(DUPLEX, DUPLEX_ORDER), (SINGLE, SINGLE_ORDER)],
                         ids=["duplex_cycle", "single_strand"])
def test_an_eager_step_records_its_stages_in_order(clock, params, order):
    st, spec, _ = _class(params)
    _, mode = _run(st, spec)
    assert mode == "eager"
    e = _entries()["eager"]
    assert e["stages"] == order and e["samples"] == 1
    assert set(e["stage_s"]) == set(order[:-1])
    # each interval belongs to the mark that opens it; the fake clock
    # ticks once a record
    assert e["stage_s"]["group"] == (2.0 if "cluster" in order else 1.0)
    assert sum(e["stage_s"].values()) == e["marked_s"] == len(order) - 1
    assert e["marked_span_s"] == e["span_s"] == len(order) + 1


def test_calls_go_eager_captured_replayed_with_replays_counted_per_lane(clock):
    st, spec, _ = _class(DUPLEX)
    modes = [_run(st, spec)[1] for _ in range(4)]
    assert modes == ["eager", "captured", "replayed", "replayed"]
    by_mode = _entries()
    assert {m: (e["calls"], e["timed"], e["samples"]) for m, e in by_mode.items()} == {
        "eager": (1, 1, 1), "captured": (1, 1, 1), "replayed": (2, 2, 2)}
    for e in by_mode.values():
        assert e["stages"] == DUPLEX_ORDER
        assert e["class"] == f"duplex/cycle {st['pos'].shape[0]}x128x30"
        assert e["lane"] == "None:3"
    out = steps.read()
    assert out["replays"] == {"None:3": {"step": 2}} and out["pending"] == 0
    # another lane counts its own replays
    clock_backend = graphs._BACKEND
    clock_backend.stream = 4
    for _ in range(3):
        _run(st, spec)
    assert steps.read()["replays"] == {"None:3": {"step": 2}, "None:4": {"step": 1}}


def test_every_replay_is_stamped_and_the_first_goes_to_the_capture(clock):
    st, spec, _ = _class(DUPLEX)
    n = 5
    for _ in range(2 + n):
        _run(st, spec)
    g = _graph()
    # the capture took in one stamp a mark, the last one the step's end
    _, _, stamps = g.handle
    assert [(k, last) for _, k, last in stamps] == [
        (k, k == len(DUPLEX_ORDER) - 1) for k in range(len(DUPLEX_ORDER))]
    assert all(buf is g.stamps.acc for buf, _, _ in stamps)
    assert g.stamps.stages == tuple(DUPLEX_ORDER)
    assert int(g.stamps.acc[1]) == n and int(g.stamps.first[1]) == 1
    by_mode = _entries()
    rep, cap = by_mode["replayed"], by_mode["captured"]
    assert (rep["calls"], rep["timed"], rep["samples"]) == (n, n, n)
    # the fake clock ticks once a stamp: each interval one second
    assert rep["stage_s"]["group"] == pytest.approx(2.0 * n)
    assert rep["stage_s"]["evidence"] == pytest.approx(2.0 * n)
    assert rep["marked_s"] == pytest.approx((len(DUPLEX_ORDER) - 1) * n)
    assert rep["marked_span_s"] == rep["span_s"]
    assert cap["samples"] == 1 and cap["marked_s"] == pytest.approx(len(DUPLEX_ORDER) - 1)


def test_a_graph_captured_again_stamps_into_the_same_buffers(clock):
    st, spec, _ = _class(SINGLE)
    for _ in range(3):
        _run(st, spec)
    stamps = _graph().stamps
    (lane,) = graphs._LANES.values()
    lane.graphs.clear()  # as an eviction drops it
    modes = [_run(st, spec)[1] for _ in range(3)]
    assert modes == ["captured", "replayed", "replayed"]
    assert _graph().stamps is stamps and len(steps._STAMPS) == 1
    assert int(stamps.acc[1]) == 3 and int(stamps.first[1]) == 2
    by_mode = _entries()
    assert by_mode["replayed"]["samples"] == by_mode["replayed"]["calls"] == 3
    assert by_mode["captured"]["samples"] == by_mode["captured"]["calls"] == 2


def test_an_unfinished_pair_is_left_for_later_and_never_waited_on(clock):
    st, spec, _ = _class(SINGLE)
    for _ in range(3):
        _run(st, spec)
    (lane,) = steps._CLOCKS.values()
    rep = steps._TALLIES[next(k for k in steps._TALLIES if k[3] == "replayed")]
    clock.hold = True
    _run(st, spec)  # its events never complete while held
    assert (rep.calls, rep.timed) == (2, 1) and len(lane.pending) == 1
    _run(st, spec)  # the lane's next call reads nothing that is incomplete
    assert (rep.calls, rep.timed) == (3, 1) and len(lane.pending) == 2
    assert clock.syncs == 0
    # the read-out waits for the card once, then reads every call
    out = steps.read()
    assert clock.syncs == 1 and out["pending"] == 0
    e = _entries()["replayed"]
    assert (e["calls"], e["timed"], e["samples"]) == (3, 3, 3)


def test_mark_is_a_noop_outside_a_clocked_call():
    steps.mark("evidence")  # no call on this thread: nothing to record into
    assert getattr(steps._TLS, "call", None) is None
    st, spec, _ = _class(SINGLE)
    before = steps.read()
    _, mode = _run(st, spec)  # the CPU without an injected backend: no clock
    assert mode == "eager" and steps.read() == before


def test_a_thread_marks_only_its_own_call(clock, monkeypatch):
    st, spec, _ = _class(SINGLE)
    seen = []

    def other():
        steps.mark("evidence")
        seen.append(getattr(steps._TLS, "call", None))

    real = steps.mark

    def mark(stage):
        if stage == "reduce":
            t = threading.Thread(target=other)
            t.start()
            t.join()
        real(stage)

    monkeypatch.setattr(steps, "mark", mark)
    _run(st, spec)
    assert seen == [None]
    assert _entries()["eager"]["stages"] == SINGLE_ORDER


@pytest.mark.parametrize("params", [DUPLEX, SINGLE], ids=["duplex_cycle", "single_strand"])
def test_outputs_are_bit_identical_with_the_marks_patched_out(clock, params, monkeypatch):
    st, spec, _ = _class(params)
    marked = [_run(st, spec) for _ in range(3)]
    graphs.clear()
    monkeypatch.setattr(steps, "mark", lambda stage: None)
    plain = [_run(st, spec) for _ in range(3)]
    for (a, ma), (b, mb) in zip(marked, plain):
        assert ma == mb
        _same(a, b)


def test_the_epilogue_is_its_own_call_kind(clock):
    st, spec, cb = _class(DUPLEX)
    k_pad = tx.d2h_k_pad(cb, spec, 1)
    for _ in range(4):
        out, _ = graphs.run_step(stacked_from_numpy(st, "cpu"), spec, ARRAY_KEYS)
        tx.pack_fetch_outputs(out, spec, k_pad)
    epi = _entries("epilogue")
    assert {m: e["calls"] for m, e in epi.items()} == {"eager": 1, "captured": 1,
                                                        "replayed": 1}
    assert all(e["samples"] == 0 and e["stages"] == [] for e in epi.values())
    assert epi["replayed"]["class"] == _entries()["replayed"]["class"] + f" k_pad={k_pad}"
    assert steps.read()["replays"]["None:3"] == {"step": 2, "epilogue": 1}


def test_threads_on_shared_lanes_lose_no_call_and_share_no_event(clock, monkeypatch):
    """A stress of the clock's shared state: more threads than cores step
    four classes on three lanes, the interpreter switching threads every
    few microseconds. Every call is read once, with its stages, and no
    event is handed to two calls."""
    import sys

    _, spec, _ = _class(SINGLE)

    def step(*a):
        for stage in ("group", "evidence", "reduce", steps.END):
            steps.mark(stage)
        return {"n": a[0] * 2}

    monkeypatch.setattr(pipeline, "fused_pipeline", step)
    lanes = threading.local()
    backend = graphs._BACKEND
    monkeypatch.setattr(backend, "lane", lambda device: (device.index, lanes.n))
    n_threads, n_calls, shapes = 16, 25, (1, 2, 3, 4)
    errors = []

    def run(t):
        lanes.n = t % 3
        try:
            for i in range(n_calls):
                n = shapes[(t + i) % len(shapes)]
                args = {k: torch.full((n, 2), t, dtype=torch.int32) for k in ARRAY_KEYS}
                graphs.run_step(args, spec, ARRAY_KEYS)
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
    finally:
        sys.setswitchinterval(interval)
    assert not alive and not errors, errors
    out = steps.read()
    calls = out["calls"]
    assert sum(e["calls"] for e in calls) == sum(e["timed"] for e in calls) == n_threads * n_calls
    assert all(e["samples"] == e["calls"] for e in calls)
    assert all(e["stages"] == ["group", "evidence", "reduce", "end"] for e in calls)
    assert out["pending"] == 0
    assert sum(r["step"] for r in out["replays"].values()) == sum(
        e["calls"] for e in calls if e["mode"] == "replayed")
    for lane in steps._CLOCKS.values():
        assert len({id(ev) for ev in lane.pool}) == len(lane.pool)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the step clock times the card's streams")
    graphs.clear()
    steps.use_events(None)
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("params", [DUPLEX, SINGLE], ids=["duplex_cycle", "single_strand"])
def test_card_stage_seconds_sum_to_the_first_to_last_mark(cuda, params):
    st, spec, _ = _class(params, n_molecules=400, device=cuda)
    s = torch.cuda.Stream()
    with torch.cuda.stream(s):
        for _ in range(6):
            _run(st, spec, cuda)
    torch.cuda.synchronize()
    by_mode = _entries()
    assert set(by_mode) == {"eager", "captured", "replayed"}
    for e in by_mode.values():
        assert e["samples"] == e["calls"] == e["timed"], e
        total = sum(e["stage_s"].values())
        assert abs(total - e["marked_s"]) <= 2e-6 * len(e["stages"]) * e["samples"], e
        assert 0 < e["marked_s"] <= e["marked_span_s"] == pytest.approx(e["span_s"])
    order = DUPLEX_ORDER if params is DUPLEX else SINGLE_ORDER
    if spec.grouping.strategy == "exact" and "cluster" in order:
        order = order[:2] + order[4:]  # preclustered on the host: no cluster on the card
    assert by_mode["replayed"]["stages"] == by_mode["eager"]["stages"] == order


@pytest.mark.cuda
@pytest.mark.parametrize("params", [DUPLEX, SINGLE], ids=["duplex_cycle", "single_strand"])
def test_card_replays_are_bit_identical_with_and_without_marks(cuda, params, monkeypatch):
    st, spec, _ = _class(params, n_molecules=400, device=cuda)
    s = torch.cuda.Stream()
    with torch.cuda.stream(s):
        marked = [_run(st, spec, cuda) for _ in range(4)]
        graphs.clear()
        monkeypatch.setattr(steps, "mark", lambda stage: None)
        plain = [_run(st, spec, cuda) for _ in range(4)]
    torch.cuda.synchronize()
    for (a, ma), (b, mb) in zip(marked, plain):
        assert ma == mb
        _same(a, b)


@pytest.mark.cuda
def test_card_replays_enqueue_without_waiting_for_the_one_before(cuda):
    """Back-to-back replays of one stamped graph: the host enqueues them
    in far less time than the card takes to run them, so no launch
    waits for the replay before it."""
    import time

    st, spec, _ = _class(DUPLEX, n_molecules=400, device=cuda)
    args = stacked_from_numpy(st, cuda)
    s = torch.cuda.Stream()
    with torch.cuda.stream(s):
        for _ in range(3):
            graphs.run_step(args, spec, ARRAY_KEYS)
        s.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        n = 20
        t0 = time.perf_counter()
        a.record()
        for _ in range(n):
            graphs.run_step(args, spec, ARRAY_KEYS)
        b.record()
        host_s = time.perf_counter() - t0
    b.synchronize()
    device_s = a.elapsed_time(b) * 1e-3
    assert host_s < 0.5 * device_s, (host_s, device_s)
    rep = _entries()["replayed"]
    assert rep["samples"] == rep["calls"] == n + 1  # the warm-up's third call replayed
