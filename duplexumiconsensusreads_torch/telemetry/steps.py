"""The step clock: device-side spans the compiled step records itself,
on the lane's stream, by class, lane and stage.

On the card a step is a CUDA graph replay (runtime/graphs.py): no
Python runs inside it, and the profiler sees one launch and some 360
unnamed kernels. Only the program knows where each stage of the step
starts, and it knows it when the step runs eagerly or is captured.

- **Call spans.** Every ``run_step`` and ``run_epilogue`` call on the
  card is bracketed by a pair of timing events on the lane's stream,
  outside any capture: the pair spans the input copies into the
  graph's static inputs and the replay (or the eager step, or the
  capture and its first replay). The events come from a pool kept for
  each lane. A pair is read only once ``query()`` says its end has
  completed, at the lane's next call and at :func:`read`: the hot path
  never waits.
- **Stage marks.** :func:`mark` opens a stage at each stage boundary
  inside the fused step (``ops/pipeline.py``, ``kernels/grouping.py``,
  ``kernels/consensus.py``); the interval between two consecutive marks
  is the first one's stage, and the last mark is :data:`END`. Eagerly a
  mark is a timing event recorded on the lane's stream and read with
  the call's pair. Under capture it is a one-thread kernel
  (``csrc/step_clock.cu``) that reads the card's global timer and adds
  the interval it closes to a small device buffer, one for each
  (class, lane), so that every replay is timed and nothing is rebound
  or waited on at launch. The first replay, which the capturing call
  makes, is moved to a buffer of its own. The buffers are read only at
  :func:`read`. Outside a clocked call (the CPU, a step run outside the
  graph cache) a mark returns at one global check.

The clock is always on. Its cost on a replay is one event pair and one
``query`` on the host, and on the device one stamp kernel a mark (14
for a duplex step with the cycle model). :func:`read` gives the
tallies since the process started, and synchronizes the card first.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import threading

# the stages of the fused step, in the order they open
STAGES = ("decode", "group", "cluster", "evidence", "reduce", "consensus_math", "cycle_cap",
          "duplex_merge", "row_stats")
# the last mark: the step's end
END = "end"
# marks a captured step may hold (a duplex step with the cycle model
# has 14); the stamp buffer holds two more slots
MAX_MARKS = 32
# calls a lane keeps waiting to be read; past it the oldest is dropped
MAX_PENDING = 512

_LOCK = threading.Lock()
_TLS = threading.local()
# True once a call has been clocked: until then mark() returns at once
_ON = False
_EVENTS = None  # an injected event source (tests); None: the card's
_CLOCKS: dict = {}  # lane name -> _LaneClock
_TALLIES: dict = {}  # (kind, ident, lane, mode) -> _Tally
_REPLAYS: dict = {}  # lane name -> {kind: replayed calls}
_STAMPS: dict = {}  # (kind, ident, lane) -> _Stamps of its graphs


class CudaEvents:
    """Timing events on the card, and the stamp kernel of a captured
    step's marks."""

    _launch = None
    _ready: set = set()  # devices whose stamp kernel is loaded
    _lock = threading.Lock()

    def new(self):
        import torch

        return torch.cuda.Event(enable_timing=True)

    def record(self, ev) -> None:
        ev.record()

    def done(self, ev) -> bool:
        return ev.query()

    def seconds(self, a, b) -> float:
        return a.elapsed_time(b) * 1e-3

    def buffer(self, device):
        """A zeroed stamp buffer on ``device``, its stamp kernel loaded
        there (outside any capture: a capture may load no module)."""
        import torch

        from duplexumiconsensusreads_torch.kernels import build

        with self._lock:
            if CudaEvents._launch is None:
                lib = build.load("step_clock")
                fn = lib.step_stamp_launch
                fn.argtypes = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)
                fn.restype = ctypes.c_int
                lib.step_stamp_ready.restype = ctypes.c_int
                CudaEvents._launch = (fn, lib.step_stamp_ready)
            if device.index not in self._ready:
                with build.device_guard(device):
                    rc = self._launch[1]()
                if rc:
                    raise RuntimeError(f"step_stamp_ready failed ({rc})")
                self._ready.add(device.index)
        return torch.zeros(2 + MAX_MARKS, dtype=torch.int64, device=device)

    def stamp(self, buf, k: int, last: bool) -> None:
        """Mark ``k`` of a step (``last``: its end) into ``buf`` on the
        current stream."""
        import torch

        from duplexumiconsensusreads_torch.kernels import build

        with build.device_guard(buf.device):
            stream = torch.cuda.current_stream(buf.device).cuda_stream
            rc = self._launch[0](buf.data_ptr(), k, int(last), stream)
        if rc:
            raise RuntimeError(f"step_stamp_launch failed ({rc})")

    def sync(self, devices) -> None:
        """Wait until ``devices`` have finished what is queued."""
        import torch

        for device in devices:
            torch.cuda.synchronize(device)

    def fetch(self, bufs) -> list:
        """The buffers' values (after :meth:`sync`)."""
        return [b.tolist() for b in bufs]


def use_events(source) -> None:
    """Use ``source`` (an object with CudaEvents' methods) for every call,
    the CPU's included; None restores the card's. Forgets every tally,
    lane, pending call and stamp buffer."""
    global _EVENTS
    with _LOCK:
        _EVENTS = source
        _CLOCKS.clear()
        _TALLIES.clear()
        _REPLAYS.clear()
        _STAMPS.clear()


_CUDA = CudaEvents()


def _source(device):
    if _EVENTS is not None:
        return _EVENTS
    return _CUDA if device.type == "cuda" else None


class _Tally:
    """What the calls of one (kind, class, lane, mode) came to."""

    def __init__(self, key, label):
        self.key, self.label = key, label
        self.calls = self.timed = self.samples = 0
        self.span_s = self.marked_s = self.marked_span_s = 0.0
        self.stage_s: dict = {}
        self.order: tuple = ()


class _LaneClock:
    """One lane's event pool, and its calls in the order they ended,
    waiting for their events to complete."""

    def __init__(self, name, events, device):
        self.name, self.events, self.device = name, events, device
        self.pool: list = []
        self.pending: collections.deque = collections.deque()

    def take(self):
        return self.pool.pop() if self.pool else self.events.new()


class _Stamps:
    """The stamp buffers of one (kind, class, lane)'s step graphs: their
    replays' (``acc``) and their capturing calls' first replays'
    (``first``), and the graphs' stages in mark order. A graph captured
    again after an eviction stamps into the same buffers."""

    def __init__(self, events, acc, first):
        self.events, self.acc, self.first = events, acc, first
        self.stages: tuple = ()


class _Call:
    __slots__ = ("tally", "clock", "device", "start", "end", "stages", "marks", "stamps",
                 "capture")

    def __init__(self, tally, clock, device, start):
        self.tally, self.clock, self.device, self.start = tally, clock, device, start
        self.end = self.stamps = None
        self.stages: list = []
        self.marks: list = []
        self.capture = False


def lane_name(key: tuple) -> str:
    """A lane's (device index, stream) as read_counts() names it."""
    return f"{key[0]}:{key[1]}"


def class_label(spec, n: int, r: int, length: int) -> str:
    """A step class as a reader names it: consensus mode and error
    model, buckets x capacity x cycles (``duplex/cycle 280x2048x150``)."""
    c = spec.consensus
    return f"{c.mode}/{c.error_model or 'none'} {n}x{r}x{length}"


def begin(kind: str, ident, lane_key: tuple, device, mode: str, label):
    """Open a call of ``kind`` ("step" or "epilogue") on the lane
    ``lane_key`` (the current stream of ``device``): read the lane's
    completed calls, then record the span's first event. ``ident`` keys
    the class, ``label()`` names it. None where there is no clock (the
    CPU, unless a source is injected)."""
    global _ON
    events = _source(device)
    if events is None:
        return None
    name = lane_name(lane_key)
    with _LOCK:
        clock = _CLOCKS.get(name)
        if clock is None or clock.events is not events:
            clock = _CLOCKS[name] = _LaneClock(name, events, device)
        _harvest(clock)
        key = (kind, ident, name, mode)
        tally = _TALLIES.get(key)
        if tally is None:
            tally = _TALLIES[key] = _Tally(key, label())
        tally.calls += 1
        if mode == "replayed":
            per = _REPLAYS.setdefault(name, {})
            per[kind] = per.get(kind, 0) + 1
        start = clock.take()
        _ON = True
    events.record(start)
    return _Call(tally, clock, device, start)


def end(call) -> None:
    """Close ``call``: record the span's last event on the lane's stream
    and leave the call to be read once it completes."""
    if call is None:
        return
    clock = call.clock
    with _LOCK:
        call.end = clock.take()
    clock.events.record(call.end)
    with _LOCK:
        clock.pending.append(call)
        while len(clock.pending) > MAX_PENDING:
            clock.pending.popleft()


def capturing(call, fn):
    """``fn`` to be captured with the marks of a step going to ``call``:
    each one a stamp into the stamp buffers of the call's class and lane,
    made here, before the capture."""
    if call is None or call.tally.key[0] != "step":
        return fn
    key = call.tally.key[:3]
    with _LOCK:
        stamps = _STAMPS.get(key)
    if stamps is None:
        events = call.clock.events
        made = _Stamps(events, events.buffer(call.device), events.buffer(call.device))
        with _LOCK:
            stamps = _STAMPS.setdefault(key, made)
    captured = []

    def run():
        if captured:  # a stand-in backend's replay runs it again
            return fn()
        captured.append(True)
        call.stages, call.stamps = [], stamps
        with marking(call, capture=True):
            return fn()

    return run


@contextlib.contextmanager
def marking(call, capture: bool = False):
    """The marks of this thread go to ``call`` while entered: eagerly,
    or (``capture``) into the graph being captured."""
    if call is None:
        yield
        return
    call.capture = capture
    prev = getattr(_TLS, "call", None)
    _TLS.call = call
    try:
        yield
    finally:
        _TLS.call = prev


def mark(stage: str) -> None:
    """Open ``stage`` (one of STAGES, or END) on the current stream, in
    the clocked call this thread runs; nothing outside one."""
    if not _ON:
        return
    call = getattr(_TLS, "call", None)
    if call is None:
        return
    events = call.clock.events
    if call.capture:
        k = len(call.stages)
        if k >= MAX_MARKS:
            raise RuntimeError(f"a captured step holds at most {MAX_MARKS} stage marks")
        events.stamp(call.stamps.acc, k, stage == END)
        call.stages.append(stage)
        return
    with _LOCK:
        ev = call.clock.take()
    events.record(ev)
    call.stages.append(stage)
    call.marks.append(ev)


def adopt(call):
    """After ``call`` captured a graph: the stamp buffers its marks go
    to, now naming their stages; None for a graph without marks."""
    if call is None or call.stamps is None or not call.stages:
        return None
    call.stamps.stages = tuple(call.stages)
    return call.stamps


@contextlib.contextmanager
def first_replay(stamps):
    """While entered, the capturing call replays the graph with
    ``stamps`` once: that replay's stamps are moved from the replays'
    buffer to the first replays' (device copies on the current stream,
    which the replay is on)."""
    if stamps is None:
        yield
        return
    before = stamps.acc.clone()
    yield
    stamps.first.add_(stamps.acc).sub_(before)
    stamps.acc.copy_(before)


def _harvest(clock: _LaneClock) -> None:
    """Read the lane's calls that have completed, oldest first, up to the
    first that has not (the caller holds _LOCK)."""
    events = clock.events
    while clock.pending and events.done(clock.pending[0].end):
        call = clock.pending.popleft()
        t = call.tally
        span = events.seconds(call.start, call.end)
        t.timed += 1
        t.span_s += span
        marks = call.marks
        if len(marks) >= 2:
            stages = call.stages
            for i in range(len(marks) - 1):
                t.stage_s[stages[i]] = (t.stage_s.get(stages[i], 0.0)
                                        + events.seconds(marks[i], marks[i + 1]))
            t.samples += 1
            t.marked_s += events.seconds(marks[0], marks[-1])
            t.marked_span_s += span
            t.order = tuple(stages)
        clock.pool += (call.start, call.end, *marks)


def _stamped(row: dict, stages: tuple, acc: list) -> None:
    """Add a stamp buffer's replays to ``row``: their stages' seconds,
    and, since every replay is stamped, their call spans as the marked
    spans."""
    n = int(acc[1])
    if not n:
        return
    seconds = [ns * 1e-9 for ns in acc[2:1 + len(stages)]]
    for stage, s in zip(stages, seconds):
        row["stage_s"][stage] = row["stage_s"].get(stage, 0.0) + s
    row["samples"] += n
    row["marked_s"] += sum(seconds)
    row["marked_span_s"] = row["span_s"]
    row["stages"] = list(stages)


def read() -> dict:
    """The step clock since the process started, once the cards have
    finished what is queued and every call is read: ``calls``, one entry
    per (kind, class, lane, mode) with the calls made, the spans read
    (``timed``) and their seconds (``span_s``), the calls whose stages
    were read (``samples``: each eager call, each replay), each stage's
    seconds over them (``stage_s``), their first-to-last-mark seconds
    (``marked_s``) and span seconds (``marked_span_s``), and the stages
    in the order a call ran them; ``replays``, each lane's replayed
    calls by kind; ``pending``, the calls not yet complete."""
    with _LOCK:
        clocks = list(_CLOCKS.values())
        held = list(_STAMPS.items())
    values = {}
    for events in {id(c.events): c.events for c in clocks}.values():
        events.sync({c.device for c in clocks if c.events is events})
        mine = [(key, s) for key, s in held if s.events is events]
        got = events.fetch([b for _, s in mine for b in (s.acc, s.first)])
        for i, (key, s) in enumerate(mine):
            values[(*key, "replayed")] = (s.stages, got[2 * i])
            values[(*key, "captured")] = (s.stages, got[2 * i + 1])
    with _LOCK:
        for clock in _CLOCKS.values():
            _harvest(clock)
        calls = []
        for key, t in _TALLIES.items():
            row = {"kind": key[0], "class": t.label, "lane": key[2], "mode": key[3],
                   "calls": t.calls, "timed": t.timed, "span_s": t.span_s,
                   "samples": t.samples, "stage_s": dict(t.stage_s), "marked_s": t.marked_s,
                   "marked_span_s": t.marked_span_s, "stages": list(t.order)}
            if key in values:
                _stamped(row, *values[key])
            calls.append(row)
        return {"calls": calls, "replays": {k: dict(v) for k, v in _REPLAYS.items()},
                "pending": sum(len(c.pending) for c in _CLOCKS.values())}
