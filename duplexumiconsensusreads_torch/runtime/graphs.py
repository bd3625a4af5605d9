"""CUDA graphs of the fused step and of the packed-D2H epilogue: the
port's counterpart of the JAX package's compiled step.

The JAX package pays a step's host cost once per shape:
``fused_pipeline`` is ``jax.jit`` with a static spec
(duplexumiconsensusreads_tpu/ops/pipeline.py:381), the packed-D2H
epilogue is jitted per (duplex, k_pad, n_shards)
(duplexumiconsensusreads_tpu/runtime/executor.py:557), and a mesh's
program is one cached executable per (mesh, spec). The port runs
eagerly: one step is some 360 small operations issued from Python on
every dispatch. Here a class that recurs on a lane is one replay.

- **Key.** A lane is a (device, stream), the stream a step is queued
  on. Its graphs are keyed by the lane's spec and the signature of the
  step's inputs (each array's shape and dtype: the stacked N x R x L x B
  and the packed-io rung), as jit keys on static arguments and shapes.
  N is not padded: a graph runs exactly the buckets its class has, and
  its kernels run at the shapes the eager step gives them. Two streams
  never share a graph or its static buffers, so two dispatches of one
  class in flight on two streams cannot meet; the streaming executor
  sends a class to the same stream chunk after chunk
  (runtime/stream.py).
- **First sight eager, capture on the second.** A key's first sight on
  a lane runs eagerly, as JAX's first call compiles, so a class that
  never recurs (the whole-file executor's, each seen once per call)
  costs nothing extra. The second sight captures the step into a
  ``torch.cuda.CUDAGraph`` over static inputs and replays it; later
  sights put the inputs into the static ones (the H2D copies straight
  into them, :func:`bound_inputs`; other inputs are copied on the
  device) and replay. :func:`read_counts` gives the distinct classes
  met since :func:`reset_counts` beside the calls of each mode. A capture that fails raises: a class due for
  capture never runs eagerly instead.
- **Outputs.** A replay returns the graph's static outputs, the same
  memory at every replay. They hold
  until the next replay on the lane's stream, which the stream orders
  after every copy the caller queued on them (the packed epilogue, the
  D2H copies); a caller that keeps outputs past its next step on that
  stream clones them.
- **The epilogue** (the packed D2H's compaction,
  runtime/executor.py:_pack_d2h) is a graph of its own per step graph
  and (duplex, k_pad, n_shards). k_pad varies chunk to chunk, so it
  is not fused into the step's graph; its static inputs are the step
  graph's static outputs, so it copies nothing.
- **Memory.** The graphs of a lane share one private memory pool
  (``torch.cuda.graph_pool_handle``): they replay one after another on
  the lane's stream, so one graph's intermediates may lie where
  another's were. A lane keeps at most ``MAX_GRAPHS`` step graphs whose
  static inputs and outputs together take at most
  ``MAX_LANE_STATIC_BYTES`` (1.5 GiB), each step graph at most
  ``MAX_EPILOGUES`` epilogue graphs, least recently used out first: a
  run's classes (a few per whole-file call or stream chunk, most of
  them small) fit a lane without thrashing, and the main whole-file
  class (280 x 2048 x 150, config5) holds 0.23 GB of static inputs and
  outputs. Its pool is larger: on an H100 the
  lane that captured it held 8.05 GB (its step's intermediates, the
  1.72 GB (280, 2048, 751) f32 evidence block twice among them, at the
  caching allocator's rounding). So a process's lanes on one device
  hold at most ``MAX_DEVICE_POOL_BYTES`` (40 GiB, half of an 80 GB
  card: the main class's pool on each of the streaming executor's four
  slot lanes and on the whole-file lane) in their pools together,
  counted as each capture's growth of the card's reservation, and less
  when the card runs short: the
  budget is cut to what leaves ``CARD_FREE_SHARE`` (a quarter) of the
  card free, as ``torch.cuda.mem_get_info`` counts it, every process on
  the card included.
  So the serve daemons, shard workers and hosts that share a card
  each grow their pools only while the card keeps a quarter free,
  whatever their number. Before and after a capture the least recently
  used idle lanes of the device are dropped until the process's pools
  fit its budget, and their memory goes back to the card
  (``torch.cuda.empty_cache``). A capture that runs out of memory
  drops every idle lane and its own lane's other graphs and is tried
  once more. :func:`pool_bytes` reads what each lane's pool holds,
  :func:`read_counts` the most the process's pools held on one device
  after a capture (``pool_peak_bytes``) and the least free share of
  the card a capture left (``card_free_min``).
- **Launch accounting.** The kernel wrappers count a launch when they
  queue it (kernels/build.py:count_launch). Under capture the launches
  go into the capture's tally instead; each replay adds the tally on
  the replay's stream, so a run counts what it launched, as eagerly.
- **Lifetime.** The cache is the process's, as the JAX package's
  executable caches are: a serve daemon's jobs reuse its graphs.
- **Step clock.** Every call on the card is timed on the lane's stream
  by telemetry/steps.py: a pair of events around the input copies and
  the replay (or the eager step, or the capture and its first replay),
  keyed by (kind, class, lane, mode), and the stages of the step from
  the marks the fused step records, which a capture turns into stamp
  kernels that add each replay's stage times to a device buffer.

On the CPU the step runs eagerly and never reaches the cache, unless a
test injects a capture backend (:func:`use_backend`), which stands in
for the card's capture and replay.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import threading
import time
import weakref

import torch

from duplexumiconsensusreads_torch.kernels import build
from duplexumiconsensusreads_torch.telemetry import steps

# step graphs a lane keeps, the bytes of their static inputs and
# outputs, and epilogue graphs a step graph keeps
MAX_GRAPHS = 16
MAX_LANE_STATIC_BYTES = 3 << 29
MAX_EPILOGUES = 4
# the bytes the lanes' pools of one device may hold together: past it a
# capture drops the least recently used idle lanes of that device. Each
# slot lane of a streaming run keeps its classes' pool (7.5-8 GB for
# the main class on an H100), so at 20 GiB a run whose large classes
# met three slots dropped a lane every run and lost its replays
MAX_DEVICE_POOL_BYTES = 40 << 30
# the share of the card's memory that captures leave free for every
# process on it: past it a process's budget shrinks to what it holds
CARD_FREE_SHARE = 0.25
# keys whose sightings a lane remembers (a key forgotten is seen anew)
MAX_SEEN = 256
# distinct step classes read_counts() remembers since reset_counts()
MAX_CLASSES = 1 << 16
# how a call ran: as eager operations, captured (and replayed once), or
# replayed
MODES = ("eager", "captured", "replayed")
KINDS = ("step", "epilogue")

# turn graphs off for every lane (the CPU is eager regardless)
ENABLED = True
_BACKEND = None
_LOCK = threading.Lock()
_LANES: dict = {}
# the device's capture stream, and the lock that runs captures one at a
# time (CudaBackend.capture)
_SIDE: dict = {}
_CAPTURE_LOCK = threading.Lock()
_DROPPED = [0]  # lanes dropped to keep a device's pools in the budget
_LANE_WAIT = [0.0]  # seconds threads waited for a lane's lock
_COUNTS = {k: dict.fromkeys(MODES, 0) for k in KINDS}
_CAPTURE_S = {k: 0.0 for k in KINDS}
# the distinct (spec, input signature) step classes met, the most the
# process's pools held on one device after a capture, and the least
# free share of a card after one
_CLASSES: set = set()
_POOL_PEAK = [0]
_CARD_FREE_MIN = [1.0]


class GraphOutputs(dict):
    """A replayed step's outputs: the graph's static tensors. ``graph``
    is a weak reference to the step graph that owns them (its epilogues
    key on it; weak, so a dropped graph goes at once)."""

    graph = None


class _Graph:
    """One captured graph: the backend's handle, its static inputs and
    outputs, the kernel launches one replay makes, and (for a step
    graph) its epilogue graphs and their sightings."""

    def __init__(self, handle, inputs, outputs, tally, lane, stamps=None):
        self.handle, self.inputs, self.tally, self.lane = handle, inputs, tally, lane
        self.stamps = stamps  # the buffers its stage stamps write (telemetry/steps.py)
        self.label = None  # a step graph's class, as the step clock names it
        self.nbytes = sum(t.nbytes for d in (inputs, outputs) for t in d.values())
        self.outputs = GraphOutputs(outputs)
        self.outputs.graph = weakref.ref(self)
        self.epilogues: collections.OrderedDict = collections.OrderedDict()
        self.epilogue_seen: collections.OrderedDict = collections.OrderedDict()


class _Lane:
    """One (device, stream): its pool and the bytes the captures grew
    it by, its step graphs (LRU order), the sightings of its step keys,
    a lock held over its tables, a replay and a capture, and the eager
    steps running on it outside that lock (another thread's capture
    drops an idle lane only: its lock free and no eager step running)."""

    def __init__(self, key, device, stream, pool):
        self.key, self.device, self.stream, self.pool = key, device, stream, pool
        self.graphs: collections.OrderedDict = collections.OrderedDict()
        self.seen: collections.OrderedDict = collections.OrderedDict()
        self.pool_bytes = 0
        self.used = 0
        self.lock = threading.Lock()
        self.eager = 0


class CudaBackend:
    """Capture and replay on the card. Captures run one at a time in the
    process, on a high-priority side stream of the device that nothing
    else runs on, and a lane replays on its own stream. Never on the
    lane's stream: another thread that drops a pinned buffer the lane's
    copies used has PyTorch's host allocator record an event on that
    stream, and an event recorded while the stream captures becomes
    part of the capture (it breaks the capture and, queried later, every
    pinned allocation). Nor on a stream of the default priority:
    ``torch.cuda.Stream`` hands those out from a pool of 32 per device
    in turn, so a capture stream taken from it could be another lane's
    stream, whose replays would find it capturing. The default stream
    could not capture anyway."""

    def lane(self, device) -> tuple:
        return device.index, torch.cuda.current_stream(device).cuda_stream

    def current_stream(self, device):
        return torch.cuda.current_stream(device)

    def new_pool(self, device):
        return torch.cuda.graph_pool_handle()

    def reserved(self, device) -> int:
        return torch.cuda.memory_reserved(device)

    def mem_info(self, device) -> tuple:
        """(free, total) bytes of the card, every process's use counted."""
        return torch.cuda.mem_get_info(device)

    def release(self, device) -> None:
        # dropped pools hold their memory until the allocator's cache is
        # emptied; other processes on the card need it back
        with torch.cuda.device(device):
            torch.cuda.empty_cache()

    def capture(self, fn, lane: _Lane):
        cur = torch.cuda.current_stream(lane.device)
        with _CAPTURE_LOCK:
            cap = _SIDE.get(lane.device)
            if cap is None:
                cap = _SIDE[lane.device] = torch.cuda.Stream(lane.device, priority=-1)
            cap.wait_stream(cur)
            graph = torch.cuda.CUDAGraph()
            # a collection inside the capture could free pinned host
            # memory from this thread, whose CUDA calls the capture forbids
            collecting = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.stream(cap):
                    graph.capture_begin(pool=lane.pool, capture_error_mode="thread_local")
                    try:
                        out = fn()
                    except BaseException:
                        with contextlib.suppress(Exception):
                            graph.capture_end()
                        raise
                    graph.capture_end()
            finally:
                if collecting:
                    gc.enable()
            cur.wait_stream(cap)
        return graph, out

    def replay(self, handle) -> None:
        handle.replay()

    def retire(self, lane: _Lane) -> None:
        # graphs leave the cache only after every replay queued on the
        # lane's stream has run
        lane.stream.synchronize()


def use_backend(backend) -> None:
    """Use ``backend`` (an object with CudaBackend's methods) for every
    lane, the CPU's included; None restores the card's. Empties the
    cache."""
    global _BACKEND
    clear()
    _BACKEND = backend


@contextlib.contextmanager
def disabled():
    """Every step and epilogue eager while entered (process-wide)."""
    global ENABLED
    was, ENABLED = ENABLED, False
    try:
        yield
    finally:
        ENABLED = was


def _backend(device):
    if not ENABLED:
        return None
    if _BACKEND is not None:
        return _BACKEND
    return CudaBackend() if device.type == "cuda" else None


def clear() -> None:
    """Drop every lane's graphs, pools and sightings, once the cards
    they replay on have finished."""
    with _LOCK:
        lanes = list(_LANES.values())
        _LANES.clear()
    for dev in {lane.device for lane in lanes if lane.device.type == "cuda"}:
        torch.cuda.synchronize(dev)
    del lanes


def reset_counts() -> None:
    with _LOCK:
        for k in KINDS:
            _COUNTS[k] = dict.fromkeys(MODES, 0)
            _CAPTURE_S[k] = 0.0
        _DROPPED[0] = 0
        _LANE_WAIT[0] = 0.0
        _CLASSES.clear()
        _POOL_PEAK[0] = 0
        _CARD_FREE_MIN[0] = 1.0


def read_counts() -> dict:
    """{kind: {mode: calls}} since :func:`reset_counts`, with each kind's
    capture seconds, the distinct step classes met (``classes``), the
    pools' peak and the card's least free share after a capture, the
    seconds threads waited for a lane's lock (``lane_wait_s``), and the
    graphs each lane holds."""
    with _LOCK:
        out = {k: {**_COUNTS[k], "capture_s": round(_CAPTURE_S[k], 6)} for k in KINDS}
        out["lanes_dropped"] = _DROPPED[0]
        out["lane_wait_s"] = round(_LANE_WAIT[0], 6)
        out["classes"] = len(_CLASSES)
        out["pool_peak_bytes"] = _POOL_PEAK[0]
        out["card_free_min"] = round(_CARD_FREE_MIN[0], 4)
        out["lanes"] = {
            f"{key[0]}:{key[1]}": {"step_graphs": len(lane.graphs),
                                   "static_bytes": sum(g.nbytes for g in list(lane.graphs.values())),
                                   "epilogue_graphs": sum(len(g.epilogues)
                                                          for g in list(lane.graphs.values()))}
            for key, lane in _LANES.items()
        }
    return out


def static_bytes() -> int:
    """Device bytes the cache's graphs hold as static buffers: each step
    graph's inputs and outputs, each epilogue graph's outputs (its
    inputs are its step graph's outputs)."""
    with _LOCK:
        lanes = list(_LANES.values())
    total = 0
    for lane in lanes:
        for g in list(lane.graphs.values()):
            total += g.nbytes
            for e in list(g.epilogues.values()):
                total += sum(t.nbytes for t in e.outputs.values())
    return total


def pool_bytes() -> dict:
    """{"device:stream": bytes} of each lane's private pool on the card
    (the allocator's segments of that pool, in use or cached)."""
    with _LOCK:
        pools = {tuple(lane.pool): f"{key[0]}:{key[1]}" for key, lane in _LANES.items()
                 if lane.device.type == "cuda"}
    out = dict.fromkeys(pools.values(), 0)
    if not pools:
        return out
    for seg in torch.cuda.memory_snapshot():
        name = pools.get(tuple(seg.get("segment_pool_id", ())))
        if name is not None:
            out[name] += int(seg["total_size"])
    return out


def signature(shapes) -> tuple:
    """The part of a step graph's key its inputs give: each one's
    (shape, dtype)."""
    return tuple((tuple(shape), dtype) for shape, dtype in shapes)


def _lane(backend, device) -> _Lane:
    key = backend.lane(device)
    with _LOCK:
        lane = _LANES.get(key)
        if lane is None:
            lane = _LANES[key] = _Lane(key, device, backend.current_stream(device),
                                       backend.new_pool(device))
        global _TICK
        _TICK += 1
        lane.used = _TICK
    return lane


_TICK = 0


def _drop_lane(backend, lane: _Lane) -> None:
    """Forget a lane whose lock the caller holds, once its stream has
    finished: its graphs go, and its pool with the last of them and of
    their outputs; a later dispatch on its stream starts it anew."""
    backend.retire(lane)
    with _LOCK:
        if _LANES.get(lane.key) is lane:
            del _LANES[lane.key]
        _DROPPED[0] += 1
    lane.graphs.clear()
    lane.seen.clear()
    lane.pool_bytes = 0


def _budget(backend, device) -> int:
    """The pool bytes this process's lanes of ``device`` may hold:
    MAX_DEVICE_POOL_BYTES, cut to what they hold now plus what the card
    has free past CARD_FREE_SHARE of its memory (less than they hold
    when the card has less free)."""
    free, total = backend.mem_info(device)
    with _LOCK:
        held = sum(ln.pool_bytes for ln in _LANES.values() if ln.device == device)
    return min(MAX_DEVICE_POOL_BYTES, held + free - int(CARD_FREE_SHARE * total))


def _idle(lane: _Lane) -> bool:
    """Take the lane's lock if no thread holds it and no eager step runs
    on it (an eager step counts itself in holding the lock)."""
    if not lane.lock.acquire(blocking=False):
        return False
    if lane.eager:
        lane.lock.release()
        return False
    return True


def _eager_running(lane: _Lane, n: int) -> None:
    """Count (``n`` 1, holding the lane's lock) or uncount (-1) an eager
    step running on the lane outside its lock."""
    with _LOCK:
        lane.eager += n


def _trim_device(backend, keep: _Lane, budget: int) -> None:
    """Drop the least recently used idle lanes of ``keep``'s device
    (never ``keep``) while their pools hold more than ``budget``
    together; then give the dropped pools' memory back to the card."""
    dropped = False
    while True:
        with _LOCK:
            lanes = [ln for ln in _LANES.values() if ln.device == keep.device]
            over = sum(ln.pool_bytes for ln in lanes) > budget
            victims = sorted((ln for ln in lanes if ln is not keep and ln.pool_bytes),
                             key=lambda ln: ln.used)
        victim = next((v for v in victims if _idle(v)), None) if over else None
        if victim is None:
            break
        try:
            _drop_lane(backend, victim)
            dropped = True
        finally:
            victim.lock.release()
    if dropped:
        backend.release(keep.device)


@contextlib.contextmanager
def _holding(lane: _Lane):
    """Hold the lane's lock, counting the time spent waiting for it."""
    if not lane.lock.acquire(blocking=False):
        t0 = time.perf_counter()
        lane.lock.acquire()
        with _LOCK:
            _LANE_WAIT[0] += time.perf_counter() - t0
    try:
        yield
    finally:
        lane.lock.release()


def _count(kind: str, mode: str, capture_s: float = 0.0) -> None:
    with _LOCK:
        _COUNTS[kind][mode] += 1
        _CAPTURE_S[kind] += capture_s


def _after_capture(backend, lane: _Lane) -> None:
    """Trim the device's idle lanes to the budget, then note the pools'
    peak and the card's free share."""
    _trim_device(backend, lane, _budget(backend, lane.device))
    free, total = backend.mem_info(lane.device)
    with _LOCK:
        held = sum(ln.pool_bytes for ln in _LANES.values() if ln.device == lane.device)
        _POOL_PEAK[0] = max(_POOL_PEAK[0], held)
        _CARD_FREE_MIN[0] = min(_CARD_FREE_MIN[0], free / total)


def _replayed(backend, g: _Graph) -> None:
    backend.replay(g.handle)
    for wrapper, n in g.tally.items():
        build.add_launches(wrapper, n, *g.lane.key)


def _bind(static: dict, args: dict) -> None:
    """Put the inputs into the static inputs, unless the H2D already
    wrote them there (bound_inputs)."""
    for k, t in static.items():
        if args[k].data_ptr() != t.data_ptr():
            t.copy_(args[k])


def _sighted(seen: collections.OrderedDict, key) -> int:
    n = seen.get(key, 0) + 1
    seen[key] = n
    seen.move_to_end(key)
    while len(seen) > MAX_SEEN:
        seen.popitem(last=False)
    return n


def _capture(backend, lane: _Lane, fn, static: dict, call) -> tuple:
    """Capture ``fn(static)`` on the lane and replay it once, its marks
    going to the step clock's ``call``. The
    device's other idle lanes are trimmed to the budget first; a capture
    that runs out of device memory drops every idle lane and this
    lane's other graphs and tries once more (still a capture: it never
    falls back to eager)."""
    t0 = time.monotonic()
    _trim_device(backend, lane, _budget(backend, lane.device))
    for attempt in (0, 1):
        before = backend.reserved(lane.device)
        try:
            with build.tally_launches() as tally:
                handle, out = backend.capture(steps.capturing(call, lambda: fn(static)), lane)
            break
        except torch.OutOfMemoryError:
            if attempt:
                raise
            _make_room(backend, lane)
    # what the capture grew the card's reservation by: the lane's pool
    # (another thread's allocations at the same time land here too)
    lane.pool_bytes += max(backend.reserved(lane.device) - before, 0)
    g = _Graph(handle, static, out, tally, lane, steps.adopt(call))
    with steps.first_replay(g.stamps):
        _replayed(backend, g)
    return g, time.monotonic() - t0


def _make_room(backend, lane: _Lane) -> None:
    """After a capture ran out of memory: drop every idle lane of the
    device and this lane's graphs (a step graph whose epilogue is being
    captured lives on in its caller's hands), and empty the
    allocator's cache."""
    _trim_device(backend, lane, 0)
    backend.retire(lane)
    lane.graphs.clear()
    backend.release(lane.device)


def _evict(backend, lane: _Lane, table: collections.OrderedDict, cap: int,
           max_bytes: float = float("inf")) -> None:
    """Drop the least recently used graphs of ``table`` until it holds at
    most ``cap`` and their static bytes at most ``max_bytes`` (the one
    just added stays)."""
    def over():
        return len(table) > cap or (
            len(table) > 1 and sum(g.nbytes for g in table.values()) > max_bytes)

    if over():
        backend.retire(lane)
        while over():
            table.popitem(last=False)


def run_step(args: dict, spec, keys: tuple) -> tuple:
    """``fused_pipeline(*(args[k] for k in keys), spec)`` on the current
    lane (the tensors' device, its current stream): eagerly, or through
    the lane's graph of this class. The lane's lock covers its graph
    table and sightings, a replay and a capture; an eager step needs
    none of them and runs without it, so threads that share a lane
    enqueue their eager steps side by side. Returns (outputs, (mode,
    capture seconds))."""
    from duplexumiconsensusreads_torch.ops.pipeline import fused_pipeline

    def step(inputs):
        return fused_pipeline(*(inputs[k] for k in keys), spec)

    def label():
        n, r = args[keys[0]].shape[:2]
        return steps.class_label(spec, n, r, spec.cycles_len or args[keys[5]].shape[-1])

    device = args[keys[0]].device
    backend = _backend(device)
    key = None if backend is None and device.type != "cuda" else (
        spec, signature((args[k].shape, args[k].dtype) for k in keys))
    if backend is None:
        if key is None:
            return step(args), ("eager", 0.0)
        return _clocked(step, args, steps.begin("step", key, CudaBackend().lane(device), device,
                                                "eager", label)), ("eager", 0.0)
    lane = _lane(backend, device)
    with _LOCK:
        if len(_CLASSES) < MAX_CLASSES:
            _CLASSES.add(key)
    with _holding(lane):
        g = lane.graphs.get(key)
        if g is not None:
            lane.graphs.move_to_end(key)
            call = steps.begin("step", key, lane.key, device, "replayed", label)
            _bind(g.inputs, args)
            _replayed(backend, g)
            steps.end(call)
            _count("step", "replayed")
            return g.outputs, ("replayed", 0.0)
        eager = _sighted(lane.seen, key) == 1
        if eager:
            _eager_running(lane, 1)
        else:
            static = {k: args[k].clone() for k in keys}
            call = steps.begin("step", key, lane.key, device, "captured", label)
            g, dt = _capture(backend, lane, step, static, call)
            steps.end(call)
            g.label = call.tally.label if call is not None else None
            lane.graphs[key] = g
            _evict(backend, lane, lane.graphs, MAX_GRAPHS, MAX_LANE_STATIC_BYTES)
            _count("step", "captured", dt)
    if eager:
        _count("step", "eager")
        try:
            return _clocked(step, args, steps.begin("step", key, lane.key, device, "eager",
                                                    label)), ("eager", 0.0)
        finally:
            _eager_running(lane, -1)
    _after_capture(backend, lane)
    return g.outputs, ("captured", dt)


def _clocked(fn, arg, call):
    """``fn(arg)`` run eagerly as the step clock's ``call``."""
    try:
        with steps.marking(call):
            return fn(arg)
    finally:
        steps.end(call)


def run_epilogue(out: dict, fn, key: tuple) -> dict:
    """``fn(out)`` (the packed-D2H compaction of one lane's step
    outputs, ``key`` = (duplex, k_pad, n_shards)) eagerly, or through
    the epilogue graph that the step graph owning ``out`` keeps for
    that key on the current lane."""
    ref = getattr(out, "graph", None)
    owner = ref() if ref is not None else None
    if owner is None:
        device = next(iter(out.values())).device
        if device.type != "cuda":
            return fn(out)
        return _clocked(fn, out, steps.begin("epilogue", ("eager outputs", key),
                                             CudaBackend().lane(device), device, "eager",
                                             lambda: f"eager outputs k_pad={key[1]}"))
    backend = _backend(owner.lane.device)
    if backend is None or backend.lane(owner.lane.device) != owner.lane.key:
        return fn(out)
    lane = owner.lane
    ident = (owner.label, key)

    def label():
        return f"{owner.label} k_pad={key[1]}"

    with _holding(lane):
        g = owner.epilogues.get(key)
        if g is not None:
            owner.epilogues.move_to_end(key)
            call = steps.begin("epilogue", ident, lane.key, lane.device, "replayed", label)
            _replayed(backend, g)
            steps.end(call)
            _count("epilogue", "replayed")
            return g.outputs
        eager = _sighted(owner.epilogue_seen, key) == 1
        if eager:
            _eager_running(lane, 1)
        else:
            call = steps.begin("epilogue", ident, lane.key, lane.device, "captured", label)
            g, dt = _capture(backend, lane, fn, out, call)
            steps.end(call)
            owner.epilogues[key] = g
            _evict(backend, lane, owner.epilogues, MAX_EPILOGUES)
            _count("epilogue", "captured", dt)
    if eager:
        _count("epilogue", "eager")
        try:
            return _clocked(fn, out, steps.begin("epilogue", ident, lane.key, lane.device,
                                                 "eager", label))
        finally:
            _eager_running(lane, -1)
    _after_capture(backend, lane)
    return g.outputs


def bound_inputs(spec, shapes: tuple, keys: tuple, device):
    """The static inputs of the current lane's step graph for ``spec``
    and inputs of ``shapes`` ((shape, dtype) per key, see
    :func:`signature`), for an H2D that copies straight into them; None
    when the lane has no such graph."""
    backend = _backend(device)
    if backend is None:
        return None
    with _LOCK:
        lane = _LANES.get(backend.lane(device))
    if lane is None:
        return None
    g = lane.graphs.get((spec, signature(shapes)))
    if g is None:
        return None
    return {k: g.inputs[k] for k in keys}
