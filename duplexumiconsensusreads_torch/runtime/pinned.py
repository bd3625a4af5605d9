"""Pinned host staging buffers reused per lane: the H2D sources of a
dispatch (parallel/sharded.py:stage_lanes) and the D2H targets of its
fetch (runtime/executor.py:start_fetch).

A dispatch used to pin new host memory for every array it sent and
every output it fetched (``Tensor.pin_memory()``, ``torch.empty(...,
pin_memory=True)``). Here each (lane, shape, dtype) keeps a ring of
pinned buffers: :func:`take` hands one out, reused when the ring has a
free one. A buffer goes back to its ring only when both hold:

- the event that closes the dispatch's copies (:func:`fence`, the
  fetch's event, recorded after its last D2H copy on the lane's stream,
  which also orders its H2D copies) has fired, so no copy still reads
  or writes it; and
- nothing references its memory any more: no tensor and no numpy view
  (the drain's unpack and scatter read the fetched arrays in place)
  holds its storage, which the storage's use count shows.

Both are checked when a buffer is next asked for (:func:`take`); no
finalizer runs CUDA calls. A buffer that was never fenced (a dispatch
that failed before its fetch started) or whose ring is full is dropped,
to PyTorch's host allocator, which keeps its own events for the copies
it saw. The ring holds at most ``depth`` free buffers per key: the
caller's in-flight bound (the streaming executor's ``prefetch_depth +
drain_workers``), and all rings at most ``MAX_FREE_BYTES`` free
together, the buffers freed first dropped first. The bytes on the wire
do not change.
"""

from __future__ import annotations

import threading

import torch

# free buffers a (lane, shape, dtype) ring keeps by default, and the
# bytes all rings keep free together (past it the buffers freed first
# go): shapes change chunk to chunk, and a long-lived process (a serve
# daemon) would otherwise keep a ring for every shape it ever staged
DEPTH = 2
MAX_FREE_BYTES = 2 << 30

_LOCK = threading.Lock()
_FREE: dict = {}  # key -> free storages, keys in the order they were last freed into
_FREE_BYTES = [0]
# handed-out buffers: (key, storage, fence, ring depth)
_OUT: list = []
_STATS = {"taken": 0, "reused": 0, "dropped": 0, "writes": 0}


class _Fence:
    """The event that closes a buffer's copies, set by :func:`fence`."""

    __slots__ = ("event",)

    def __init__(self):
        self.event = None


def _use_count(storage) -> int:
    return torch._C._storage_Use_Count(storage._cdata)


def _recycle() -> None:
    """Move handed-out buffers that nothing holds and whose copies are
    done into their rings; forget unfenced ones that nothing holds."""
    with _LOCK:
        out = _OUT[:]
        _OUT.clear()
    keep = []
    for entry in out:
        key, storage, fence_, depth = entry
        # the list's storage wrapper is the one reference left
        if _use_count(storage) > 1 or (fence_.event is not None and not fence_.event.query()):
            keep.append(entry)
            continue
        with _LOCK:
            free = _FREE.pop(key, [])
            _FREE[key] = free  # most recently freed last
            if fence_.event is not None and len(free) < depth:
                free.append(storage)
                _FREE_BYTES[0] += storage.nbytes()
            else:
                _STATS["dropped"] += 1
            while _FREE_BYTES[0] > MAX_FREE_BYTES:
                oldest = next(iter(_FREE))
                if not _FREE[oldest]:
                    del _FREE[oldest]
                    continue
                _FREE_BYTES[0] -= _FREE[oldest].pop(0).nbytes()
                _STATS["dropped"] += 1
    with _LOCK:
        _OUT.extend(keep)


def _alloc(shape: tuple, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, pin_memory=True)


def lane_of(device) -> tuple:
    """(device index, current stream handle) of a CUDA device."""
    device = torch.device(device)
    return device.index, torch.cuda.current_stream(device).cuda_stream


def take(shape, dtype, lane: tuple, depth: int | None = None) -> torch.Tensor:
    """A pinned, contiguous host tensor of ``shape`` and ``dtype`` for
    ``lane``'s copies: from the ring when it has one free, else new."""
    shape = tuple(int(s) for s in shape)
    key = (lane, shape, dtype)
    _recycle()
    with _LOCK:
        free = _FREE.get(key)
        storage = free.pop() if free else None
        _STATS["taken"] += 1
        if storage is not None:
            _STATS["reused"] += 1
            _FREE_BYTES[0] -= storage.nbytes()
    if storage is None:
        t = _alloc(shape, dtype)
    else:
        t = torch.empty(0, dtype=dtype).set_(storage, 0, shape)
    fence_ = _Fence()
    t._dut_fence = fence_
    with _LOCK:
        _OUT.append((key, t.untyped_storage(), fence_, depth or DEPTH))
    return t


def fence(tensors, event) -> None:
    """Close the copies of ``tensors`` (buffers from :func:`take`; others
    are skipped) with ``event``: recorded on their lane's stream after
    the last copy that touches them."""
    for t in tensors:
        f = getattr(t, "_dut_fence", None)
        if f is not None:
            f.event = event


def count_write() -> None:
    """Count one lane block written into pinned buffers (``writes`` in
    :func:`stats`)."""
    with _LOCK:
        _STATS["writes"] += 1


def stats() -> dict:
    """{taken, reused, dropped, writes}: buffers handed out, of them
    reused from a ring, buffers given up to the host allocator, and lane
    blocks written into pinned buffers (parallel/sharded.py:stage_lanes);
    with the free buffers the rings hold and those still out."""
    with _LOCK:
        return {**_STATS, "free": sum(len(v) for v in _FREE.values()),
                "free_bytes": _FREE_BYTES[0], "out": len(_OUT)}


def clear() -> None:
    with _LOCK:
        _FREE.clear()
        _FREE_BYTES[0] = 0
        _OUT.clear()
        for k in _STATS:
            _STATS[k] = 0
