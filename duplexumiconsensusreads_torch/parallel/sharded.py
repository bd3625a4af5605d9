"""Mesh-sharded execution of the fused pipeline: one contiguous bucket
block per data lane, each on its own device and CUDA stream.

The JAX package shards the stacked buckets over a ``jax.sharding``
mesh and lets GSPMD (or a shard_map) partition the vmapped pipeline.
The port has neither, and needs neither: buckets are independent, so
the per-lane loop below *is* the partition. Its decisions:

- **Data lanes.** :func:`stage_lanes` pads a class to a multiple of
  the data-axis size with empty buckets (the mesh pad); lane d takes
  buckets ``[d*per, (d+1)*per)``. Each lane
  runs :func:`fused_pipeline` on its block alone, on its device, on
  its own CUDA stream. No collective exists, so no lane's work ever
  waits on another lane's (the JAX shard_map form is collective-free
  for the same reason; a cross-shard reduction there deadlocked
  concurrent dispatches). Nothing synchronises across devices inside
  a dispatch: every lane's results come back to the host by its own
  D2H copies, and the host joins them.
- **Cycle lanes** (a ('data', 'cycle') mesh). GSPMD would partition the
  read-length axis and insert what the cross-cycle parts need; here it
  is split by hand. Grouping reads no cycle, so each cycle lane runs it
  on the whole data block and computes the same ids (it is cheap next
  to the consensus, and sharing ids would need a cross-device copy).
  The consensus math, the error model's fit and cap, and the duplex
  merge are per cycle: a lane runs them on its slice of the cycles
  (:func:`cycle_bounds`: multiples of 8 cycles, so the sub-byte rung's
  bit planes and the packed D2H's 2-bit bases split on byte
  boundaries). Family sizes, validity, mate and pair metadata read no
  cycle, so every lane computes them identically and the host keeps
  lane 0's. The reductions over L are combined after the lanes finish
  (:func:`combine_lane_outputs`): ``depth_max`` is the maximum over
  lanes and ``depth_min_pos`` the minimum of the lanes' positive
  values. Every per-cycle element is computed by the same f32
  operations as on one lane, so a cycle mesh's outputs are the
  one-lane outputs byte for byte (held exactly by
  tests/test_torch_parallel.py; JAX holds its GSPMD form only to a
  qual tolerance).
- **Kernels on every device.** Each lane runs inside
  :func:`lane_context` (the lane's device and stream), so both kernels
  launch there: their wrappers take ``torch.cuda.current_stream`` of
  the tensor's device under its device guard, and set their per-device
  function attributes under it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading

import numpy as np
import torch

from duplexumiconsensusreads_torch.interop import ARRAY_KEYS as _ARRAY_KEYS


def stacked_nbytes(stacked: dict) -> int:
    """Bytes of the stacked arrays that actually cross the wire (the
    _ARRAY_KEYS set); host-only bookkeeping (read_index,
    n_real_buckets) never leaves the host."""
    return sum(stacked[k].nbytes for k in _ARRAY_KEYS)


# cycles per cycle-lane boundary: one byte of a bit plane
CYCLE_ALIGN = 8


def cycle_bounds(l: int, cycle_shards: int) -> list[tuple[int, int]]:
    """[(l0, l1)] per cycle lane: contiguous slices of the L cycles,
    each but the last a multiple of CYCLE_ALIGN wide. Raises when L is
    too short to give every lane a cycle."""
    if cycle_shards <= 1:
        return [(0, l)]
    w = -(-l // (cycle_shards * CYCLE_ALIGN)) * CYCLE_ALIGN
    if (cycle_shards - 1) * w >= l:
        raise ValueError(
            f"read length {l} is too short for cycle_shards={cycle_shards}: "
            f"each cycle shard but the last takes a multiple of {CYCLE_ALIGN} cycles"
        )
    return [(c * w, min((c + 1) * w, l)) for c in range(cycle_shards)]


def _cycles_of(stacked: dict, spec) -> int:
    if spec is not None and spec.packed_qbits:
        return spec.cycles_len
    return int(stacked["bases"].shape[-1])


def _cycle_slice(stacked: dict, spec, l0: int, l1: int) -> dict:
    """The stacked arrays restricted to cycles [l0, l1): unpacked and
    byte-rung cycles are the last axis; the sub-byte rung's bit planes
    are (2 + qbits) planes of ceil(L/8) bytes each."""
    out = dict(stacked)
    bases = stacked["bases"]
    if spec is not None and spec.packed_qbits:
        planes = 2 + spec.packed_qbits
        b, r, w = bases.shape
        pl = bases.reshape(b, r, planes, w // planes)
        out["bases"] = np.ascontiguousarray(
            pl[..., l0 // CYCLE_ALIGN : -(-l1 // CYCLE_ALIGN)]
        ).reshape(b, r, -1)
    else:
        out["bases"] = bases[..., l0:l1]
    quals = stacked["quals"]
    if quals.shape[-1]:  # unpacked; the packed rungs send a zero-width dummy
        out["quals"] = quals[..., l0:l1]
    return out


# buckets a lane's block is stacked and packed by at a time on the
# packed rungs: a block's unpacked arrays (bases and quals of a few MB)
# stay in the cache on their way into the staging buffers
STAGE_BLOCK = 8


def _staging_buffer(dev, shape, dtype, depth, keep) -> tuple:
    """(numpy view, tensor or None) of a buffer for one staged array:
    from the current stream's pinned ring on the card (appended to
    ``keep``), a new numpy array on the CPU."""
    if dev.type != "cuda":
        return np.empty(shape, dtype), None
    from duplexumiconsensusreads_torch.interop import TORCH_DTYPES
    from duplexumiconsensusreads_torch.runtime import pinned

    # u16 (the packed pos) crosses as its int16 bit pattern
    wire = np.dtype(np.int16) if dtype == np.uint16 else np.dtype(dtype)
    t = pinned.take(shape, TORCH_DTYPES[wire], pinned.lane_of(dev), depth)
    keep.append(t)
    return t.numpy().view(dtype), t


def stage_lanes(buckets: list, mesh, spec=None, streams=None, keep=None,
                depth: int | None = None) -> list[dict]:
    """Each lane's block of a class, in lane order: the buckets stacked
    to a multiple of ``mesh.n_data`` (the mesh pad last) and packed when
    ``spec.packed_io``, data lane d's contiguous bucket block restricted
    to cycle lane c's cycles (``spec`` is needed on a cycle mesh for the
    sub-byte rung). Each block is written once, straight into the
    buffers it crosses the wire from: on the card the lane's pinned
    staging buffers, from its stream's ring (runtime/pinned.py, ``depth``
    free buffers kept), which are appended to ``keep[i]`` for the caller
    to fence; on the CPU new numpy arrays. A cycle mesh stages each data
    block once and copies each cycle lane's slice into that lane's
    buffers. Returns one dict per lane of ARRAY_KEYS: pinned tensors on
    the card (the u16 pos as its int16 bit pattern), numpy arrays on the
    CPU; :func:`put_lanes` sends them."""
    from duplexumiconsensusreads_torch.bucketing import pad_buckets, stack_buckets
    from duplexumiconsensusreads_torch.ops.pipeline import pack_stacked
    from duplexumiconsensusreads_torch.runtime import pinned

    streams = streams or [None] * mesh.size
    keep = keep or [[] for _ in range(mesh.size)]
    packed = spec is not None and spec.packed_io
    padded = pad_buckets(buckets, mesh.n_data)
    per = len(padded) // mesh.n_data
    # each array's shape and dtype past the bucket axis, from one bucket
    probe = stack_buckets(buckets[:1])
    if packed:
        pack_stacked(probe, spec)
    layout = {k: (probe[k].shape[1:], probe[k].dtype) for k in _ARRAY_KEYS}

    def fill(sub, dst):
        if not packed:
            stack_buckets(sub, out=dst)
            return
        for j in range(0, len(sub), STAGE_BLOCK):
            pack_stacked(stack_buckets(sub[j : j + STAGE_BLOCK]), spec,
                         out={k: v[j : j + STAGE_BLOCK] for k, v in dst.items()})

    out = []

    def write(i, shapes, fn):
        """Lane i's buffers of ``shapes``, filled by ``fn(views)``."""
        dev = mesh.devices[i]
        with lane_context(dev, streams[i]):
            made = {k: _staging_buffer(dev, shape, dt, depth, keep[i])
                    for k, (shape, dt) in shapes.items()}
        fn({k: v for k, (v, _) in made.items()})
        if dev.type == "cuda":
            pinned.count_write()
            out.append({k: t for k, (_, t) in made.items()})
        else:
            out.append({k: v for k, (v, _) in made.items()})

    for d in range(mesh.n_data):
        sub = padded[d * per : (d + 1) * per]
        shapes = {k: ((per, *tail), dt) for k, (tail, dt) in layout.items()}
        if mesh.n_cycle == 1:
            write(d, shapes, lambda views: fill(sub, views))
            continue
        block = {k: np.empty(shape, dt) for k, (shape, dt) in shapes.items()}
        fill(sub, block)
        for c, (l0, l1) in enumerate(cycle_bounds(_cycles_of(block, spec), mesh.n_cycle)):
            part = _cycle_slice(block, spec, l0, l1)
            write(d * mesh.n_cycle + c, {k: (v.shape, v.dtype) for k, v in part.items()},
                  lambda views: [np.copyto(v, part[k]) for k, v in views.items()])
    return out


def lane_specs(spec, mesh) -> list:
    """The spec each lane runs, in lane order: on a cycle mesh the
    sub-byte rung's lanes decode their own slice's cycle count; every
    other field is the class's."""
    if mesh.n_cycle == 1 or spec is None or not spec.packed_qbits:
        return [spec] * mesh.size
    bounds = cycle_bounds(spec.cycles_len, mesh.n_cycle)
    return [dataclasses.replace(spec, cycles_len=l1 - l0)
            for _ in range(mesh.n_data) for l0, l1 in bounds]


# streams handed back by finished runs, keyed by (device, the cuBLAS
# handle of the thread that took them). torch keeps a cuBLAS workspace
# (tens of MiB) for every (handle, stream) pair it has seen and frees
# none: a new stream per run would grow the card's allocated memory run
# by run in a long-lived process (a serve daemon). A thread owns its
# handle while it lives and handles are reused after, so keying the pool
# by handle pairs each handle with the same streams every run.
_STREAM_POOL: dict = {}
_STREAM_POOL_LOCK = threading.Lock()


def _pool_key(device) -> tuple:
    device = torch.device(device)
    with torch.cuda.device(device):
        # a runtime call first: it makes the card's primary context
        # current in a fresh thread, as the handle query expects
        torch.cuda.mem_get_info(device)
        return device, torch.cuda.current_blas_handle()


def _acquire_stream(device) -> "torch.cuda.Stream":
    key = _pool_key(device)
    with _STREAM_POOL_LOCK:
        free = _STREAM_POOL.get(key)
        st = free.pop() if free else None
    if st is None:
        st = torch.cuda.Stream(device)
    st.pool_key = key
    return st


def release_streams(streams) -> None:
    """Hand streams back for later runs to reuse; a caller does this once
    every thread that used them has finished."""
    with _STREAM_POOL_LOCK:
        for st in streams:
            if st is not None:
                _STREAM_POOL.setdefault(st.pool_key, []).append(st)


def lane_streams(mesh, fresh: bool = False) -> list:
    """The CUDA stream of each lane: None (the card's current stream)
    for a lane alone on its card, a stream of its own for each lane of a
    card that serves several (two lanes on one card get two streams), or
    for every lane with ``fresh`` (a caller that dispatches from several
    threads). Streams come from the pool :func:`release_streams` fills,
    else are new. None per lane on the CPU."""
    devs = mesh.devices
    return [
        _acquire_stream(d) if d.type == "cuda" and (fresh or devs.count(d) > 1) else None
        for d in devs
    ]


@contextlib.contextmanager
def lane_context(device, stream=None):
    """Make ``device`` the current CUDA device and ``stream`` its current
    stream for the block (nothing on the CPU)."""
    if device.type != "cuda":
        yield
        return
    with torch.cuda.device(device):
        if stream is None:
            yield
        else:
            with torch.cuda.stream(stream):
                yield


def put_lanes(blocks: list[dict], mesh, spec=None, streams=None) -> list[dict]:
    """Put each lane's block (from :func:`stage_lanes`) on its device, on
    the lane's stream; returns the per-lane tensor dicts. On the card
    the copies leave the lane's pinned staging buffers without blocking,
    and a lane whose step graph for this class exists copies straight
    into the graph's static inputs (runtime/graphs.py:bound_inputs)."""
    streams = streams or [None] * mesh.size
    specs = lane_specs(spec, mesh)
    out = []
    for i, (dev, block) in enumerate(zip(mesh.devices, blocks)):
        with lane_context(dev, streams[i]):
            out.append(put_lane(block, dev, specs[i]))
    return out


def put_lane(block: dict, dev, spec) -> dict:
    """One lane's H2D, on the current stream (see :func:`put_lanes`)."""
    from duplexumiconsensusreads_torch.interop import host_shapes, stacked_from_numpy
    from duplexumiconsensusreads_torch.runtime import graphs

    static = (graphs.bound_inputs(spec, host_shapes(block), _ARRAY_KEYS, dev)
              if dev.type == "cuda" else None)
    return stacked_from_numpy(block, dev, out=static)


def presharded_pipeline(args: list, spec, mesh, streams=None, modes: list | None = None) -> list[dict]:
    """Run :func:`fused_pipeline` on each lane's device-resident block
    (from :func:`put_lanes`), on the lane's device and stream; the
    pure-compute path benchmarks time. On the card each lane's step goes
    through the lane's graph cache (runtime/graphs.py: eager at a
    class's first sight on the lane, captured at the second, replayed
    after); ``modes`` collects each lane's (mode, capture seconds).
    Returns the per-lane output dicts, in lane order: a replayed lane's
    are its graph's static outputs, which hold until the next step on
    the lane's stream."""
    from duplexumiconsensusreads_torch.runtime import graphs

    streams = streams or [None] * mesh.size
    specs = lane_specs(spec, mesh)
    outs = []
    for i, dev in enumerate(mesh.devices):
        with lane_context(dev, streams[i]):
            out, mode = graphs.run_step(args[i], specs[i], _ARRAY_KEYS)
            outs.append(out)
            if modes is not None:
                modes.append(mode)
    return outs


def sharded_pipeline(buckets: list, spec, mesh, streams=None) -> list[dict]:
    """All buckets of a class across the mesh: per-lane outputs
    (:func:`gather_outputs` joins them on the host)."""
    streams = streams or lane_streams(mesh)
    blocks = stage_lanes(buckets, mesh, spec, streams=streams)
    return presharded_pipeline(put_lanes(blocks, mesh, spec, streams=streams), spec, mesh,
                               streams=streams)


def _min_positive(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.where((a > 0) & (b > 0), np.minimum(a, b), np.maximum(a, b))


# per-cycle outputs: unpacked (B, F, L) matrices and the packed D2H
# rows' quals (K, L) and 2-bit bases (K, ceil(L/4))
_CYCLE_KEYS = ("cons_base", "cons_qual", "cons_depth", "cons_err", "cons_q", "cons_b2")


def combine_lane_outputs(lanes: list[dict], mesh) -> dict:
    """Host join of per-lane numpy outputs (in lane order) into the
    one-lane form: the cycle lanes of each data block are joined first
    (per-cycle keys concatenated along their last axis; ``depth_max``
    by maximum and ``depth_min_pos`` by minimum positive value, in the
    packed D2H's ``cons_dstats`` columns too; every other key is the
    same on each cycle lane and lane 0's is kept), then the data
    blocks are concatenated along the leading axis (buckets, or the
    packed D2H's per-shard row blocks, shard-major)."""
    rows = []
    for d in range(mesh.n_data):
        group = lanes[d * mesh.n_cycle : (d + 1) * mesh.n_cycle]
        if len(group) == 1:
            rows.append(group[0])
            continue
        joined = {}
        for k, v in group[0].items():
            vals = [g[k] for g in group]
            if k in _CYCLE_KEYS:
                joined[k] = np.concatenate(vals, axis=-1)
            elif k == "depth_max":
                joined[k] = np.maximum.reduce(vals)
            elif k == "depth_min_pos":
                acc = vals[0]
                for x in vals[1:]:
                    acc = _min_positive(acc, x)
                joined[k] = acc
            elif k == "cons_dstats":
                mx = np.maximum.reduce([x[:, 0] for x in vals])
                mn = vals[0][:, 1]
                for x in vals[1:]:
                    mn = _min_positive(mn, x[:, 1])
                joined[k] = np.stack([mx, mn], axis=1).astype(v.dtype)
            else:
                joined[k] = v
        rows.append(joined)
    if len(rows) == 1:
        return rows[0]
    return {k: np.concatenate([r[k] for r in rows], axis=0) for k in rows[0]}


def gather_outputs(outs: list[dict], mesh, streams=None) -> dict:
    """Per-lane device outputs -> one host numpy dict (the one-lane
    form, :func:`combine_lane_outputs`). Each lane's copy runs on the
    lane's stream, after its work."""
    streams = streams or [None] * mesh.size
    host = []
    for i, dev in enumerate(mesh.devices):
        with lane_context(dev, streams[i]):
            host.append({k: v.cpu().numpy() for k, v in outs[i].items()})
    return combine_lane_outputs(host, mesh)
