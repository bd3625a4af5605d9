"""The device step with its inputs resident: the dispatch classes an
executor forms, staged on the card once, then the program's compiled
step (``parallel/sharded.py:presharded_pipeline`` through
``runtime/graphs.py``) replayed over every class, pass after pass, with
work queued ahead.

Traffic keys: ``chunk_reads`` (0: the whole-file call's classes, one
batch, its packed H2D rung and no D2H epilogue; otherwise the streaming
call's: chunks cut by its rule, the run's qual alphabet for the
sub-byte rung, each class on its stream slot, and the packed-D2H
epilogue after each step), ``max_chunks`` (the chunks staged: the
streaming call keeps ``max_inflight`` of them on the card),
``warm_passes`` (passes in set-up: eager, step capture, epilogue
capture, one replay), ``ahead`` (passes queued ahead of the one the
host waits for), ``trace_seconds``, ``check_buckets``. The window ends
with one synchronize; its rate is every read of every pass over all
that time.
"""

from __future__ import annotations

import time
from collections import deque

import numpy as np

from portbench.gen.sim import simulate
from portbench.reference.partition import chunk_bounds


def _batch(reads, a: int, b: int):
    from duplexumiconsensusreads_torch.types import ReadBatch

    n = b - a
    return ReadBatch(bases=reads.bases[a:b], quals=reads.quals[a:b], umi=reads.umi[a:b],
                     pos_key=reads.pos[a:b].astype(np.int64), strand_ab=reads.strand_ab[a:b],
                     frag_end=np.zeros(n, bool), valid=np.ones(n, bool))


def form_classes(ctx) -> tuple[list[dict], list[tuple[int, int]]]:
    """The dispatch classes the program's executor forms for the cell's
    reads, in dispatch order and not yet staged: ([{chunk, a, b,
    buckets, spec}], the chunks' read ranges). The streaming call's
    rule (chunks, the run's qual alphabet for the sub-byte rung) is
    followed here through the program's public functions; the
    program has no public function that forms a chunk's classes."""
    from duplexumiconsensusreads_torch.bucketing import build_buckets
    from duplexumiconsensusreads_torch.ops.pipeline import SUBBYTE_QBITS, qual_alphabet
    from duplexumiconsensusreads_torch.runtime.executor import packed_io_ok, partition_buckets
    from duplexumiconsensusreads_torch.types import ConsensusParams, GroupingParams

    tr, cfg = ctx.traffic, ctx.config
    gp = GroupingParams(**cfg["grouping"])
    cp = ConsensusParams(**cfg["consensus"])
    cap = int(cfg["capacity"])
    chunk_reads = int(tr.get("chunk_reads", 0))
    bounds = chunk_bounds(ctx.reads.pos, chunk_reads)
    if tr.get("max_chunks"):
        bounds = bounds[: int(tr["max_chunks"])]
    # the most qualities the sub-byte rung packs; past it the run keeps
    # the byte rung
    alpha_cap = (1 << max(SUBBYTE_QBITS)) - 1
    alpha_seen: set | None = set()
    classes = []
    for k, (a, b) in enumerate(bounds):
        buckets = build_buckets(_batch(ctx.reads, a, b), capacity=cap, grouping=gp)
        if chunk_reads:
            alpha = None
            if alpha_seen is not None:
                alpha_seen.update(qual_alphabet(buckets))
                alpha = tuple(sorted(alpha_seen)) if len(alpha_seen) <= alpha_cap else None
                alpha_seen = alpha_seen if alpha is not None else None
            part = partition_buckets(buckets, gp, cp, packed_io=True, qual_alphabet=alpha,
                                     device=ctx.device)
        else:
            part = partition_buckets(buckets, gp, cp, packed_io=packed_io_ok(cp),
                                     device=ctx.device)
        classes += [{"chunk": k, "a": a, "b": b, "buckets": cbuckets, "spec": cspec}
                    for cbuckets, cspec in part]
    return classes, bounds


def class_heads(ctx) -> set[int]:
    """The first read of each class's first bucket: the check compares
    a bucket of every class, so every captured graph is judged."""
    return {int(c["buckets"][0].read_index[0]) + c["a"] for c in ctx.state["classes"]}


def setup(ctx) -> None:
    import torch

    from duplexumiconsensusreads_torch.parallel.mesh import run_mesh
    from duplexumiconsensusreads_torch.parallel.sharded import lane_streams, put_lanes, stage_lanes
    from duplexumiconsensusreads_torch.runtime.executor import d2h_k_pad, d2h_pack_ok
    from duplexumiconsensusreads_torch.runtime.stream import class_slot, run_slots

    tr = ctx.traffic
    # set-up's parts in seconds, for the counters line
    t = [time.monotonic()]
    ctx.reads = simulate(ctx.config["sim"], ctx.seed)
    t.append(time.monotonic())
    classes, bounds = form_classes(ctx)
    t.append(time.monotonic())
    chunk_reads = int(tr.get("chunk_reads", 0))
    mesh = run_mesh(ctx.device)
    on_cuda = ctx.device.type == "cuda"
    slots = run_slots(mesh, on_cuda) if chunk_reads else []
    epilogue = bool(chunk_reads) and d2h_pack_ok(int(ctx.config["capacity"]), False)
    rows_real = rows_padded = 0
    for c in classes:
        cbuckets, cspec = c["buckets"], c["spec"]
        if slots:
            # the streaming call's slot key: (spec, stacked buckets, capacity)
            key = (cspec, len(cbuckets), cbuckets[0].capacity)
            streams = slots[class_slot(key) % len(slots)][1]
        else:
            streams = lane_streams(mesh)
        blocks = stage_lanes(cbuckets, mesh, cspec, streams=streams)
        c.update(streams=streams, args=put_lanes(blocks, mesh, cspec, streams=streams),
                 blocks=blocks, k_pad=d2h_k_pad(cbuckets, cspec, 1) if epilogue else None)
        rows_real += sum(int(bk.valid.sum()) for bk in cbuckets)
        rows_padded += len(cbuckets) * cbuckets[0].capacity
    if on_cuda:
        torch.cuda.synchronize()
    for c in classes:
        del c["blocks"]  # the copies from the pinned staging are done
    ctx.state.update(mesh=mesh, classes=classes, streams=[s for s in
                     {id(x): x for c in classes for x in c["streams"]}.values()])
    ctx.counters.update(rows_real=rows_real, rows_padded=rows_padded, classes=len(classes),
                        buckets=sum(len(c["buckets"]) for c in classes))
    ctx.state["pass_reads"] = sum(b - a for a, b in bounds)
    t.append(time.monotonic())
    for _ in range(int(tr.get("warm_passes", 4))):
        _pass(ctx)
    if on_cuda:
        torch.cuda.synchronize()
    t.append(time.monotonic())
    ctx.counters["setup_parts_s"] = dict(zip(("simulate", "classes", "stage", "warm"),
                                             (b - a for a, b in zip(t, t[1:]))))


def _step(ctx, c) -> list:
    from duplexumiconsensusreads_torch.parallel.sharded import presharded_pipeline
    from duplexumiconsensusreads_torch.runtime.executor import pack_fetch_outputs

    mesh = ctx.state["mesh"]
    outs = presharded_pipeline(c["args"], c["spec"], mesh, streams=c["streams"])
    if c["k_pad"] is not None:
        outs = pack_fetch_outputs(outs, c["spec"], c["k_pad"], mesh=mesh, streams=c["streams"])
    return outs


def _pass(ctx) -> None:
    for c in ctx.state["classes"]:
        _step(ctx, c)


def _mark(ctx) -> list:
    """Events on every stream the classes run on, recorded now."""
    import torch

    from duplexumiconsensusreads_torch.parallel.sharded import lane_context

    evs = []
    for st in ctx.state["streams"]:
        with lane_context(ctx.device, st):
            ev = torch.cuda.Event()
            ev.record()
            evs.append(ev)
    return evs


def window(ctx) -> None:
    import torch

    on_cuda = ctx.device.type == "cuda"
    ahead = int(ctx.traffic.get("ahead", 2))
    queued: deque = deque()
    t0 = time.monotonic()
    while True:
        if on_cuda and len(queued) >= ahead:
            for ev in queued.popleft():
                ev.synchronize()
        _pass(ctx)
        ctx.attempted += 1
        if on_cuda:
            queued.append(_mark(ctx))
        if time.monotonic() - t0 >= ctx.window_seconds:
            break
    if on_cuda:
        torch.cuda.synchronize()
    ctx.window_s = time.monotonic() - t0
    ctx.window_reads = ctx.attempted * ctx.state["pass_reads"]


def observe(ctx, buckets) -> dict:
    """Records of the reference's ``buckets`` from the classes' outputs:
    each class that holds one is stepped once more as in the window and
    its outputs fetched; a bucket is found by its first read."""
    import torch

    from duplexumiconsensusreads_torch.parallel.sharded import lane_context
    from duplexumiconsensusreads_torch.runtime.executor import (
        PACKED_FETCH_KEYS,
        fetch_outputs,
        scatter_bucket_outputs,
        start_fetch,
        unpack_fetch_outputs,
    )

    want = {int(b[0]) for b in buckets}
    found, n_classes, out = 0, 0, {}
    duplex = ctx.config["consensus"]["mode"] == "duplex"
    for c in ctx.state["classes"]:
        first = [int(bk.read_index[0]) + c["a"] for bk in c["buckets"]]
        rows = [i for i, f in enumerate(first) if f in want]
        if not rows:
            continue
        outs = _step(ctx, c)
        with lane_context(ctx.device, c["streams"][0]):
            keys = PACKED_FETCH_KEYS if c["k_pad"] is not None else None
            sel = start_fetch(outs[0], keys=keys) if keys else start_fetch(outs[0])
        host = unpack_fetch_outputs(fetch_outputs(sel), c["buckets"], c["spec"], n_shards=1)
        if ctx.device.type == "cuda":
            torch.cuda.synchronize()
        nb = len(c["buckets"])
        sub = {k: v[rows] if np.ndim(v) and len(v) == nb else v for k, v in host.items()}
        batch = _batch(ctx.reads, c["a"], c["b"])
        cb, cq, ds, fp, fu = scatter_bucket_outputs(sub, [c["buckets"][i] for i in rows],
                                                    batch, duplex)[:5]
        for j in range(len(cb)):
            out.setdefault((int(fp[j]), fu[j].tobytes()), []).append(
                (cb[j], cq[j], int(ds[j, 0]), int(ds[j, 1])))
        found += len(rows)
        n_classes += 1
    ctx.counters.update(buckets_found=found, classes_compared=n_classes)
    return out


def free(ctx) -> None:
    import torch

    ctx.state.pop("classes", None)
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
