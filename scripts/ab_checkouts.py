"""Compare this checkout's port with another checkout's on one device.

    python scripts/ab_checkouts.py --other DIR
        [--reads 600000] [--chunk-reads 150000] [--reps 10] [--device cuda]
        [--mesh] [--pairs 2] [--json OUT]

DIR is the root of another checkout of the repository (an unpacked
``git archive`` of a parent commit, say). One config5 input (the
simulator's duplex model at read_len 150, family size 4, umi_error
0.01, seed 7; ``--reads`` reads) is simulated once by this checkout;
then each checkout, in its own subprocess and in ``--pairs`` pairs of
turns other, this, then this, other (and so on), builds its kernels and
on the device:

- runs the whole-file call (capacity 2048) and the streaming call
  (``--chunk-reads`` chunks) on the input, and hashes both outputs;
  then the streaming call twice more, timing the third (the steady
  state of a process that meets its classes again);
- takes the largest dispatch class of the whole-file call and times,
  with CUDA events over ``--reps`` calls after a warm-up, the fused
  step, ``group_kernel``, and the grouping function each checkout's
  ``group_kernel`` calls for its unique-UMI table (``directional_cluster``,
  or ``_directional_cluster`` in a checkout that has it), each timed
  inside one ``group_kernel`` call.

With ``--mesh`` each turn also runs the mesh: every card a data lane
(two lanes on two streams of cuda:0 on a one-card machine; two CPU
lanes with ``--device cpu``). After one untimed whole-file call on all
lanes, the whole-file call and three streaming calls (the first and
the third timed) run at one lane and at all lanes (their bytes held to
the default run's; the summary adds each turn's one-lane over all-lane
ratio), and
a class of up to ``MESH_STEP_BUCKETS`` buckets (the largest of the
input) is put on the lanes once and its fused step timed at one lane
and at all lanes, in turns, every card synchronized after the reps,
with each lane's host enqueue (the lanes' ``presharded_pipeline`` call
over the lane count); then that class staged at all lanes as the
stream dispatches it, each part's host ms (stack, pack, staging and
H2D; the step; the packed compaction and D2H start). Both warm up twice, since a
checkout with CUDA graphs captures a class at its second sight. The
streaming call runs traced, and each turn reports its wire floor
(``telemetry/ledger.py:wire_floor``).

Prints one JSON line per turn and, last, the summary: whether every
turn's outputs are byte-identical to the first's, and each checkout's
mean over its turns, with each turn's walls. ``--device cpu`` checks
the bytes only (no device times). A device measurement that finds no card fails.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

# the turn a subprocess runs, with the checkout's root first on sys.path;
# its arguments come in the environment, so that both checkouts' @PG
# lines (which carry the command line) are the same
CHILD = r"""
import hashlib, json, os, sys, time
root, in_bam, td, device = (os.environ[k] for k in ("AB_ROOT", "AB_IN", "AB_TD", "AB_DEVICE"))
chunk_reads, reps = int(os.environ["AB_CHUNK_READS"]), int(os.environ["AB_REPS"])
sys.path.insert(0, root)
import torch
from duplexumiconsensusreads_torch.cli.main import params_for
from duplexumiconsensusreads_torch.kernels import grouping
from duplexumiconsensusreads_torch.ops import pipeline
from duplexumiconsensusreads_torch.runtime.executor import call_consensus_file
from duplexumiconsensusreads_torch.runtime.stream import stream_call_consensus

if device == "cuda":
    from duplexumiconsensusreads_torch.kernels import build
    build.build_all()
gp, cp, _ = params_for("config5")
out = {"root": root}

def digest(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()

largest = {}
inner = pipeline.fused_pipeline
def keep(*args, **kw):
    if args[0].numel() > largest.get("size", -1):
        largest.update(size=args[0].numel(), args=args, kw=kw)
    return inner(*args, **kw)
pipeline.fused_pipeline = keep
try:
    t0 = time.monotonic()
    call_consensus_file(in_bam, os.path.join(td, "whole.bam"), gp, cp, capacity=2048,
                        device=device)
    out["whole_file_s"] = time.monotonic() - t0
finally:
    pipeline.fused_pipeline = inner
out["whole_file_sha256"] = digest(os.path.join(td, "whole.bam"))
from duplexumiconsensusreads_torch.telemetry import ledger, report
t0 = time.monotonic()
rep = stream_call_consensus(in_bam, os.path.join(td, "stream.bam"), gp, cp, capacity=2048,
                            chunk_reads=chunk_reads, device=device,
                            trace_path=os.path.join(td, "stream.jsonl"))
out["stream_s"] = time.monotonic() - t0
out["stream_dispatch_busy_s"] = rep.seconds["dispatch"]
out["stream_sha256"] = digest(os.path.join(td, "stream.bam"))
out["stream_wire_floor"] = ledger.wire_floor(
    report.load_trace(os.path.join(td, "stream.jsonl")))["frac"]
# the same stream twice more in this process: the third run is the
# steady state of a process that meets its classes again (a serve
# daemon's), where a checkout with CUDA graphs replays them
for i in range(2):
    t0 = time.monotonic()
    rep = stream_call_consensus(in_bam, os.path.join(td, "stream_again.bam"), gp, cp,
                                capacity=2048, chunk_reads=chunk_reads, device=device,
                                trace_path=os.path.join(td, "stream_again.jsonl"))
    out["stream_third_s"] = time.monotonic() - t0
    out["stream_third_dispatch_busy_s"] = rep.seconds["dispatch"]
if digest(os.path.join(td, "stream_again.bam")) != out["stream_sha256"]:
    out["stream_sha256"] = "the repeated stream's output differs"
out["stream_third_wire_floor"] = ledger.wire_floor(
    report.load_trace(os.path.join(td, "stream_again.jsonl")))["frac"]

if device == "cuda":
    args, kw = largest["args"], largest["kw"]
    out["class_shape"] = list(args[0].shape)
    seen = {}
    g_inner = pipeline.group_kernel
    def keep_g(*a, **k):
        seen["group"] = (a, k)
        return g_inner(*a, **k)
    pipeline.group_kernel = keep_g
    try:
        pipeline.fused_pipeline(*args, **kw)
    finally:
        pipeline.group_kernel = g_inner
    ga, gk = seen["group"]

    def device_ms(fn):
        fn()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    out["step_ms"] = device_ms(lambda: pipeline.fused_pipeline(*args, **kw))
    out["group_kernel_ms"] = device_ms(lambda: g_inner(*ga, **gk))
    name = ("directional_cluster" if hasattr(grouping, "directional_cluster")
            else "_directional_cluster")
    spans = []
    c_inner = getattr(grouping, name)
    def timed(*a, **k):
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        r = c_inner(*a, **k)
        ev[1].record()
        spans.append(ev)
        return r
    setattr(grouping, name, timed)
    try:
        for _ in range(reps):
            g_inner(*ga, **gk)
    finally:
        setattr(grouping, name, c_inner)
    torch.cuda.synchronize()
    out["cluster_function"] = name
    out["cluster_ms"] = sum(s.elapsed_time(e) for s, e in spans) / reps
    out["device"] = torch.cuda.get_device_name(0)

if os.environ.get("AB_MESH") == "1":
    from duplexumiconsensusreads_torch.bucketing import build_buckets, stack_buckets
    from duplexumiconsensusreads_torch.io import load_input
    from duplexumiconsensusreads_torch.parallel import mesh as mesh_mod
    from duplexumiconsensusreads_torch.parallel import sharded
    from duplexumiconsensusreads_torch.runtime.executor import partition_buckets

    cards = torch.cuda.device_count() if device == "cuda" else 0
    lanes = cards if cards >= 2 else 2
    if device == "cuda" and cards < 2:
        pool = mesh_mod.device_pool
        mesh_mod.device_pool = lambda device="cuda", devices=None: (
            [torch.device("cuda", 0)] * lanes
            if torch.device(device).type == "cuda" and not devices else pool(device, devices))
    out["mesh_lanes"] = lanes
    # an untimed all-lane call first: no timed run pays a card's first use
    call_consensus_file(in_bam, os.path.join(td, "warm.bam"), gp, cp, capacity=2048,
                        device=device, n_devices=lanes)
    for n in (1, lanes):
        path = os.path.join(td, f"whole{n}.bam")
        t0 = time.monotonic()
        call_consensus_file(in_bam, path, gp, cp, capacity=2048, device=device, n_devices=n)
        out[f"mesh_whole_s_{n}"] = time.monotonic() - t0
        out[f"mesh_whole_identical_{n}"] = digest(path) == out["whole_file_sha256"]
        # three runs at this lane count, the first and the third timed
        # (the lanes' classes are new at the first, replayed at the third)
        same = True
        for r in range(3):
            path = os.path.join(td, f"stream{n}_{r}.bam")
            t0 = time.monotonic()
            stream_call_consensus(in_bam, path, gp, cp, capacity=2048,
                                  chunk_reads=chunk_reads, device=device, n_devices=n)
            dt = time.monotonic() - t0
            if r != 1:
                out[f"mesh_stream{'_third' if r else ''}_s_{n}"] = dt
            same = same and digest(path) == out["stream_sha256"]
        out[f"mesh_stream_identical_{n}"] = same
    _, batch, _ = load_input(in_bam, duplex=True)
    buckets = build_buckets(batch, capacity=2048, grouping=gp)
    cb, spec = max(partition_buckets(buckets, gp, cp, device=device), key=lambda p: len(p[0]))
    cb = cb[:int(os.environ["AB_MESH_BUCKETS"])]
    out["mesh_class"] = [len(cb), 2048]

    def sync(m):
        for d in set(m.devices):
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def put_class(m, ss, keep=None):
        # the class on the mesh's lanes, as the checkout's dispatch puts
        # it: staged straight into the lanes' pinned buffers where it can
        if hasattr(sharded, "stage_lanes"):
            blocks = sharded.stage_lanes(cb, m, spec, streams=ss, keep=keep)
            return sharded.put_lanes(blocks, m, spec, streams=ss)
        stacked = stack_buckets(cb, multiple_of=m.n_data)
        if spec.packed_io:
            pipeline.pack_stacked(stacked, spec)
        return sharded.shard_stacked(stacked, m, spec, streams=ss, keep=keep)

    for n in (1, lanes, 1, lanes):
        m = mesh_mod.run_mesh(device, n)
        ss = sharded.lane_streams(m)
        args = put_class(m, ss)
        enq = []
        def step():
            t = time.perf_counter()
            sharded.presharded_pipeline(args, spec, m, streams=ss)
            enq.append(time.perf_counter() - t)
        # a checkout with CUDA graphs captures the class at its second
        # sight on a lane: both checkouts warm up twice
        step()
        step()
        sync(m)
        enq.clear()
        t0 = time.monotonic()
        for _ in range(reps):
            step()
        sync(m)
        out.setdefault(f"mesh_step_ms_{n}", []).append((time.monotonic() - t0) / reps * 1e3)
        # each lane's host enqueue: the lanes' call over the lane count
        out.setdefault(f"mesh_enqueue_ms_{n}", []).append(sum(enq) / len(enq) / n * 1e3)
        del args
    for n in (1, lanes):
        for k in ("step_ms", "enqueue_ms"):
            out[f"mesh_{k}_{n}"] = sum(out[f"mesh_{k}_{n}"]) / 2
    # the class staged at all lanes as the stream dispatches it, the host
    # time of each part (ms, median of the dispatches after two warm-ups):
    # stack, pack, staging and H2D, the step, the packed compaction and
    # D2H start
    import statistics
    from duplexumiconsensusreads_torch.runtime.executor import (
        PACKED_FETCH_KEYS, d2h_k_pad, fetch_outputs, pack_fetch_outputs, start_fetch)
    m = mesh_mod.run_mesh(device, lanes)
    ss = sharded.lane_streams(m)
    k_pad = d2h_k_pad(cb, spec, m.n_data)
    split = {"staging": [], "pipeline": [], "fetch": []}
    for rep in range(reps + 2):
        staging = [[] for _ in range(m.size)]
        t0 = time.perf_counter()
        args = put_class(m, ss, keep=staging)
        t1 = time.perf_counter()
        outs = sharded.presharded_pipeline(args, spec, m, streams=ss)
        t2 = time.perf_counter()
        packed = pack_fetch_outputs(outs, spec, k_pad, mesh=m, streams=ss)
        fetches = []
        for i, dev in enumerate(m.devices):
            with sharded.lane_context(dev, ss[i]):
                fetches.append(start_fetch(packed[i], keys=PACKED_FETCH_KEYS,
                                           staging=staging[i]))
        t3 = time.perf_counter()
        for f in fetches:
            fetch_outputs(f)
        del args, outs, packed, fetches, staging
        if rep >= 2:
            for part, dt in zip(split, (t1 - t0, t2 - t1, t3 - t2)):
                split[part].append(dt)
    for part, v in split.items():
        out[f"mesh_split_ms_{part}"] = statistics.median(v) * 1e3
print(json.dumps(out), flush=True)
"""

# the largest dispatch class of the input cut to this many buckets is
# the mesh's fused step (chip_smoke.py's MESH_STEP_BUCKETS)
MESH_STEP_BUCKETS = 512


def simulate(path: str, n_reads: int) -> None:
    from duplexumiconsensusreads_torch.io import simulated_bam
    from duplexumiconsensusreads_torch.simulate import SimConfig

    n_mol = n_reads // 9
    simulated_bam(SimConfig(n_molecules=n_mol, read_len=150, n_positions=max(8, n_mol // 48),
                            mean_family_size=4, umi_error=0.01, duplex=True, seed=7),
                  path=path, sort=True)


def run_turn(root: str, in_bam: str, device: str, chunk_reads: int, reps: int,
             mesh: bool = False) -> dict:
    with tempfile.TemporaryDirectory(prefix="ab_turn_") as td:
        env = dict(os.environ, AB_ROOT=root, AB_IN=in_bam, AB_TD=td, AB_DEVICE=device,
                   AB_CHUNK_READS=str(chunk_reads), AB_REPS=str(reps),
                   AB_MESH="1" if mesh else "0", AB_MESH_BUCKETS=str(MESH_STEP_BUCKETS))
        proc = subprocess.run([sys.executable, "-c", CHILD], capture_output=True, text=True,
                              cwd=root, env=env)
    if proc.returncode != 0:
        raise RuntimeError(f"the turn in {root} exited {proc.returncode}: {proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, help="root of the other checkout")
    ap.add_argument("--reads", type=int, default=600_000)
    ap.add_argument("--chunk-reads", type=int, default=150_000)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--mesh", action="store_true", help="also time one lane against all lanes")
    ap.add_argument("--pairs", type=int, default=2,
                    help="turn pairs: other, this, then this, other, and so on")
    ap.add_argument("--json", help="write the summary here too")
    a = ap.parse_args(argv)
    if a.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("ab_checkouts: no CUDA device (--device cpu checks the bytes only)",
                  file=sys.stderr)
            return 2
    this = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, this)
    other = os.path.abspath(a.other)
    if not os.path.isdir(os.path.join(other, "duplexumiconsensusreads_torch")):
        print(f"ab_checkouts: {other} holds no duplexumiconsensusreads_torch", file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory(prefix="ab_checkouts_") as td:
        in_bam = os.path.join(td, "in.bam")
        simulate(in_bam, a.reads)
        turns = []
        order = [(("other", other), ("this", this))[::1 - 2 * (i % 2)] for i in range(a.pairs)]
        for label, root in (turn for pair in order for turn in pair):
            row = {"checkout": label,
                   **run_turn(root, in_bam, a.device, a.chunk_reads, a.reps, a.mesh)}
            print(json.dumps(row), flush=True)
            turns.append(row)
    first = turns[0]
    identical = all(t[k] == first[k] for t in turns for k in ("whole_file_sha256",
                                                               "stream_sha256"))
    identical = identical and all(v for t in turns for k, v in t.items()
                                  if k.startswith("mesh_") and "_identical_" in k)
    summary = {"reads": a.reads, "chunk_reads": a.chunk_reads, "device": a.device,
               "outputs_identical": identical}
    keys = ("step_ms", "group_kernel_ms", "cluster_ms", "whole_file_s", "stream_s",
            "stream_wire_floor", "stream_third_s", "stream_third_wire_floor",
            "stream_dispatch_busy_s", "stream_third_dispatch_busy_s")
    if a.mesh:
        n = first["mesh_lanes"]
        summary["mesh_lanes"], summary["mesh_class"] = n, first["mesh_class"]
        keys += tuple(f"mesh_{k}_{i}" for k in ("whole_s", "stream_s", "stream_third_s",
                                                 "step_ms", "enqueue_ms")
                      for i in (1, n))
        keys += tuple(f"mesh_split_ms_{p}" for p in ("staging", "pipeline", "fetch"))
    for label in ("other", "this"):
        rows = [t for t in turns if t["checkout"] == label]
        summary[label] = {k: sum(r[k] for r in rows) / len(rows) for k in keys if k in rows[0]}
        summary[label]["cluster_function"] = rows[0].get("cluster_function")
        for k in ("whole_file_s", "stream_s", "stream_third_s"):
            summary[label][f"{k}_turns"] = [r[k] for r in rows]
        if a.mesh:
            for k in ("whole_s", "stream_s", "stream_third_s", "step_ms"):
                one, all_ = summary[label][f"mesh_{k}_1"], summary[label][f"mesh_{k}_{n}"]
                summary[label][f"mesh_{k}_scaling"] = one / all_
                # each turn's own one-lane over all-lane ratio
                summary[label][f"mesh_{k}_scaling_turns"] = [
                    r[f"mesh_{k}_1"] / r[f"mesh_{k}_{n}"] for r in rows]
    if a.device == "cuda":
        summary["device_name"] = first["device"]
        summary["class_shape"] = first["class_shape"]
    print(json.dumps(summary), flush=True)
    if a.json:
        with open(a.json, "w") as f:
            json.dump({"turns": turns, "summary": summary}, f, indent=1)
    return 0 if identical else 1


if __name__ == "__main__":
    sys.exit(main())
