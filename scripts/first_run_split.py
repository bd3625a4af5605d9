"""Split a fresh process's first streaming run into where its dispatches
wait, for one or more checkouts of the repository, on one device.

    python scripts/first_run_split.py ROOT [ROOT ...]
        [--reads 600000] [--chunk-reads 150000] [--rounds 2] [--device cuda]
        [--json OUT]

Each ROOT is the root of a checkout (this one, or an unpacked ``git
archive`` of another commit). The input is ``scripts/ab_checkouts.py``'s
(config5, read_len 150, family size 4, umi_error 0.01, seed 7,
``--reads`` reads), simulated once. Each turn is a fresh subprocess
that builds the checkout's kernels, runs the whole-file call once
(capacity 2048), as an ``ab_checkouts.py`` turn does before its stream,
and then the streaming call (``--chunk-reads`` chunks), timed with the
split below. ``--rounds`` rounds run every root once each, in turn, the
order reversed every other round.

The split is taken by wrapping the checkout's own functions and locks
from outside, so every checkout is measured the same way, whether or not
it has the locks (host seconds, summed over the transfer threads):

- ``slot_wait_s`` / ``slot_held_s``: blocked on, and holding, a class's
  stream-slot lock (the locks ``runtime/stream.py`` makes for its
  slots; none in a checkout without slots);
- ``lane_wait_s``: blocked on a graph lane's lock
  (``runtime/graphs.py``), ``capture_lock_wait_s`` on the lock that
  runs captures one at a time;
- ``step_s`` by mode (eager, captured, replayed) from
  ``graphs.run_step``, and ``unreplayed_step_s``: the eager and captured
  steps of the classes that never replay in the run; ``pipeline_s``: the
  lanes' step call (``presharded_pipeline``), in every checkout;
- ``stack_s``, ``pack_s``, ``stage_s``: ``stack_buckets``,
  ``pack_stacked`` and, where the checkout has it,
  ``sharded.stage_lanes`` (which calls the first two);
  ``put_s``: ``stacked_from_numpy`` (the copy into pinned memory and
  the H2D issue in a checkout that copies there, the H2D issue alone in
  one that staged the class before);
- ``fetch_s``: the packed compaction and the D2H start;
- ``dispatch_busy_s`` and ``stream_s`` (the report's dispatch seconds
  and the call's wall).

Prints one JSON line per turn and, last, the summary: each root's
median of every number over its turns.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile

CHILD = r"""
import collections, json, linecache, os, sys, threading, time
root, in_bam, td, device = (os.environ[k] for k in ("FR_ROOT", "FR_IN", "FR_TD", "FR_DEVICE"))
chunk_reads = int(os.environ["FR_CHUNK_READS"])
sys.path.insert(0, root)
import torch
from duplexumiconsensusreads_torch import bucketing, interop
from duplexumiconsensusreads_torch.cli.main import params_for
from duplexumiconsensusreads_torch.ops import pipeline
from duplexumiconsensusreads_torch.parallel import sharded
from duplexumiconsensusreads_torch.runtime import stream
from duplexumiconsensusreads_torch.runtime.executor import call_consensus_file
try:
    from duplexumiconsensusreads_torch.runtime import graphs
except ImportError:
    graphs = None

if device == "cuda":
    from duplexumiconsensusreads_torch.kernels import build
    build.build_all()
gp, cp, _ = params_for("config5")
call_consensus_file(in_bam, os.path.join(td, "whole.bam"), gp, cp, capacity=2048, device=device)
if device == "cuda":
    torch.cuda.synchronize()

acc = collections.defaultdict(float)
acc_lock = threading.Lock()
on = [False]

def add(k, v):
    if on[0]:
        with acc_lock:
            acc[k] += v

class TimedLock:
    def __init__(self, kind, inner=None):
        self.kind, self.inner, self.t = kind, inner or _real_lock(), None
    def acquire(self, blocking=True, timeout=-1):
        t0 = time.perf_counter()
        got = self.inner.acquire(False)
        if not got and blocking:
            got = self.inner.acquire(True, timeout)
            add(self.kind + "_wait_s", time.perf_counter() - t0)
            add(self.kind + "_contended", 1)
        if got:
            self.t = time.perf_counter()
            add(self.kind + "_taken", 1)
        return got
    def release(self):
        add(self.kind + "_held_s", time.perf_counter() - self.t)
        self.inner.release()
    def locked(self):
        return self.inner.locked()
    __enter__ = acquire
    def __exit__(self, *exc):
        self.release()

_real_lock = threading.Lock

class Threading:
    # the stream module's view of threading: its slot locks are timed
    def __getattr__(self, name):
        return getattr(threading, name)
    @staticmethod
    def Lock():
        f = sys._getframe(1)
        if "slots.append" in linecache.getline(f.f_code.co_filename, f.f_lineno):
            return TimedLock("slot")
        return _real_lock()

stream.threading = Threading()

def timed(mod, name, key):
    inner = getattr(mod, name, None)
    if inner is None:
        return
    def wrapper(*a, **k):
        t0 = time.perf_counter()
        try:
            return inner(*a, **k)
        finally:
            add(key, time.perf_counter() - t0)
    setattr(mod, name, wrapper)

timed(bucketing, "stack_buckets", "stack_s")
timed(stream, "pack_stacked", "pack_s")
timed(pipeline, "pack_stacked", "pack_s")
timed(sharded, "stage_lanes", "stage_s")
timed(interop, "stacked_from_numpy", "put_s")
timed(stream, "presharded_pipeline", "pipeline_s")
timed(stream, "pack_fetch_outputs", "fetch_s")
timed(stream, "start_fetch", "fetch_s")

steps = []
if graphs is not None:
    lane_init = graphs._Lane.__init__
    def init(self, *a, **k):
        lane_init(self, *a, **k)
        self.lock = TimedLock("lane", self.lock)
    graphs._Lane.__init__ = init
    graphs._CAPTURE_LOCK = TimedLock("capture_lock", graphs._CAPTURE_LOCK)
    run_step = graphs.run_step
    def step(args, spec, keys):
        t0 = time.perf_counter()
        out, mode = run_step(args, spec, keys)
        dt = time.perf_counter() - t0
        if on[0]:
            key = (spec, graphs.signature((args[k].shape, args[k].dtype) for k in keys))
            with acc_lock:
                steps.append((key, mode[0], dt))
        return out, mode
    graphs.run_step = step
    graphs.reset_counts()

on[0] = True
t0 = time.monotonic()
rep = stream.stream_call_consensus(
    in_bam, os.path.join(td, "stream.bam"), gp, cp, capacity=2048, chunk_reads=chunk_reads,
    device=device)
out = {"root": root, "stream_s": time.monotonic() - t0,
       "dispatch_busy_s": rep.seconds["dispatch"]}
on[0] = False
out.update(acc)
if graphs is not None:
    by_key = collections.defaultdict(list)
    for key, mode, dt in steps:
        by_key[key].append((mode, dt))
    for mode in ("eager", "captured", "replayed"):
        out[f"step_s_{mode}"] = sum(dt for _, m, dt in steps if m == mode)
        out[f"steps_{mode}"] = sum(1 for _, m, _ in steps if m == mode)
    out["classes"] = len(by_key)
    out["unreplayed_step_s"] = sum(dt for calls in by_key.values()
                                   if all(m != "replayed" for m, _ in calls)
                                   for _, dt in calls)
    c = graphs.read_counts()
    out["capture_s"] = c["step"]["capture_s"] + c["epilogue"]["capture_s"]
if device == "cuda":
    out["device"] = torch.cuda.get_device_name(0)
print(json.dumps(out), flush=True)
"""


def run_turn(root: str, in_bam: str, device: str, chunk_reads: int) -> dict:
    with tempfile.TemporaryDirectory(prefix="fr_turn_") as td:
        env = dict(os.environ, FR_ROOT=root, FR_IN=in_bam, FR_TD=td, FR_DEVICE=device,
                   FR_CHUNK_READS=str(chunk_reads))
        proc = subprocess.run([sys.executable, "-c", CHILD], capture_output=True, text=True,
                              cwd=root, env=env)
    if proc.returncode != 0:
        raise RuntimeError(f"the turn in {root} exited {proc.returncode}: {proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="+", help="checkout roots")
    ap.add_argument("--reads", type=int, default=600_000)
    ap.add_argument("--chunk-reads", type=int, default=150_000)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--json", help="write the turns and the summary here too")
    a = ap.parse_args(argv)
    this = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, this)
    from ab_checkouts import simulate

    roots = [os.path.abspath(r) for r in a.roots]
    turns = []
    with tempfile.TemporaryDirectory(prefix="first_run_split_") as td:
        in_bam = os.path.join(td, "in.bam")
        simulate(in_bam, a.reads)
        for r in range(a.rounds):
            for root in roots[:: 1 - 2 * (r % 2)]:
                row = run_turn(root, in_bam, a.device, a.chunk_reads)
                print(json.dumps(row), flush=True)
                turns.append(row)
    summary = {"reads": a.reads, "chunk_reads": a.chunk_reads, "device": a.device}
    for root in roots:
        rows = [t for t in turns if t["root"] == root]
        keys = sorted({k for t in rows for k, v in t.items() if isinstance(v, (int, float))})
        summary[root] = {k: statistics.median(t.get(k, 0) for t in rows) for k in keys}
        summary[root]["stream_s_turns"] = [t["stream_s"] for t in rows]
    if turns and "device" in turns[0]:
        summary["device_name"] = turns[0]["device"]
    print(json.dumps(summary), flush=True)
    if a.json:
        with open(a.json, "w") as f:
            json.dump({"turns": turns, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
