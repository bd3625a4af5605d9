#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--mesh-only]

``--mesh-only`` runs the env and build phases and the mesh phase alone
(for a machine with several cards: every card a data lane), then the
entry module's ``dryrun_multichip`` over every card. With no
arguments it drives the port's paths on the card — the config5 whole-file call
(adjacency grouping, paired duplex, per-cycle error model) through
``call_consensus_file`` on a simulated ~600k-read BAM, one dispatch of
the bench's size; the same call with per-base tags and a BAI; the
config5 streaming call through ``stream_call_consensus`` on the bench's
~2M-read e2e workload in 500k-read chunks, also under the bucket
ladder, with its captures read back by the port's analysers and tools;
the service path on that input (follow mode, the serve daemon with a
takeover, scatter-gather shards, the fleet recorder over their spools);
the multi-host call (two hosts on one TCPStore); the mesh (every card
a data lane, or two lanes on two streams of one card); the cycle
model's counts fit; the CLI workflow (simulate, call, filter, validate, group) on the
whole-file input; the UmiGrouper/ConsensusCaller operators; and the
ssc-method race — reading through the native BAM loader and deflating
through it, and holds every hand-written kernel of those paths against
its plain PyTorch version on the card. Phases, each printed as one JSON
line:

  env     the card (nvidia-smi name + power limit), torch and CUDA
  build   nvcc of every csrc/ source and g++ of the native BAM loader,
          all started together (and whether zlib.h was found)
  e2e     simulate -> call_consensus_file(device="cuda"); per-stage
          seconds, peak device memory, kernel launch counts (each must
          be > 0), device spans of the pipeline calls, the reader and
          deflate codecs that ran (native), and a small input called
          on the card and on the CPU (plain versions, the CPU's own
          reduction) that must agree record by record, bases except at
          counted ties
  reader  the e2e input through the native and the portable
          load_input: identical ReadBatch arrays, each one's seconds
  per_base  the e2e call again with per_base_tags and write_index:
          every record carries cd/ce, segment_gemm ran at C = 9L+1,
          the .bai exists and a ``view`` of one region through the
          port's CLI equals that region of the full output; then card
          against CPU on a small input (cd equal, ce equal except at
          counted ties)
  stages  the largest class's fused pipeline once more, warm, with the
          device span of each stage function it calls (group_kernel's
          directional_cluster among them)
  sync_debug  that class's group_kernel (adjacency, the whole-file
          shape) under torch.cuda.set_sync_debug_mode("error"): it runs
          through, and with the plain directional cluster patched in it
          raises; then fused_pipeline under "warn", with every implicit
          sync that remains counted by file:line
  graphs  runtime/graphs.py at the main class and a 64-bucket class of
          it, every output bit for bit against the eager step: eager,
          captured, replayed; a replay on other inputs (the buckets
          reversed) and back; the two classes interleaved on one
          lane; one class replayed on two streams at once; the
          packed epilogue at two k_pad values (eager, captured,
          replayed each). Launches equal one eager step's per call
          (the replays counted through the capture's tally), 0
          implicit syncs at both captured shapes, capture seconds,
          replay enqueue ms, each lane's pool bytes and the LRU bound
  cluster the directional cluster kernel vs its plain version at
          tolerance 0 (seed, mid_of_slot, n_mol): at the stages rerun's
          slot table and on synthetic tables (position groups, groups
          within Hamming 1, chains up and down, one group past the
          kernel's list at u 512 and 2048, unsorted positions, two-,
          three- and four-word UMIs, count ratio 0, u 16384 with the
          table in global memory, and groups of exactly 31, 32, 33 and
          512 slots at the main class's 280 buckets of 512); the main
          table's group sizes and in-group pairs a bucket, and the
          kernel's occupancy (blocks an SM, one wave, or it fails);
          group_kernel's peak device memory above its inputs, kernel
          and plain, against one (N, U, U) bool grid; the kernel, plain
          and bound ms
  kernel  each kernel vs its plain version on random inputs and on the
          main path's real inputs (those of the stages rerun, whose ids
          must equal the e2e run's), and at the per-base shape (the
          per_base call's full ssc pass, rerun); times of the kernel,
          the plain version and one library call, and the byte bound
  parity  >= 8 real buckets through the fused pipeline with the kernel
          and with the plain reduction: integer outputs identical,
          bases identical except at ties, quals within 1
  fit_counts  the largest class's fused step with the cycle model fit
          by gather and by counts (PipelineSpec.fit_impl, DUT_FIT_IMPL)
          in turns gather, counts, counts, gather: cycle caps and every
          output identical, each turn's step ms; then the counts pass's
          segment_gemm launch (the fit columns plus 4L count columns,
          C = 8L+1) against its plain version at tolerance 0, with the
          kernel, plain, index_add_ and bound ms
  stream  the streaming call at full width (the bench's e2e workload
          and settings: capacity 2048, 500k-read chunks, 4 in flight,
          2 drain workers, prefetch depth 2, every wire rung on auto,
          ingest overlap): wall, reads/s, the busy-time table, wire
          bytes and each class's H2D/D2H rung (from the trace), peak
          device memory, kernel launches (> 0), the device span of
          every fused_pipeline call and their union's share of the
          wall, the native reader and every shard's deflate codec;
          then a sum-check of the trace's spans against the report's
          seconds
  stream_turns  the stream cell again in two turns, plain directional
          cluster then kernel: each turn's reads/s, dispatch and device_wait_fetch busy
          seconds and ledger.wire_floor, with bytes identical to the
          stream phase's
  live    follow mode: a paced writer appends the stream cell's input
          (whole BGZF blocks, over LIVE_APPEND_S) while the port follows
          it on the card with a snapshot per committed chunk; the output
          equals the stream phase's bytes, every snapshot is an indexed
          BAM whose bytes prefix them; the time to the first snapshot and
          the lag from the last append to the published output
  serve   an in-process ConsensusService on the card runs a job on the
          stream cell's input and two smaller ones under a chunk budget
          that preempts the large job; each output equals its one-shot
          stream with serve_provenance; per-job wall, queue wait and
          one-shot wall. Then daemon A (a subprocess) is SIGKILLed after
          its first committed chunk and daemon B --once takes the job
          over: bytes equal, token >= 2, the port's serve_report reads
          n_takeovers 1 and n_fenced 0; the takeover gap
  shard   ``call --submit --shards 4 --write-index`` of the stream cell's
          input run by two daemon subprocesses: ``call --wait`` exits 0,
          the merged BAM and .bai equal the unsharded one-shot run's; the
          sharded and unsharded walls
  fleet   the port's tools.fleet_report over the serve, takeover and
          shard spools those phases leave: each exits 0 with ok true,
          every job's segments plus gaps tile its life exactly, one
          takeover on the takeover spool, one split and one merge on the
          shard spool, the --prom and --chrome files written; a copy of
          the takeover spool with daemon B's job_started dropped exits
          1. e2e p95 and the largest takeover gap. Launches no kernel
  multihost  two host subprocesses of ``call --n-hosts 2 --host-id i
          --config config3`` on the serve phase's 250k-read input in
          50k-read chunks, concurrently on this card over a localhost
          TCPStore (MASTER_ADDR/MASTER_PORT/WORLD_SIZE/RANK), with no
          .dlix at the start: each reports a 2-process runtime and
          launches both kernels (each host writes its counts at exit),
          one .dlix is written, and the concatenation equals a one-host
          config3 stream record by record (names aside: each carries its
          host's tag and chunk numbering); each host's wall, the index
          election's, the one-host wall. Then, the input indexed every
          25k records, host 1 SIGKILLed after a committed chunk and
          resumed alone skips exactly its manifest's chunks, and the
          concatenation is unchanged
  mesh    the mesh path (parallel/mesh.py, parallel/sharded.py): every
          visible card as a data lane, or, on a one-card machine, two
          lanes on two CUDA streams of cuda:0 (printed as cards 1,
          lanes 2). The serve phase's 250k-read config5 input in
          50k-read chunks streamed at 1 lane and at all lanes, d2h
          packed auto and off: bytes identical; the lanes run's capture
          passes wirestat with its dev-N lanes and mesh sum-check; both
          kernels launch on every lane (counted per lane), each held
          against its plain version at tolerance 0 on every lane's last
          block, and group_kernel runs through on every lane's block
          under set_sync_debug_mode("error"). Then call_batch on the
          input under config3 at 1 lane, at all data lanes (identical)
          and at (lanes/2, 2) cycle shards (the JAX package's bar for a
          partitioned run; whether identical is reported). Walls, and
          e2e_mesh_scaling: the 1-lane over the all-lane stream walls,
          each summed over the two d2h rungs, run in turns 1, N, N, 1.
          Then the device side alone: a config5 class of 512 buckets x
          2048 reads (cut from the stream cell's input) resident on
          the lanes, one fused step at 1 lane and at all lanes in turns
          (compute_step_ms, compute_scaling)
  chaos   the stream's fault matrix on the card (the serve phase's
          250k-read config5 input in 50k-read chunks): fault-free once,
          one seeded transient at each of the 11 stream sites (ingest.read
          to finalise.write), the seeded 8-fault plan, and kills at
          dispatch.pack:2 and fetch.unpack:2 each followed by a resume.
          Every output byte-identical to the fault-free run, both kernels
          launched in every run, and torch.cuda.memory_allocated() after
          each kill-and-resume pair back within one chunk's footprint of
          where it started, and after every run from the third on within
          one chunk's footprint of the second run's (the first two
          capture the fault-free path's graphs); per run the wall, n_fired, n_retries, launches, allocated bytes
          and the graphs' static and pool bytes
  stream_small_reference  a small paired config5 input streamed on the
          card and on the CPU (plain versions) must agree record by
          record, with per-base tags and a BAI too; on the card,
          packed auto/off, d2h_packed auto/off, drain_workers 1/2 and
          ingest_overlap on/off must give byte-identical files, and
          DUT_NO_NATIVE=1 (the portable codec) the same records
  workflow  the fgbio-style chain through the port's CLI
          (``cli.main.main``) on the card at full width: ``simulate``
          with every e2e SimConfig value as a flag (bytes equal to the
          e2e input), ``call`` with a JSON ``--config-file`` setting
          every config5 parameter plus per-base tags and an index,
          ``filter``, ``validate`` of both outputs (error rate below a
          tenth of the simulator's base error), ``group --duplex``
          (batched group_kernel launches, fewer than its buckets); each
          step's seconds. Then on the small input: ``group`` and ``call``
          (config3) on the card against ``--backend cpu`` (the same
          read partition; records under compare_records), and ``stats``
  operators  UmiGrouper + ConsensusCaller, cuda backend against the cpu
          (oracle) backend on a small duplex batch with the cycle model:
          ids identical, consensus at the parity bar
  stream_resume  a run killed at a checkpoint mark after one committed
          chunk, resumed, gives the uninterrupted run's bytes
  ladder  the stream phase's input and settings streamed again with
          bucket_ladder="auto" and "256,512,2048": per run the wall,
          the tuner verdict (ladder, predicted and off fill factors,
          predicted speedup), the measured fill (n_rows_real /
          n_rows_padded) and the segment_gemm launch shapes, which hold
          every explicit rung; records equal to the ladder-off output
          in every field but seq/qual, whose differing cycles are
          counted (config5's cycle model is fit per bucket, in the JAX
          package too). Then, under the model-free duplex config on the
          serve phase's 250k-read input in 50k-read chunks, ladder
          off, auto and explicit give identical bytes, and a run killed
          at a checkpoint mark under "auto", resumed under the explicit
          ladder, gives them too
  capture the port's analysers on the stream and ladder captures: the
          time, byte, output and device sum-checks pass; the devstat
          per-class table (MFU against the resolved peak entry, which
          must be an h100 one; intensity; roofline verdict); the wire
          floor fraction and the measured H2D/D2H bandwidth; each tool's
          main exits 0 on every capture and 1 on its tampered copy
  kernel_rungs  segment_gemm against its plain version (tolerance 0)
          at each explicit rung's largest launch of the ladder run,
          with the kernel, plain, library and bound ms
  entry   the port's entry points (duplexumiconsensusreads_torch/entry.py):
          ``entry()``'s fused step on the card against
          ``entry(device="cpu")`` at the parity bar, each kernel of the
          step against its plain version at the step's shapes (tolerance
          0); then ``dryrun_multichip(2)`` on two lanes of cuda:0 (every
          card a lane on a machine with two or more): the sharded call
          set, the packed-io identity, (1, 2) cycle shards, the stream at
          2 lanes and 1 lane byte-identical, the MULTICHIP_BALANCE record
  features  each feature path of the JAX package through
          ``call_consensus_file`` on the card and on the CPU (plain
          versions) on one seeded input at read_len 150 and the
          configuration's capacity (FEATURE_PATHS): exact and adjacency
          single strand (configs 1-2), cluster duplex with a position of
          > 3 x capacity reads (host-preclustered) beside positions the
          card groups at count ratio 0, config4 at capacity 4096 with
          such a position and one family past the capacity (a jumbo
          pow2 bucket), --ref-projected on indel reads, mate-aware on
          paired mates, and ``filter --min-base-depth --max-n-frac``
          of config5's per-base output from each side. One line per
          path: the records card against CPU under compare_records
          (ties counted by kind), the kernels' launches (exact grouping
          launches no directional_cluster), the bucket layout, and
          segment_gemm at the largest class and the widest bucket and
          directional_cluster at the largest slot table against their
          plain versions (tolerance 0)
  race    race_ssc_methods() on the card at its defaults (22k
          molecules, L 150, capacity 2048) with blockseg T 64/128/256:
          step seconds and reads/s per method and the winner; then on
          the same buckets every method's fused-pipeline outputs
          against segment_gemm's (integers identical, bases identical
          except at counted ties, quals within 1 per strand; runsum
          within the JAX package's runsum tolerance), and blockseg run
          twice gives identical bytes
  bench   the port's bench (``benchmark.main(device="cuda")``, what
          ``python -m duplexumiconsensusreads_torch bench`` runs) with
          its legs cut to fit: the compute leg at its default size,
          per_config at its default, the tuner leg, the wire probe, the
          e2e leg on the stream phase's input (reused from the bench's
          cache), the packed / d2h / ingest-overlap A/B legs at one
          chunk, the serve_n_jobs leg (two jobs), the four fleet legs
          (serve_fleet with a takeover and its stitch, serve_defense,
          serve_shard, serve_xhost: in-process daemons on the card; their
          launches counted apart as the "fleet" path) and the live_follow
          leg at the serve phase's small-job size, and the CPU e2e
          denominator at one chunk, one rep; then
          ``tools.profile_components`` and ``tools.profile_phases`` at
          BENCH_PROF_READS. Its compact and full result lines, checked:
          value > 0, peak entry h100-sxm-f32, five per_config rows, the
          e2e, A/B, serve, fleet, live and tuner keys (serve_fleet_stitch_ok
          true), the wire probe's MB/s, no ``*_skipped`` leg, the mesh
          A/B at every card (DUT_BENCH_MESH; ``e2e_mesh_error`` on one
          card, ``e2e_mesh_scaling`` on several), no other ``*_error``
          key, a consensus error
          rate below a tenth of the simulator's base error
  kernel_bench  the bench phase's largest segment_gemm launch at each
          (rows, columns, f_max): the kernel against its plain version
          (tolerance 0), and the kernel, plain, index_add_ and bound ms

Every path (whole_file, stream, per_base, workflow, operators, live,
serve, shard, multihost, mesh, ladder, race, bench, fleet, fit_counts,
chaos, entry, dryrun, features) must launch both kernels of the main
path (each feature path those it runs), and the mesh path on every
lane: segment_gemm and grouping's directional
cluster (directional_cluster); the serve, shard and multihost paths
count the daemon and host subprocesses' launches too (each writes its
counts at exit). Each path's steps and packed epilogues by how they
ran (eager, captured, replayed; runtime/graphs.py) and the distinct
step classes it met are printed in a ``graphs_paths`` line, with each
path's graph pools, the smoke's process and each subprocess apart:
each one's peak on one card, which may not pass one process's budget
(graphs.MAX_DEVICE_POOL_BYTES), and the least free share of the card a
capture left. A kernel wrapper called inside a capture is kept by the
phases' keepers as an eager call is (see :func:`capturing`), so the
kernels are held at the shapes the graphs run them at. Then the nvidia-smi line, the ``kernels``
JSON line (one row per kernel with its launches per path and its
mesh path's launches per lane; under
segment_gemm a ``rung_shapes`` sub-row with the kernel, plain,
library and bound ms at each explicit ladder rung's largest launch,
a ``bench_shapes`` sub-row with the same at the bench phase's
largest launch of each (rows, columns, f_max) it gave the kernel, and
a ``fit_counts_shape`` sub-row at the counts fit's width),
and last
``{"ok": true, "device": {...}}``. Any failed phase raises and exits
non-zero; with no CUDA device, or without the package beside this
file, it exits non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# the main path's input: the bench's one-dispatch size (~600k reads of
# 150 cycles, ~9 reads per duplex molecule)
N_READS = 600_000
CAPACITY = 2048
# the streaming phase: the bench's e2e leg (~8 reads per molecule), at
# least four 500k-read chunks so the prefetch and drain windows overlap
STREAM_READS = 2_000_000
STREAM_CHUNK_READS = 500_000
# a duplex strand call at an evidence tie has qual <= 3 (err >= 0.5); a
# flip there moves the duplex qual between qa+qb and |qa-qb| (see
# compare_records)
TIE_QUAL = 3
# reads of the profile tools' workload in the bench phase (their
# defaults are the compute leg's ~600k)
BENCH_PROF_READS = 200_000
# the explicit ladder of the ladder phase (auto is the other run)
LADDER = "256,512,2048"
# the JAX package's runsum tolerance at the pipeline level
# (tests/test_perf_kernels.py): bases off on under 1e-3 of cycles,
# quals off on under 10 % with a largest gap of 15
RUNSUM_BASE_FRAC, RUNSUM_QUAL_FRAC, RUNSUM_QUAL_GAP = 1e-3, 0.10, 15
# the live phase: the writer appends the stream cell's input over this
# many seconds, one write of whole BGZF blocks every LIVE_WRITE_S
LIVE_APPEND_S, LIVE_WRITE_S = 8.0, 0.01
# the serve phase: the jobs' config (the stream cell's, as call flags),
# the chunk budget that preempts the large job for the two small ones,
# and the small jobs' inputs (the bench's serve/live leg size, so the
# bench phase finds them in its cache)
# (with an index: the shard phase's job, submitted through the CLI,
# has the same @PG line and so reuses the large job's reference)
SERVE_CONFIG = dict(grouping="adjacency", mode="duplex", error_model="cycle",
                    min_duplex_reads=1, capacity=2048, chunk_reads=500_000, max_inflight=4,
                    drain_workers=2, prefetch_depth=2, packed="auto", ingest_overlap="auto",
                    write_index=True)
SERVE_CHUNK_BUDGET = 4
# the takeover job: the larger small input in chunks small enough that
# the kill lands between commits
TAKEOVER_CHUNK_READS = 50_000
SERVE_SMALL_READS = (125_000, 250_000)
SERVE_DAEMON_TIMEOUT_S = 300
# the shard phase: one job of the stream cell's input split four ways
SHARDS = 4
# the multihost phase's kill and resume: its input (the serve phase's
# 250k reads) indexed every 25k records, so each host's range spans
# several of its 50k-read chunks and the kill lands between commits
RESUME_INDEX_EVERY = 25_000
# the mesh phase's device-side step: a class of this many buckets (cut
# from the largest class of the stream cell's input; of a 1M-read input
# under --mesh-only), reps per timing, in turns 1, N, 1, N
MESH_STEP_BUCKETS = 512
MESH_STEP_READS = 1_000_000
MESH_STEP_REPS = 10
# staged dispatches of that class whose host time the mesh phase splits
MESH_SPLIT_REPS = 5
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
F32_FLOPS = 67e12  # H100 SXM f32 rate outside the tensor cores (data sheet)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}, sort_keys=True), flush=True)


# the kernels every main path must launch: the ssc reduction and
# grouping's directional cluster
PATH_KERNELS = ("segment_gemm", "directional_cluster")


def capturing() -> bool:
    """Whether this thread's current stream is capturing a CUDA graph
    (runtime/graphs.py). A wrapper called there keeps its arguments all
    the same (a replay never calls it): they are tensors of the graph's
    pool, which the capture's replay writes before the step returns,
    and which a kept reference keeps from any other allocation, so the
    kernel's inputs of the graph's last replay are what a later check
    reads. It records no events, which a capture would take in."""
    import torch

    return torch.cuda.is_current_stream_capturing()


# each path's graph counts ({kind: {mode: calls}}, runtime/graphs.py),
# read with its launches (read_launches), its subprocesses' added
# (note_child_graphs)
GRAPH_PATHS: dict = {}


def kernel_wrappers() -> dict:
    """{kernel name: its wrapper}, each wrapper carrying a ``launches``
    count."""
    from duplexumiconsensusreads_torch.kernels import cluster_fixpoint, segment_gemm

    return {"segment_gemm": segment_gemm.segment_gemm,
            "directional_cluster": cluster_fixpoint.directional_cluster}


def path_launched(counts: dict) -> bool:
    """Whether every kernel of the main path launched at least once."""
    return min(counts.get(k, 0) for k in PATH_KERNELS) > 0


def reset_launches() -> None:
    from duplexumiconsensusreads_torch.runtime import graphs, pinned, stream

    for fn in kernel_wrappers().values():
        fn.launches = 0
        fn.stream_launches = {}
    graphs.reset_counts()
    stream.reset_dispatch_stats()
    _WRITES0[0] = pinned.stats()["writes"]


def graph_modes(counts: dict) -> dict:
    """{kind: {mode: calls}} of a graphs.read_counts() result, with the
    distinct step classes it met (``classes``) and the lanes dropped to
    keep the pools in their budget (``lanes_dropped``)."""
    from duplexumiconsensusreads_torch.runtime import graphs

    return {**{k: {m: counts[k][m] for m in graphs.MODES} for k in graphs.KINDS},
            "classes": counts["classes"], "lanes_dropped": counts["lanes_dropped"]}


def add_graph_modes(path: str, modes: dict) -> None:
    """Add a run's graph counts to GRAPH_PATHS[path]."""
    acc = GRAPH_PATHS.setdefault(path, {})
    for k, per in modes.items():
        if isinstance(per, dict):
            sub = acc.setdefault(k, dict.fromkeys(per, 0))
            for m, n in per.items():
                sub[m] += n
        else:
            acc[k] = acc.get(k, 0) + per


# each path's graph pools, the smoke's process first and then each of
# its subprocesses: {path: {"processes": n, "pool_peak_bytes": [each
# one's peak on one card], "card_free_min": the least free share of the
# card a capture left}}
PATH_POOLS: dict = {}


def check_pools(path: str, counts: dict) -> None:
    """Note a process's graph pools (a graphs.read_counts() result) in
    PATH_POOLS[path]; raise if they held more than one process's budget
    on one card (runtime/graphs.py: MAX_DEVICE_POOL_BYTES)."""
    from duplexumiconsensusreads_torch.runtime import graphs

    if counts["pool_peak_bytes"] > graphs.MAX_DEVICE_POOL_BYTES:
        raise AssertionError(f"{path}: a process's graph pools held {counts['pool_peak_bytes']} "
                             f"bytes (budget {graphs.MAX_DEVICE_POOL_BYTES})")
    acc = PATH_POOLS.setdefault(path, {"processes": 0, "pool_peak_bytes": [],
                                       "card_free_min": 1.0})
    acc["processes"] += 1
    acc["pool_peak_bytes"].append(counts["pool_peak_bytes"])
    acc["card_free_min"] = min(acc["card_free_min"], counts["card_free_min"])


def note_child_graphs(path: str, counts_path: str) -> None:
    """A daemon or host subprocess's graph counts (written beside its
    launch counts) into GRAPH_PATHS[path], and its pools into
    PATH_POOLS[path] (check_pools)."""
    with open(counts_path + ".graphs") as f:
        got = json.load(f)
    check_pools(path, got.pop("pools"))
    add_graph_modes(path, got)


# each in-process path's streaming dispatches since reset_launches()
# (runtime/stream.py:dispatch_stats): host ms a lane spent staging its
# block, a dispatch spent waiting for its class's slot and a lane holding
# it, the ms a dispatch's lanes waited for a graph lane's lock, and the
# lane blocks written into pinned memory per lane dispatch (one: the
# stage; on the packed rungs each 8 buckets are stacked into a host
# temporary and packed from it into the pinned buffers)
PATH_DISPATCH: dict = {}
_WRITES0 = [0]


def dispatch_split(stats: dict, lane_wait_s: float, writes: int) -> dict:
    n, lanes = max(stats["dispatches"], 1), max(stats["lanes"], 1)
    return {"dispatches": stats["dispatches"], "lanes": stats["lanes"],
            "stage_ms_per_lane": round(stats["stage_s"] / lanes * 1e3, 3),
            "slot_wait_ms_per_dispatch": round(stats["slot_wait_s"] / n * 1e3, 3),
            "slot_held_ms_per_lane": round(stats["slot_held_s"] / lanes * 1e3, 3),
            "lane_wait_ms_per_dispatch": round(lane_wait_s / n * 1e3, 3),
            "pinned_writes_per_lane": round(writes / lanes, 3)}


def read_launches(path: str) -> dict:
    """Each kernel's launches since reset_launches(); raises if the path
    launched one of PATH_KERNELS no time. The graph counts since then
    are added to GRAPH_PATHS[path], its streaming dispatches' split to
    PATH_DISPATCH[path]."""
    from duplexumiconsensusreads_torch.runtime import graphs, pinned, stream

    counts = graphs.read_counts()
    add_graph_modes(path, graph_modes(counts))
    check_pools(path, counts)
    ds = stream.dispatch_stats()
    if ds["dispatches"]:
        PATH_DISPATCH[path] = dispatch_split(ds, counts["lane_wait_s"],
                                             pinned.stats()["writes"] - _WRITES0[0])
    got = {name: fn.launches for name, fn in kernel_wrappers().items()}
    missing = [name for name in PATH_KERNELS if got[name] == 0]
    if missing:
        raise AssertionError(f"the {path} path launched {missing} no time")
    return got


@contextlib.contextmanager
def environ(**knobs):
    """``os.environ`` with ``knobs`` set, restored after."""
    old = {k: os.environ.get(k) for k in knobs}
    os.environ.update(knobs)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def read_bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def cuda_ms(fn, reps: int, queue_ahead: bool = False) -> float:
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events,
    after one warm-up call). With ``queue_ahead`` the card first spins
    (``torch.cuda._sleep``) for ten times the host time of the calls,
    so the host has queued them all before the first one runs: a call
    whose host work outlasts its kernel is then timed by the device
    alone."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if queue_ahead:
        t0 = time.perf_counter()
        fn()
        host_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        torch.cuda._sleep(int(10 * reps * host_s * 2e9))  # cycles, at up to 2 GHz
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class Capture:
    """Wraps a function in a module namespace and keeps references to
    the arguments of its call with the largest first tensor (the main
    path's biggest dispatch class; ``size`` measures the arguments
    otherwise): all of them, or only those at the indices ``keep``.
    Each call's device span (CUDA events around it)
    is kept too."""

    def __init__(self, module, name: str, keep: tuple | None = None, size=None):
        self.module, self.name, self.keep = module, name, keep
        self.measure = size or (lambda args: args[0].numel())
        self.inner = getattr(module, name)
        self.args = None
        self.size = -1
        self.shapes = []
        self.events = []

    def __enter__(self):
        import torch

        def wrapped(*args, **kwargs):
            self.shapes.append(tuple(args[0].shape))
            if self.measure(args) > self.size:
                self.size = self.measure(args)
                keep = range(len(args)) if self.keep is None else self.keep
                self.args = ([args[i] if i in keep else None for i in range(len(args))], kwargs)
            if capturing():
                return self.inner(*args, **kwargs)
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = self.inner(*args, **kwargs)
            ev[1].record()
            self.events.append(ev)
            return out

        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.inner)

    def span_ms(self) -> list[float]:
        """Device time from the start to the end of each call (idle gaps
        inside a call included)."""
        import torch

        torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self.events]


def per_base_tags(aux: bytes) -> tuple[bytes, dict]:
    """(aux without cd/ce, {b"cd": array, b"ce": array}) of one record."""
    import numpy as np

    from duplexumiconsensusreads_torch.io.bam import iter_aux_fields

    rest, arrays = bytearray(), {}
    for start, tag, typ, vs, end in iter_aux_fields(aux):
        if tag in (b"cd", b"ce") and typ == b"B":
            dt = {b"C": "u1", b"S": "<u2", b"I": "<u4", b"c": "i1", b"s": "<i2",
                  b"i": "<i4"}[aux[vs:vs + 1]]
            cnt = int.from_bytes(aux[vs + 1:vs + 5], "little")
            arrays[tag] = np.frombuffer(aux, dt, cnt, vs + 5).astype(np.int64)
        else:
            rest += aux[start:end]
    return bytes(rest), arrays


def tie_kinds(sa, sb, qa, qb, qual_tol: int, duplex: bool) -> dict:
    """The cycles where two consensus calls of one input may differ at
    the parity bar, by kind ({name: bool mask}; ROADMAP Faults 4 and
    20). Single strand, ``evidence``: a strand consensus that ties
    between two bases (err >= 0.5, so both quals <= TIE_QUAL) may call
    either. Duplex, the merge of two strand calls each within the bar:
      - ``qual_move`` (Faults 4): a strand tie flips a strand base, and
        the duplex base stays while its qual moves by at most
        2 * TIE_QUAL + qual_tol;
      - ``n_call`` (Faults 4 and 20): N at NO_CALL_QUAL (2) on one side,
        a base at 2 on the other: the strands disagree, and their quals
        are equal on one side only, from a strand tie or from strand
        quals one apart at the Phred floor;
      - ``strand_qual_flip`` (Faults 20): two different bases, both at
        2: the strands disagree and their quals, each one apart between
        the sides, cross, so each side keeps another strand's base."""
    import numpy as np

    diff = sa != sb
    if not duplex:
        return {"evidence": diff & (qa <= TIE_QUAL) & (qb <= TIE_QUAL)}
    dq = np.abs(qa - qb)
    at_floor = diff & (qa == 2) & (qb == 2)
    one_n = (sa == 4) | (sb == 4)
    return {"qual_move": ~diff & (dq > qual_tol) & (dq <= 2 * TIE_QUAL + qual_tol),
            "n_call": at_floor & one_n, "strand_qual_flip": at_floor & ~one_n}


def compare_records(a, b, qual_tol: int, duplex_ties: bool = False,
                    per_base: bool = False, ss_ties: bool = False) -> dict:
    """Record-by-record agreement of two consensus BAM record sets:
    everything identical but the quals, which agree within
    ``qual_tol``. With ``duplex_ties`` (or ``ss_ties`` for single-strand
    records) the parity bar's ties are allowed too, each kind of
    :func:`tie_kinds`: a strand evidence tie (Faults 4), and strand
    quals one apart at the Phred floor that move a duplex call between
    N and a base or between the two strands' bases (Faults 20). Such
    cycles are counted, by kind, and must stay under 1 in 10,000 (at
    the smoke's input sizes). With ``per_base``, every record
    carries cd/ce: cd (an integer depth) must be identical, ce (reads
    disagreeing with the call) may differ only at those tie cycles, and
    its differing cycles are counted."""
    import numpy as np

    if len(a) != len(b):
        raise AssertionError(f"record counts differ: {len(a)} vs {len(b)}")
    for f in ("names", "flags", "ref_id", "pos", "lengths"):
        if not np.array_equal(np.asarray(getattr(a, f)), np.asarray(getattr(b, f))):
            raise AssertionError(f"consensus records differ in {f}")
    pa = [per_base_tags(x) for x in a.aux_raw] if per_base else None
    pb = [per_base_tags(x) for x in b.aux_raw] if per_base else None
    if per_base:
        if [x[0] for x in pa] != [x[0] for x in pb]:
            raise AssertionError("consensus records differ in their aux tags")
        if any(set(x[1]) != {b"cd", b"ce"} for x in pa + pb):
            raise AssertionError("a consensus record lacks its cd/ce tags")
    elif list(a.aux_raw) != list(b.aux_raw):
        raise AssertionError("consensus records differ in their aux tags")
    sa, sb = np.asarray(a.seq), np.asarray(b.seq)
    qa, qb = np.asarray(a.qual).astype(int), np.asarray(b.qual).astype(int)
    dq = np.abs(qa - qb)
    tie = np.zeros(sa.shape, bool)
    kinds = {}
    if duplex_ties or ss_ties:
        masks = tie_kinds(sa, sb, qa, qb, qual_tol, duplex=duplex_ties)
        kinds = {k: int(m.sum()) for k, m in masks.items()}
        for m in masks.values():
            tie |= m
        if tie.sum() * 10_000 > sa.size:
            raise AssertionError(f"{int(tie.sum())} tie cycles of {sa.size} ({kinds}): "
                                 "more than 1 in 10,000")
        dq = np.where(tie, 0, dq)
        sb = np.where(tie, sa, sb)
    if not np.array_equal(sa, sb):
        raise AssertionError("consensus records differ in seq")
    if dq.size and dq.max() > qual_tol:
        raise AssertionError(f"quals differ by {dq.max()} > {qual_tol}")
    out = {"n_records": len(a), "max_qual_diff": int(dq.max(initial=0)),
           "tie_cycles": int(tie.sum()), "tie_kinds": kinds, "cycles": int(sa.size)}
    if per_base:
        ce_ties = 0
        tie_rows = tie
        for i, ((_, ta), (_, tb)) in enumerate(zip(pa, pb)):
            if not np.array_equal(ta[b"cd"], tb[b"cd"]):
                raise AssertionError(f"record {i}: cd differs")
            diff = ta[b"ce"] != tb[b"ce"]
            if (diff & ~tie_rows[i, :len(diff)]).any():
                raise AssertionError(f"record {i}: ce differs off a tie cycle")
            ce_ties += int(diff.sum())
        out.update(cd_identical=True, ce_tie_cycles=ce_ties)
    return out


class Tally:
    """Wraps a function in a module namespace and records ``key(result)``
    of every call (which codec ran, whether a parse was native)."""

    def __init__(self, module, name: str, key):
        self.module, self.name, self.key = module, name, key
        self.inner = getattr(module, name)
        self.seen = []

    def __enter__(self):
        def wrapped(*args, **kwargs):
            out = self.inner(*args, **kwargs)
            self.seen.append(self.key(out))
            return out

        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.inner)


def interval_union_ms(spans) -> float:
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def trace_sum_check(path: str, seconds: dict) -> dict:
    """Re-read a streaming capture and check, per stage, that its spans
    sum to ``RunReport.seconds`` within the report's rounding (spans
    carry 6 decimals, the report 3). Raises on a mismatch."""
    recs = [json.loads(line) for line in open(path)]
    if recs[0].get("type") != "meta" or recs[-1].get("type") != "summary":
        raise AssertionError("capture lacks its meta or summary record")
    sums: dict = {}
    for r in recs:
        if r["type"] == "span":
            sums[r["stage"]] = sums.get(r["stage"], 0.0) + r["dur"]
    bad = {k: (v, seconds.get(k)) for k, v in sums.items()
           if seconds.get(k) is None or abs(v - seconds[k]) > 0.0005 + 1e-6 * len(recs)}
    if bad:
        raise AssertionError(f"trace spans do not sum to the report: {bad}")
    return {"stages": len(sums), "records": len(recs), "ok": True}


def mesh_only(smi: str) -> int:
    """``--mesh-only``: the build and the mesh phase alone (on the serve
    phase's 250k-read input, after one untimed stream on every card;
    its device-side step cut from a 1M-read input), for a machine
    with several cards; then the nvidia-smi line,
    the kernels line (the mesh path's launches, in total and per lane,
    and each kernel's largest error against its plain version over the
    lanes) and the last line."""
    import torch

    from duplexumiconsensusreads_torch import benchmark
    from duplexumiconsensusreads_torch.cli.main import params_for
    from duplexumiconsensusreads_torch.runtime.stream import stream_call_consensus

    gp, cp, _ = params_for("config5")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as td:
        in_bam, sim_s = benchmark._e2e_input(SERVE_SMALL_READS[1], td)
        t0 = time.monotonic()
        # on every card, so no timed run pays a card's first use
        stream_call_consensus(in_bam, os.path.join(td, "warm.bam"), gp, cp,
                              chunk_reads=TAKEOVER_CHUNK_READS, device="cuda",
                              n_devices=torch.cuda.device_count())
        emit("mesh_warm_up", sim_seconds=sim_s, stream_seconds=round(time.monotonic() - t0, 3),
             cards=torch.cuda.device_count(), nvidia_smi=smi)
        step_bam, _ = benchmark._e2e_input(MESH_STEP_READS, td)
        launches, lanes = mesh_phase(in_bam, step_bam, td, smi)
    # the entry module's dry run with every card a lane
    from duplexumiconsensusreads_torch import entry

    torch.cuda.synchronize()
    reset_launches()
    t0 = time.monotonic()
    balance = entry.dryrun_multichip(torch.cuda.device_count())
    dry = read_launches("dryrun")
    emit("entry_dryrun", cards=torch.cuda.device_count(), seconds=round(time.monotonic() - t0, 3),
         balance=balance, launches=dry, nvidia_smi=smi)
    print(smi, flush=True)
    print(json.dumps({"kernels": [
        {"name": "segment_gemm", "route": "cuda",
         "source": "duplexumiconsensusreads_torch/csrc/segment_gemm.cu",
         "replaces": "duplexumiconsensusreads_tpu/kernels/pallas_ssc.py:67", "max_abs_err": 0.0,
         "launches": {"mesh": launches["segment_gemm"], "dryrun": dry["segment_gemm"]},
         "mesh_lane_launches": lanes["segment_gemm"]},
        *({"name": name, "route": "cuda",
           "source": "duplexumiconsensusreads_torch/csrc/cluster_fixpoint.cu",
           "replaces": "duplexumiconsensusreads_tpu/kernels/grouping.py:160", "max_abs_err": 0,
           "launches": {"mesh": launches[name], "dryrun": dry[name]},
           "mesh_lane_launches": lanes[name]}
          for name in ("directional_cluster",)),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main(argv=None) -> int:
    import torch

    argv = sys.argv[1:] if argv is None else argv
    if argv not in ([], ["--mesh-only"]):
        print(f"usage: chip_smoke.py [--mesh-only] (got {argv})", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        import duplexumiconsensusreads_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the torch port is not beside this script ({e})", file=sys.stderr)
        return 2
    import numpy as np

    from duplexumiconsensusreads_torch import native
    from duplexumiconsensusreads_torch.cli.main import params_for
    from duplexumiconsensusreads_torch.io import bgzf, native_reader, read_bam, simulated_bam
    from duplexumiconsensusreads_torch.kernels import build, consensus, grouping
    from duplexumiconsensusreads_torch.kernels import segment_gemm as sg
    from duplexumiconsensusreads_torch.ops import pipeline
    from duplexumiconsensusreads_torch.runtime.executor import call_consensus_file
    from duplexumiconsensusreads_torch.simulate import SimConfig

    # the smoke holds the native path; the portable codec runs only
    # where a phase asks for it
    os.environ.pop("DUT_NO_NATIVE", None)
    # the grouping Hamming product and the "matmul" method are f32
    # products; state the precision instead of inheriting it
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = nvidia_smi()
    print(smi, flush=True)
    emit(
        "env", nvidia_smi=smi, device=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), torch=torch.__version__, cuda=torch.version.cuda,
        python=sys.version.split()[0], cpu_capability=torch.backends.cpu.get_cpu_capability(),
    )

    # nvcc of every CUDA source and g++ of the native loader, started
    # together
    t0 = time.monotonic()
    nat_build = native.start_build()
    secs = build.build_all()
    nat = native.finish_build(nat_build)
    native.get_lib()
    emit("build", sources=list(build.SOURCES), seconds=round(time.monotonic() - t0, 3),
         per_source=secs,
         native_loader={"source": "duplexumiconsensusreads_torch/native/src/bamloader.cpp",
                        "seconds": nat["seconds"], "zlib_h_found": nat["zlib_h"],
                        "library": os.path.basename(nat["path"])})
    if argv:
        return mesh_only(smi)

    gp, cp, _ = params_for("config5")
    launches = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as td:
        # ---- e2e: the main path at the bench's one-dispatch size
        n_mol = N_READS // 9
        cfg = SimConfig(
            n_molecules=n_mol, read_len=150, n_positions=max(8, n_mol // 48),
            mean_family_size=4, umi_error=0.01, duplex=True, seed=7,
        )
        in_bam = os.path.join(td, "in.bam")
        t0 = time.monotonic()
        simulated_bam(cfg, path=in_bam, sort=True)
        sim_s = time.monotonic() - t0

        torch.cuda.synchronize()
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        # ssc_kernel reaches the kernel through consensus._reduce and the
        # executor looks fused_pipeline up at call time: capture the
        # pipeline's inputs and the reduction's ids (not its 1.85 GB
        # rows: holding them would change the run's device memory)
        with Capture(consensus, "_reduce", keep=(1,)) as cap_k, \
                Capture(pipeline, "fused_pipeline") as cap_p, \
                Tally(native_reader, "read_bam_native", lambda r: r[2]["native"]) as t_read, \
                Tally(bgzf, "compress_fast_tagged", lambda r: r[1]) as t_defl:
            rep = call_consensus_file(
                in_bam, os.path.join(td, "out.bam"), gp, cp,
                capacity=CAPACITY, device="cuda",
            )
        wall = time.monotonic() - t0
        launches["whole_file"] = read_launches("whole_file")
        peak_mem = torch.cuda.max_memory_allocated()
        if t_read.seen != [True] or set(t_defl.seen) != {"native"}:
            raise AssertionError(f"the main path's codecs: reader {t_read.seen}, "
                                 f"deflate {set(t_defl.seen)} (want native)")
        _, recs = read_bam(os.path.join(td, "out.bam"))
        if len(recs) != rep.n_consensus or rep.n_consensus == 0:
            raise AssertionError(f"output has {len(recs)} records, report {rep.n_consensus}")
        q = np.asarray(recs.qual)
        if q.max() > cp.max_qual or rep.n_valid_reads < 500_000:
            raise AssertionError("consensus quals out of range or input too small")
        stages = {k: round(v, 3) for k, v in rep.seconds.items()}
        pipe_ms = cap_p.span_ms()
        emit(
            "e2e", config="config5", capacity=CAPACITY, reads_in=rep.n_records,
            valid_reads=rep.n_valid_reads, consensus_out=rep.n_consensus,
            buckets=rep.n_buckets, dispatch_classes=rep.n_size_classes,
            sim_seconds=round(sim_s, 3), wall_seconds=round(wall, 3),
            reads_per_s=round(rep.n_valid_reads / wall, 1),
            stage_seconds=stages,
            stage_reads_per_s={k: round(rep.n_valid_reads / v, 1) for k, v in rep.seconds.items() if v > 0},
            native=True, deflate="native", deflate_calls=len(t_defl.seen),
            bytes_h2d=rep.bytes_h2d, bytes_d2h=rep.bytes_d2h,
            max_memory_allocated=peak_mem, launches=launches["whole_file"],
            segment_gemm_calls=[list(s) for s in cap_k.shapes],
            segment_gemm_span_ms=cap_k.span_ms(),
            # device spans of the per-class fused_pipeline calls (copies
            # in and out excluded): the share of the wall the card spent
            # inside the pipeline, idle gaps within it included
            fused_pipeline_span_ms=pipe_ms,
            pipeline_span_share_of_wall=sum(pipe_ms) / 1e3 / wall,
        )
        del recs, q

        # the same call on a small input, on the card and on the CPU
        # (plain versions everywhere, and the CPU's own reduction,
        # blockseg, which adds the same evidence in another order):
        # records agree, quals within one per strand (CPU and CUDA
        # transcendentals differ by ULPs, and a duplex qual is the sum
        # of two strand quals), bases except at counted evidence ties
        small_bam = os.path.join(td, "small.bam")
        simulated_bam(dataclasses.replace(cfg, n_molecules=400, n_positions=10, seed=3),
                      path=small_bam, sort=True)
        outs = {}
        for d in ("cuda", "cpu"):
            call_consensus_file(small_bam, os.path.join(td, f"small_{d}.bam"), gp, cp,
                                capacity=256, device=d)
            outs[d] = read_bam(os.path.join(td, f"small_{d}.bam"))[1]
        emit("e2e_small_reference", **compare_records(outs["cuda"], outs["cpu"], qual_tol=2,
                                                      duplex_ties=True))

        reader_phase(in_bam)
        cap_pk, cap_pp, launches["per_base"] = per_base_phase(in_bam, small_bam, td, gp, cp)
        launches["workflow"] = workflow_phase(in_bam, cfg, small_bam, td)
    launches["operators"] = operators_phase()

    # ---- stages: the largest class's fused_pipeline once more, warm,
    # with the device span of each stage function it calls (the rest
    # is id arithmetic and the depth-stat epilogue). Its reduction
    # inputs are the ones the main path gave the kernel: the pipeline
    # is deterministic, and the ids are checked against the run's.
    args, kw = cap_p.args
    spec = args[7] if len(args) > 7 else kw["spec"]
    full = args[:7]
    pipeline.fused_pipeline(*full, spec)  # warm
    torch.cuda.synchronize()
    names = {pipeline: ("_decode_packed", "group_kernel", "ssc_kernel", "fit_cycle_cap_kernel",
                        "apply_cycle_cap", "duplex_merge_strided", "_segment_min"),
             consensus: ("_evidence_columns", "_reduce"), grouping: ("directional_cluster",)}
    with contextlib.ExitStack() as stack:
        caps = {n: stack.enter_context(Capture(m, n)) for m, ns in names.items() for n in ns}
        whole = stack.enter_context(Capture(pipeline, "fused_pipeline"))
        pipeline.fused_pipeline(*full, spec)
    total_ms = whole.span_ms()[0]
    stage_ms = {n: sum(c.span_ms()) for n, c in caps.items()}
    emit("stages", shape=list(full[0].shape), total_ms=total_ms, stage_ms=stage_ms,
         calls={n: len(c.events) for n, c in caps.items()},
         note="ssc_kernel includes _evidence_columns and _reduce")
    (big, fid, f_max, _method), _ = caps["_reduce"].args
    if not torch.equal(fid, cap_k.args[0][1]):
        raise AssertionError("the rerun's reduction ids differ from the main path's")
    # grouping's inputs and slot table in the largest class
    cluster_args = caps["directional_cluster"].args[0]
    group_args = caps["group_kernel"].args
    del caps, whole, cap_k

    # ---- sync_debug: grouping with no host sync, and what remains
    sync_debug_phase(group_args, full, spec, smi)
    # ---- graphs: the step and the epilogue as CUDA graphs, replayed
    # bit for bit equal to eager
    graphs_phase(full, spec, smi)
    # ---- cluster: the directional cluster kernel vs its plain version
    cluster_row = cluster_phase(cluster_args, group_args, smi)
    del group_args, cluster_args

    # ---- kernel: segment_gemm vs its plain version
    kernel_rows = []
    rng = torch.Generator(device="cuda").manual_seed(0)
    nb, r, c = big.shape
    cases = {
        "random_sorted": torch.sort(torch.randint(0, f_max, (nb, r), device=dev, generator=rng), 1).values,
        "random_unsorted": torch.randint(0, f_max, (nb, r), device=dev, generator=rng),
        "random_strided_duplex": torch.sort(torch.randint(0, f_max // 2, (nb, r), device=dev, generator=rng), 1).values * 2
        + torch.randint(0, 2, (nb, r), device=dev, generator=rng),
        "random_dead_and_overflow": torch.randint(-1, f_max + 4, (nb, r), device=dev, generator=rng),
        "real_main_path": fid,
    }
    for name, ids in cases.items():
        ids = ids.to(torch.int32).contiguous()
        x = big if name == "real_main_path" else sg.pad_rows(
            torch.randn(nb, r, c, device=dev, generator=rng))
        kernel_rows.append(kernel_case(sg, name, x, ids, f_max))
        del x
    t_main = kernel_times(sg, big, fid, f_max, plain_reps=2, lib_reps=10)
    del big, fid

    # the per-base shape: the per_base call's largest class once more,
    # its full ssc pass (C = 9L+1) captured whole; the ids must equal
    # the per_base run's
    args_pb, kw_pb = cap_pp.args
    spec_pb = args_pb[7] if len(args_pb) > 7 else kw_pb["spec"]
    with Capture(consensus, "segment_gemm") as cap_r:
        pipeline.fused_pipeline(*args_pb[:7], spec_pb)
    (big_pb, fid_pb, f_max_pb), _ = cap_r.args
    del cap_r, args_pb, kw_pb
    if not torch.equal(fid_pb, cap_pk.args[0][1]):
        raise AssertionError("the per-base rerun's reduction ids differ from the run's")
    pb_case = kernel_case(sg, "real_per_base_path", big_pb, fid_pb, f_max_pb)
    t_pb = kernel_times(sg, big_pb, fid_pb, f_max_pb, plain_reps=1, lib_reps=5)
    del big_pb, fid_pb, cap_pk, cap_pp
    torch.cuda.empty_cache()
    emit("kernel", name="segment_gemm", cases=kernel_rows + [pb_case], shape=[nb, r, c],
         f_max=f_max, **t_main, library_call="index_add_",
         per_base={"shape": pb_case["shape"], "f_max": f_max_pb, **t_pb}, nvidia_smi=smi)

    def row_times(t):
        return {"ms": t["kernel_ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"]}

    seg_row = {
        "name": "segment_gemm", "route": "cuda",
        "source": "duplexumiconsensusreads_torch/csrc/segment_gemm.cu",
        "replaces": "duplexumiconsensusreads_tpu/kernels/pallas_ssc.py:67",
        "max_abs_err": max(row["max_abs_err"] for row in kernel_rows + [pb_case]),
        **row_times(t_main),
        # the same numbers at the per_base path's full-pass shape
        "per_base_shape": {"shape": pb_case["shape"], **row_times(t_pb)},
    }

    # ---- parity: >= 8 real buckets, kernel vs plain reduction
    n_par = min(8, full[0].shape[0])
    if n_par < 8:
        raise AssertionError(f"largest class has {n_par} buckets; parity wants >= 8")
    sub = [a[:n_par] for a in full]
    out_k = pipeline.fused_pipeline(*sub, spec)
    out_p = pipeline.fused_pipeline(*sub, dataclasses.replace(spec, ssc_method="segment"))
    torch.cuda.synchronize()
    max_dq = 0
    for key in out_k:
        a, b = out_k[key], out_p[key]
        if key == "cons_qual":
            max_dq = (a.int() - b.int()).abs().max().item()
            if max_dq > 1:
                raise AssertionError(f"parity: cons_qual differs by {max_dq}")
        elif not torch.equal(a, b):
            # integers must be identical; bases too (the two reductions
            # add the same f32 values in the same order, so no tie can
            # break differently)
            raise AssertionError(f"parity: {key} differs between kernel and plain")
    emit("parity", buckets=n_par, spec_f_max=spec.f_max, spec_m_max=spec.m_max,
         spec_u_max=spec.u_max, keys=sorted(out_k), max_qual_diff=max_dq,
         bases_identical=True, integers_identical=True)
    del out_k, out_p, sub

    # ---- fit_counts: the counts fit of the cycle model in the fused
    # step, against the gather fit, on the same class
    launches["fit_counts"], fc_case, t_fc = fit_counts_phase(sg, full, spec, smi)
    kernel_rows.append(fc_case)
    seg_row["fit_counts_shape"] = {"shape": fc_case["shape"], "f_max": fc_case["f_max"],
                                   **row_times(t_fc), "live_rows": t_fc["live_rows"],
                                   "bound_fraction": t_fc["bound_fraction"]}

    del full, args, kw, cap_p
    torch.cuda.empty_cache()
    # the bench's input cache: the stream phase simulates its input
    # there, and the bench phase's e2e leg reuses it
    bench_cache = tempfile.TemporaryDirectory(prefix="chip_smoke_bench_")
    rung_calls = stream_phases(gp, smi, bench_cache.name, launches)
    # each explicit rung's largest launch of the ladder run: the kernel
    # against its plain version (tolerance 0), and its times
    rung_shapes = {}
    for rung, (big_r, fid_r, f_max_r) in sorted(rung_calls.items()):
        case = kernel_case(sg, f"ladder_rung_{rung}", big_r, fid_r, f_max_r)
        kernel_rows.append(case)
        t_r = kernel_times(sg, big_r, fid_r, f_max_r, plain_reps=1, lib_reps=5)
        rung_shapes[str(rung)] = {"shape": case["shape"], "f_max": f_max_r, **row_times(t_r),
                                  "live_rows": t_r["live_rows"],
                                  "bound_fraction": t_r["bound_fraction"]}
    del rung_calls, big_r, fid_r
    torch.cuda.empty_cache()
    emit("kernel_rungs", name="segment_gemm", rungs=rung_shapes, library_call="index_add_",
         nvidia_smi=smi)
    launches["entry"], launches["dryrun"], entry_case, entry_fix = entry_phase(smi)
    kernel_rows.append(entry_case)
    cluster_row["entry_shape"] = entry_fix
    torch.cuda.empty_cache()
    launches["features"], feature_seg, feature_dc = features_phase(smi)
    kernel_rows.extend(feature_seg)
    cluster_row["features_shapes"] = feature_dc
    cluster_row["max_abs_err"] = max([cluster_row["max_abs_err"]]
                                     + [c["max_abs_err"] for c in feature_dc])
    torch.cuda.empty_cache()
    launches["race"] = race_phase(smi)
    launches["bench"], bench_calls, launches["fleet"] = bench_phase(bench_cache.name, smi)
    bench_cache.cleanup()
    # the bench's largest launch at each (rows, columns, f_max) it gave
    # the kernel (per_config's capacity 4096, the profile tools'
    # ablations, the e2e legs): the kernel against its plain version
    # (tolerance 0), and its times
    if not bench_calls:
        raise AssertionError("the bench phase held no segment_gemm launch on the card")
    bench_shapes = {}
    for (r_b, c_b, f_b), (big_b, fid_b, _) in sorted(bench_calls.items()):
        case = kernel_case(sg, f"bench_{r_b}x{c_b}_f{f_b}", big_b, fid_b, f_b)
        kernel_rows.append(case)
        t_b = kernel_times(sg, big_b, fid_b, f_b, plain_reps=1, lib_reps=5)
        bench_shapes[f"{r_b}x{c_b}/f{f_b}"] = {
            "shape": case["shape"], "f_max": f_b, **row_times(t_b),
            "live_rows": t_b["live_rows"], "bound_fraction": t_b["bound_fraction"]}
    del bench_calls, big_b, fid_b
    torch.cuda.empty_cache()
    emit("kernel_bench", name="segment_gemm", shapes=bench_shapes, library_call="index_add_",
         nvidia_smi=smi)
    seg_row["max_abs_err"] = max(row["max_abs_err"] for row in kernel_rows + [pb_case])
    seg_row["rung_shapes"] = rung_shapes
    seg_row["bench_shapes"] = bench_shapes
    paths = ("whole_file", "stream", "per_base", "workflow", "operators", "live", "serve",
             "shard", "multihost", "mesh", "ladder", "race", "bench", "fleet", "fit_counts",
             "chaos", "entry", "dryrun", "features")
    for row, name in ((seg_row, "segment_gemm"), (cluster_row, "directional_cluster")):
        row["launches"] = {k: launches[k][name] for k in paths}
        # the mesh path's launches on each lane
        row["mesh_lane_launches"] = launches["mesh_lanes"][name]
    # each path's steps and epilogues by how they ran (runtime/graphs.py)
    from duplexumiconsensusreads_torch.runtime import graphs, pinned

    emit("graphs_paths", paths=GRAPH_PATHS,
         replayed={k: v["step"]["replayed"] for k, v in GRAPH_PATHS.items()},
         classes={k: v["classes"] for k, v in GRAPH_PATHS.items()},
         pool_bytes=graphs.pool_bytes(), pinned_staging=pinned.stats(),
         pool_budget={"per_process_bytes": graphs.MAX_DEVICE_POOL_BYTES,
                      "card_free_share": graphs.CARD_FREE_SHARE},
         path_pools=PATH_POOLS, dispatch=PATH_DISPATCH, nvidia_smi=smi)

    print(smi, flush=True)
    print(json.dumps({"kernels": [seg_row, cluster_row]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


def fit_counts_phase(sg, full, spec, smi: str):
    """The fused step on the largest whole-file class with the cycle
    model fit by gather and by counts (the ``DUT_FIT_IMPL`` values, as
    ``PipelineSpec.fit_impl``) in turns, gather, counts, counts, gather:
    the cycle caps and every output identical, each turn's step ms.
    Then the counts pass's segment_gemm launch (the fit columns plus 4L
    count columns) against its plain version at tolerance 0, with its
    times and bound. Returns the kernels' launches over the turns, that
    launch's kernel case and its times."""
    import torch

    from duplexumiconsensusreads_torch.kernels import consensus
    from duplexumiconsensusreads_torch.ops import pipeline

    specs = {impl: dataclasses.replace(spec, fit_impl=impl) for impl in ("gather", "counts")}
    torch.cuda.synchronize()
    reset_launches()
    first, turns = {}, []
    for impl in ("gather", "counts", "counts", "gather"):
        with Capture(pipeline, "apply_cycle_cap") as cap_c:
            out = pipeline.fused_pipeline(*full, specs[impl])
        got = (cap_c.args[0][1], out)
        if impl not in first:
            first[impl] = got
        elif not (torch.equal(got[0], first[impl][0])
                  and all(torch.equal(v, first[impl][1][k]) for k, v in out.items())):
            raise AssertionError(f"fit_counts: the {impl} fit moved between turns")
        turns.append({"fit_impl": impl,
                      "step_ms": cuda_ms(lambda: pipeline.fused_pipeline(*full, specs[impl]),
                                         reps=3)})
        del cap_c, got, out
    launches = read_launches("fit_counts")
    (cap_g, out_g), (cap_n, out_n) = first["gather"], first["counts"]
    if not torch.equal(cap_g, cap_n):
        raise AssertionError("fit_counts: the cycle caps differ from the gather fit's")
    bad = [k for k in out_g if not torch.equal(out_g[k], out_n[k])]
    if bad:
        raise AssertionError(f"fit_counts: {bad} differ from the gather fit's")
    n_keys, caps = len(out_g), [int(cap_g.min()), int(cap_g.max())]
    del first, cap_g, out_g, cap_n, out_n
    with Capture(consensus, "segment_gemm") as cap_r:
        pipeline.fused_pipeline(*full, specs["counts"])
    (big, fid, f_max), _ = cap_r.args
    del cap_r
    case = kernel_case(sg, "real_fit_counts_path", big, fid, f_max)
    t = kernel_times(sg, big, fid, f_max, plain_reps=1, lib_reps=5)
    del big, fid
    torch.cuda.empty_cache()
    mean = {impl: sum(r["step_ms"] for r in turns if r["fit_impl"] == impl) / 2
            for impl in ("gather", "counts")}
    emit("fit_counts", shape=list(full[0].shape), turns=turns, mean_step_ms=mean,
         counts_over_gather=mean["counts"] / mean["gather"], caps_identical=True,
         outputs_identical=True, output_keys=n_keys, cycle_cap_range=caps,
         segment_gemm={"shape": case["shape"], "f_max": f_max, **t,
                       "library_call": "index_add_", "max_abs_err": case["max_abs_err"]},
         launches=launches, nvidia_smi=smi)
    return launches, case, t


def kernel_case(sg, name: str, x, ids, f_max: int) -> dict:
    """segment_gemm against its plain version on one input: the same
    f32 adds in the same ascending row order, so bit-identical
    (tolerance 0); raises otherwise."""
    import torch

    got = sg.segment_gemm(x, ids, f_max)
    ref = sg.segment_gemm_plain(x, ids, f_max)
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    rel = ((got - ref).abs() / ref.abs().clamp(min=1e-30)).max().item()
    if not torch.equal(got, ref):
        raise AssertionError(f"segment_gemm {name}: max abs err {err} (tolerance 0)")
    return {"case": name, "shape": list(x.shape), "f_max": f_max,
            "max_abs_err": err, "max_rel_err": rel, "tolerance": 0.0}


def kernel_times(sg, big, fid, f_max: int, plain_reps: int, lib_reps: int) -> dict:
    """Kernel, plain-version and library-call (index_add_) times on one
    input, and the bound. The bound counts what this run's ids need:
    the live rows of big once, every id once, every output element
    once; the adds at the f32 rate outside the tensor cores."""
    import torch

    nb, _, c = big.shape
    dev = big.device
    live = ((fid >= 0) & (fid < f_max)).sum().item()
    need_bytes = live * c * 4 + fid.numel() * 4 + nb * f_max * c * 4
    bytes_ms = need_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = live * c / F32_FLOPS * 1e3
    k_ms = cuda_ms(lambda: sg.segment_gemm(big, fid, f_max), reps=20)
    plain_ms = cuda_ms(lambda: sg.segment_gemm_plain(big, fid, f_max), reps=plain_reps)
    base = torch.arange(nb, device=dev)[:, None] * (f_max + 1)
    offs = torch.where((fid >= 0) & (fid < f_max), fid.long() + base, base + f_max).reshape(-1)
    flat = big.reshape(-1, c)
    acc = torch.zeros(nb * (f_max + 1), c, device=dev)
    lib_ms = cuda_ms(lambda: acc.zero_().index_add_(0, offs, flat), reps=lib_reps)
    del acc, offs, flat
    return {"live_rows": live, "bytes_needed": need_bytes, "bytes_bound_ms": bytes_ms,
            "ops_bound_ms": ops_ms, "kernel_ms": k_ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bound_fraction": max(bytes_ms, ops_ms) / k_ms}


I32_MAX = 2**31 - 1
# synthetic slot tables (cluster_case) held by the cluster phase:
# (cluster_case kind[:what the case adds], buckets, u, UMI length,
# max_hamming, count_ratio). The sizeN kinds are position groups of
# exactly N slots, at the main class's 280 buckets of 512: a warp's
# 32 candidates and one past (31-33), and one group of all 512 slots;
# "dense" at u 512 overflows the list and sweeps over the kept edge
# masks, at u 2048 over the edge test (its masks do not fit either);
# "unsorted" and "reversed" are not strictly sorted by (pos, words), so
# their ids take the kernel's pair passes
CLUSTER_CASES = (
    ("groups", 4, 2048, 12, 1, 2),
    ("hamming1_groups", 4, 2048, 12, 1, 2),
    ("chain_up", 4, 2048, 12, 1, 1),
    ("chain_down", 4, 2048, 18, 1, 1),
    ("dense", 4, 512, 12, 12, 0),
    ("dense", 2, 2048, 12, 12, 0),
    ("unsorted", 4, 2048, 12, 1, 2),
    ("reversed", 4, 2048, 12, 1, 2),
    ("groups:w2", 4, 2048, 18, 2, 2),
    ("groups:w3", 4, 2048, 36, 2, 2),
    ("groups:w4", 2, 512, 48, 3, 2),
    ("groups:ratio0", 4, 2048, 12, 1, 0),
    ("groups:global_table", 2, 16384, 12, 1, 2),
    ("size31", 280, 512, 12, 1, 2),
    ("size32", 280, 512, 12, 1, 2),
    ("size33", 280, 512, 12, 1, 2),
    ("size512", 280, 512, 12, 1, 2),
)
# an int32 operation's rate on the H100 SXM outside the tensor cores:
# 64 INT32 lanes a SM x 132 SMs x 1.98 GHz boost (the Hopper white
# paper's SM; the data sheet gives no integer row)
I32_OPS = 64 * 132 * 1.98e9


def chain_umis(n: int, umi_len: int):
    """n UMIs of umi_len codes in which consecutive ones differ at one
    base and all others at two or more: k ones then zeros, then k twos
    then ones, then k threes then twos."""
    import numpy as np

    out = []
    for phase, (hi_c, lo_c) in enumerate(((1, 0), (2, 1), (3, 2))):
        for k in range(1 if phase else 0, umi_len + 1):
            out.append([hi_c] * k + [lo_c] * (umi_len - k))
    if n > len(out):
        raise ValueError(f"a chain of {umi_len}-base UMIs holds at most {len(out)} nodes")
    return np.asarray(out[:n], np.int32)


def cluster_case(kind: str, n: int, u: int, umi_len: int, rng):
    """(codes, words, pos, cnt) numpy for n buckets of u slots, as
    group_kernel builds the table (codes (n, u, umi_len) u8, 0 on empty
    slots): unique UMIs within a position, slots sorted by
    (pos, packed words) (a chain keeps its own order within its
    position), about 85 % valid, empty slots at the tail
    (I32_MAX words and positions, count 0). "groups": position groups of
    1-40 UMIs, a few true ones with many reads and their 1-2 substitution
    neighbours with few; "hamming1_groups": groups of four UMIs that
    differ at one common base (every pair within Hamming 1); "chain_up" /
    "chain_down": groups that are chains (consecutive UMIs one base
    apart) with counts falling two a link, so with count_ratio 1 each
    link points one way, the seed at a group's first slot or, down, its
    last; "dense": one group of every slot; "unsorted": "groups" with
    all u slots shuffled; "reversed": "groups" with each group in
    falling word order (positions sorted, words not); "sizeN": "groups" of exactly N slots each (a
    few more true UMIs the larger N), int(0.85 u) // N of them, or one
    of all u slots where N > 0.85 u."""
    import numpy as np
    import torch

    from duplexumiconsensusreads_torch.kernels.encoding import pack_umi_words

    fixed = int(kind[4:]) if kind.startswith("size") else 0
    out = []
    for _ in range(n):
        n_valid = max(1, int(u * 0.85)) if kind != "dense" else u
        if fixed:
            n_valid = min(u, max(fixed, n_valid // fixed * fixed))
        codes, cnts, poss = [], [], []
        g = 0
        while len(codes) < n_valid:
            room = n_valid - len(codes)
            if kind == "dense":
                grp = rng.integers(0, 4, (room * 2, umi_len))
                grp = np.unique(grp, axis=0)[:room]
                c = rng.integers(1, 50, len(grp))
            elif kind == "hamming1_groups":
                at = int(rng.integers(0, umi_len))
                grp = np.repeat(rng.integers(0, 4, (1, umi_len)), 4, axis=0)
                grp[:, at] = np.arange(4)
                grp, c = grp[:room], rng.integers(1, 30, min(4, room))
            elif kind in ("chain_up", "chain_down"):
                size = int(min(rng.integers(8, 3 * umi_len + 2), room))
                grp = chain_umis(size, umi_len)
                c = 2 * (size - np.arange(size)) + 1
                if kind == "chain_down":
                    c = c[::-1]
            else:
                size = int(min(fixed or rng.integers(1, 41), room))
                true = rng.integers(0, 4, (int(rng.integers(1, 4)) + fixed // 32, umi_len))
                seen = {tuple(t): int(rng.integers(5, 40)) for t in true}
                while len(seen) < size:
                    t = true[int(rng.integers(0, len(true)))].copy()
                    t[rng.integers(0, umi_len, int(rng.integers(1, 3)))] = rng.integers(0, 4)
                    seen.setdefault(tuple(t), int(rng.integers(1, 5)))
                grp = np.asarray(list(seen)[:size])
                c = np.asarray(list(seen.values())[:size])
            codes += list(grp)
            cnts += list(c)
            poss += [g * 3] * len(grp)
            g += 1
        codes = np.asarray(codes, np.uint8)
        words = pack_umi_words(torch.from_numpy(codes)).numpy()
        pos = np.asarray(poss, np.int32)
        cnt = np.asarray(cnts, np.int32)
        if kind in ("chain_up", "chain_down"):  # each chain in its own order
            order = np.argsort(pos, kind="stable")
        elif kind == "reversed":  # each group in falling word order
            order = np.lexsort(tuple(-words[:, i] for i in range(words.shape[1] - 1, -1, -1))
                               + (pos,))
        else:
            order = np.lexsort(tuple(words[:, i] for i in range(words.shape[1] - 1, -1, -1))
                               + (pos,))
        codes, words, pos, cnt = codes[order], words[order], pos[order], cnt[order]
        n_inv = u - len(pos)
        codes = np.concatenate([codes, np.zeros((n_inv, umi_len), np.uint8)])
        words = np.concatenate([words, np.full((n_inv, words.shape[1]), I32_MAX, np.int32)])
        pos = np.concatenate([pos, np.full(n_inv, I32_MAX, np.int32)])
        cnt = np.concatenate([cnt, np.zeros(n_inv, np.int32)])
        if kind == "unsorted":
            perm = rng.permutation(u)
            codes, words, pos, cnt = codes[perm], words[perm], pos[perm], cnt[perm]
        out.append((codes, words, pos, cnt))
    return tuple(np.stack(a) for a in zip(*out))


def cluster_bound(u_words, u_pos, seed, n_edges: int) -> dict:
    """The least time the card could take for directional_cluster on this
    table: the table read once (words, positions, counts) and seed, mid
    and n_mol written once, at the memory rate; against the int32
    operations this data needs, at the int32 rate. A position group of n
    valid slots has n (n - 1) / 2 unordered pairs, each needing the
    Hamming distance and its limit once (XOR, shift, one LOP3 for
    (x | x >> 1) & mask and a popcount a word, W - 1 adds, the compare:
    5 W), the edge test each way (cnt_i against slot j's
    count_ratio * cnt_j - 1, made once a slot: 2) and the rank (the keys
    (-cnt, words) are distinct within a position, so 1 + W compares and
    one add order both slots); the group's m molecules (distinct seeds)
    need an id compare a pair (W compares, one add). Then one min an
    edge for the fixpoint, and 3 a valid slot (the threshold, the
    first-slot test, the id's copy from its seed). No position compare:
    a group's slots share their position."""
    import torch

    import statistics

    n, u, w = u_words.shape
    pairs = mol_pairs = n_valid = 0
    sizes, bucket_pairs = [], []
    for b in range(n):
        valid = u_pos[b] != I32_MAX
        p, s = u_pos[b][valid], seed[b][valid]
        n_valid += int(valid.sum())
        _, size = torch.unique(p, return_counts=True)
        sizes += size.tolist()
        bucket_pairs.append(int((size.long() * (size.long() - 1) // 2).sum()))
        pairs += bucket_pairs[-1]
        _, m = torch.unique(torch.unique(torch.stack([p, s]), dim=1)[0], return_counts=True)
        mol_pairs += int((m.long() * (m.long() - 1) // 2).sum())
    need_bytes = n * u * (w + 2) * 4 + 2 * n * u * 4 + n * 4
    ops = pairs * (6 * w + 4) + mol_pairs * (w + 1) + n_edges + 3 * n_valid
    bytes_ms = need_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / I32_OPS * 1e3
    return {"in_group_pairs": pairs,
            "group_size": {"max": max(sizes, default=0),
                           "median": statistics.median(sizes or [0]), "groups": len(sizes)},
            "in_group_pairs_per_bucket": {"max": max(bucket_pairs, default=0),
                                          "median": statistics.median(bucket_pairs or [0])},
            "molecule_pairs": mol_pairs, "edges": n_edges,
            "valid_slots": n_valid, "bytes_needed": need_bytes, "operations": ops,
            "bytes_bound_ms": bytes_ms, "ops_bound_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def largest_tensor(fn) -> tuple[int, list]:
    """(elements, shape) of the largest tensor any torch operation
    creates while ``fn`` runs (a dispatch mode sees every operation's
    outputs; a hand-written kernel's launch is no torch operation, its
    outputs are the wrapper's torch.empty)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class Largest(TorchDispatchMode):
        size, shape = 0, []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in tree_leaves(out):
                if isinstance(t, torch.Tensor) and t.numel() > self.size:
                    self.size, self.shape = t.numel(), list(t.shape)
            return out

    with Largest() as mode:
        fn()
    return mode.size, mode.shape


def cluster_phase(table, group_args, smi: str) -> dict:
    """directional_cluster against its plain version, tolerance 0 on seed,
    mid_of_slot and n_mol: at the main path's table (the largest class of
    the stages rerun) and on CLUSTER_CASES (one group of every slot past
    the kernel's list; u 16384 reads its table from global memory). Then
    group_kernel at that class, with the kernel and with the plain
    version patched in: the largest tensor any torch operation of the
    call creates (the kernel path must create none of N * U * U
    elements) and the peak device memory above its inputs; and the
    kernel's, the plain version's and the bound's times at the main
    path's table. Returns the kernels line's row (launches filled in
    later)."""
    import numpy as np
    import torch

    from duplexumiconsensusreads_torch.kernels import cluster_fixpoint as cf
    from duplexumiconsensusreads_torch.kernels import grouping
    from duplexumiconsensusreads_torch.ops import pipeline

    cases = []

    def hold(name, tab):
        t0 = time.monotonic()
        got = cf.directional_cluster(*tab)
        torch.cuda.synchronize()
        k_s = time.monotonic() - t0
        want = cf.directional_cluster_plain(*tab)
        err = max((a.long() - b.long()).abs().max().item() for a, b in zip(got, want))
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"directional_cluster {name}: max abs err {err} (tolerance 0)")
        n, u, w = tab[0].shape
        in_smem, scratch = cf.cluster_plan(u, w)
        cases.append({"case": name, "shape": [n, u, w], "max_hamming": tab[4],
                      "count_ratio": tab[5], "table_in_smem": in_smem, "scratch_bytes": scratch,
                      "n_mol": want[2].tolist()[:4], "max_abs_err": err, "tolerance": 0,
                      "kernel_wall_s": round(k_s, 6)})
        del got, want
        torch.cuda.empty_cache()

    hold("real_main_path", table)
    rng = np.random.default_rng(0)
    for kind, n, u, umi_len, h, r in CLUSTER_CASES:
        arrays = (torch.from_numpy(a).cuda()
                  for a in cluster_case(kind.split(":")[0], n, u, umi_len, rng)[1:])
        hold(f"synthetic_{kind.replace(':', '_')}_u{u}", (*arrays, umi_len, h, r))
    # group_kernel's largest tensor and device memory above its inputs,
    # kernel and plain
    args, kw = group_args
    n, u = table[1].shape
    peak, largest = {}, {}
    for turn in ("kernel", "plain"):
        if turn == "plain":
            grouping.directional_cluster = cf.directional_cluster_plain
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base_mem = torch.cuda.memory_allocated()
            pipeline.group_kernel(*args, **kw)
            torch.cuda.synchronize()
            peak[turn] = torch.cuda.max_memory_allocated() - base_mem
            largest[turn] = largest_tensor(lambda: pipeline.group_kernel(*args, **kw))
        finally:
            grouping.directional_cluster = cf.directional_cluster
    if largest["kernel"][0] >= n * u * u:
        raise AssertionError(f"group_kernel created a tensor of shape {largest['kernel'][1]} on "
                             f"the kernel path (N * U * U = {n * u * u})")
    edge, _ = cf.cluster_edges_plain(*table)
    n_edges = int(edge.sum())
    del edge
    bound = cluster_bound(table[0], table[1], cf.directional_cluster_plain(*table)[0], n_edges)
    # the kernel's device time (the launches queued ahead: the wrapper's
    # host work outlasts the kernel), and back to back as a caller sees
    # it outside a CUDA graph
    k_ms = cuda_ms(lambda: cf.directional_cluster(*table), reps=20, queue_ahead=True)
    call_ms = cuda_ms(lambda: cf.directional_cluster(*table), reps=20)
    plain_ms = cuda_ms(lambda: cf.directional_cluster_plain(*table), reps=3)
    times = {"kernel_ms": k_ms, "call_ms": call_ms, "plain_ms": plain_ms, **bound,
             "bound_fraction": bound["bound_ms"] / k_ms}
    # every bucket of the class resident at once: blocks an SM (CUDA's
    # occupancy query) times SMs against the class's buckets
    w = table[0].shape[2]
    per_sm = cf.cluster_blocks_per_sm(u, w)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    in_smem, scratch = cf.cluster_plan(u, w)
    occupancy = {"threads_per_block": cf.THREADS, "blocks_per_sm": per_sm, "sms": sms,
                 "buckets": n, "waves": -(-n // max(1, per_sm * sms)),
                 "shared_memory_bytes": cf.cluster_smem_bytes(u, w, in_smem, scratch)}
    if occupancy["waves"] != 1:
        raise AssertionError(f"directional_cluster takes {occupancy['waves']} waves at the "
                             f"main class: {occupancy}")
    emit("cluster", name="directional_cluster", shape=list(table[0].shape),
         occupancy=occupancy,
         umi_len=table[3], max_hamming=table[4], count_ratio=table[5], cases=cases, **times,
         group_kernel_peak_bytes_above_inputs=peak, nuu_elements=n * u * u,
         group_kernel_largest_tensor={k: {"elements": v[0], "shape": v[1]}
                                      for k, v in largest.items()},
         library_call=None, nvidia_smi=smi)
    return {"name": "directional_cluster", "route": "cuda",
            "source": "duplexumiconsensusreads_torch/csrc/cluster_fixpoint.cu",
            "replaces": "duplexumiconsensusreads_tpu/kernels/grouping.py:160",
            "note": "no Pallas kernel: _directional_cluster there (its lax.while_loop at :160) "
                    "and group_kernel's molecule-rank block (:173), in one launch",
            "max_abs_err": max(c["max_abs_err"] for c in cases), "ms": k_ms,
            "plain_ms": plain_ms, "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
            "library_ms": None, "shape": list(table[0].shape),
            "bound_fraction": times["bound_fraction"]}


def sync_debug_phase(group_args, full, spec, smi: str) -> None:
    """group_kernel at the whole-file shape (the largest class's captured
    arguments) under torch.cuda.set_sync_debug_mode("error"): it must run
    through, while the plain directional cluster (patched in as the
    stream turns patch it; its fixpoint loop checks for a change on the
    host) raises there. Then fused_pipeline under "warn": every implicit
    sync that remains, counted by file:line."""
    import torch

    from duplexumiconsensusreads_torch.kernels import cluster_fixpoint as cf
    from duplexumiconsensusreads_torch.kernels import grouping
    from duplexumiconsensusreads_torch.ops import pipeline

    args, kw = group_args
    torch.cuda.synchronize()

    def under_error():
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = pipeline.group_kernel(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        return out

    under_error()
    grouping.directional_cluster = cf.directional_cluster_plain
    try:
        under_error()
        plain_raises = False
    except RuntimeError as e:
        if "synchroniz" not in str(e):
            raise
        plain_raises = True
    finally:
        grouping.directional_cluster = cf.directional_cluster
    if not plain_raises:
        raise AssertionError("the plain directional cluster ran under sync debug mode 'error'")
    n_syncs, sites = implicit_syncs(full, spec)
    emit("sync_debug", group_kernel_shape=list(args[0].shape),
         group_kernel_under_error_mode="ran through",
         plain_directional_cluster_raises=True,
         fused_pipeline_implicit_syncs=n_syncs, fused_pipeline_sync_sites=sites,
         nvidia_smi=smi)


def implicit_syncs(full, spec) -> tuple[int, dict]:
    """fused_pipeline on ``full`` under torch.cuda.set_sync_debug_mode
    ("warn"): the implicit host syncs it makes, and their file:line
    sites. A step that syncs cannot be captured as a graph."""
    import collections
    import warnings

    import torch

    from duplexumiconsensusreads_torch.ops import pipeline

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            pipeline.fused_pipeline(*full, spec)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    syncs = [w for w in caught if "synchronizing CUDA operation" in str(w.message)]
    sites = collections.Counter(
        f"{os.path.relpath(w.filename, HERE)}:{w.lineno}" for w in syncs)
    return len(syncs), dict(sites)


# buckets of the graphs phase's second class (the main class's first
# buckets: another shape, so another graph)
GRAPHS_SMALL_BUCKETS = 64


def graphs_phase(full, spec, smi: str) -> dict:
    """runtime/graphs.py on the card, at the main whole-file class (the
    stages rerun's inputs) and a class of its first
    GRAPHS_SMALL_BUCKETS buckets, every output held bit for bit against
    the eager step: the main class eager, captured, replayed; a replay
    on other inputs of that class (its buckets reversed), then on the
    first again (no stale static buffer); the two classes A, B, A, B,
    A, B on one lane; one class on two streams at once (two replays in
    flight on other inputs); the packed epilogue at two k_pad values
    (eager, captured, replayed each) against the eager compaction of the
    eager step. Each replay adds the step's launches (the counts equal
    one eager step's per call); implicit syncs at every captured shape
    (0); segment_gemm past MAX_GRID_Z buckets (two launches in one
    call) captured and replayed, bit for bit against its plain version;
    capture seconds, replay enqueue ms and each lane's pool bytes.
    Returns the counts and pool bytes."""
    import torch

    from duplexumiconsensusreads_torch.interop import ARRAY_KEYS
    from duplexumiconsensusreads_torch.ops import pipeline
    from duplexumiconsensusreads_torch.ops.pipeline import _pow2
    from duplexumiconsensusreads_torch.runtime import graphs
    from duplexumiconsensusreads_torch.runtime.executor import _pack_d2h, pack_fetch_outputs

    t_phase = time.monotonic()
    graphs.clear()
    a = dict(zip(ARRAY_KEYS, full))
    other = {k: v.flip(0).contiguous() for k, v in a.items()}
    small = {k: v[:GRAPHS_SMALL_BUCKETS].contiguous() for k, v in a.items()}

    def eager(args):
        out = pipeline.fused_pipeline(*(args[k] for k in ARRAY_KEYS), spec)
        return {k: v.clone() for k, v in out.items()}

    torch.cuda.synchronize()
    reset_launches()
    ref = {"a": eager(a)}
    per_step = {k: fn.launches for k, fn in kernel_wrappers().items()}
    ref["other"], ref["small"] = eager(other), eager(small)
    if all(torch.equal(ref["a"][k], ref["other"][k]) for k in ref["a"]):
        raise AssertionError("graphs: the reversed class gave the same outputs")
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    torch.cuda.synchronize()
    reset_launches()
    n_calls = [0]
    enqueue_ms = []

    def step(args, stream):
        with torch.cuda.stream(stream):
            t0 = time.perf_counter()
            out, (mode, _) = graphs.run_step(args, spec, ARRAY_KEYS)
            if mode == "replayed":
                enqueue_ms.append((time.perf_counter() - t0) * 1e3)
        n_calls[0] += 1
        return out, mode

    def held(out, name) -> bool:
        torch.cuda.synchronize()
        return all(torch.equal(out[k], ref[name][k]) for k in ref[name])

    cases = {}
    rows = [step(a, s1) for _ in range(3)]
    cases["main_class"] = [(m, held(o, "a")) for o, m in rows]
    o1, m1 = step(other, s1)
    ok1 = held(o1, "other")
    o2, m2 = step(a, s1)
    cases["other_inputs_then_first"] = [(m1, ok1), (m2, held(o2, "a"))]
    seq = []
    for name in ("small", "a", "small", "a", "small", "a"):
        o, m = step(small if name == "small" else a, s1)
        seq.append((name, m, held(o, name)))
    cases["interleaved_on_one_lane"] = seq
    two = [step(a, s2)[1], step(a, s2)[1]]
    torch.cuda.synchronize()
    x, mx = step(a, s1)  # both replays queued before either is read
    y, my = step(other, s2)
    cases["two_streams_at_once"] = two + [(mx, held(x, "a")), (my, held(y, "other"))]
    distinct = all(x[k].data_ptr() != y[k].data_ptr() for k in x if x[k].numel())
    # the packed epilogue on the main class's replayed outputs (s1's,
    # holding the main class now)
    duplex = spec.consensus.mode == "duplex"
    n_out = x["n_molecules" if duplex else "n_families"].clamp(0, x["cons_valid"].shape[1])
    k1 = min(_pow2(int(n_out.sum())), x["cons_valid"].numel())
    epi = []
    for kp in (k1, 2 * k1):
        want = _pack_d2h(ref["a"], duplex, kp)
        for _ in range(3):
            before = graphs.read_counts()["epilogue"]
            with torch.cuda.stream(s1):
                got = pack_fetch_outputs(x, spec, kp)
            torch.cuda.synchronize()
            after = graphs.read_counts()["epilogue"]
            mode = next(m for m in graphs.MODES if after[m] > before[m])
            epi.append((kp, mode, all(torch.equal(got[k], want[k]) for k in want)))
    cases["epilogue_two_k_pad"] = epi
    flat = ([ok for _, ok in cases["main_class"]]
            + [ok for _, ok in cases["other_inputs_then_first"]]
            + [ok for *_, ok in seq] + [ok for _, ok in cases["two_streams_at_once"][2:]]
            + [ok for *_, ok in epi])
    if not all(flat) or not distinct:
        raise AssertionError(f"graphs: replayed outputs differ from eager: {cases}")
    modes = [m for m, _ in cases["main_class"]]
    if modes != ["eager", "captured", "replayed"] or [m for _, m, _ in epi[:3]] != modes:
        raise AssertionError(f"graphs: modes {cases}")
    counts = graphs.read_counts()
    launches = {k: fn.launches for k, fn in kernel_wrappers().items()}
    want_l = {k: n * n_calls[0] for k, n in per_step.items()}
    if launches != want_l:
        raise AssertionError(f"graphs: launches {launches} over {n_calls[0]} steps, "
                             f"want {want_l} ({per_step} a step)")
    # segment_gemm past MAX_GRID_Z buckets, which one call queues as
    # several launches, captured and replayed: the tally holds each
    from duplexumiconsensusreads_torch.kernels import build
    from duplexumiconsensusreads_torch.kernels import segment_gemm as sg

    gen = torch.Generator(device="cuda").manual_seed(1)
    nb = sg.MAX_GRID_Z + 5
    big = sg.pad_rows(torch.randn(nb, 8, 13, device="cuda", generator=gen))
    fid = torch.randint(-1, 6, (nb, 8), device="cuda", generator=gen, dtype=torch.int32)
    want = sg.segment_gemm_plain(big, fid, 5)
    s3 = torch.cuda.Stream()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.stream(s3):
        sg.segment_gemm(big, fid, 5)
        with build.tally_launches() as tally:
            g.capture_begin()
            got = sg.segment_gemm(big, fid, 5)
            g.capture_end()
        g.replay()
    torch.cuda.synchronize()
    past_z = {"buckets": nb, "launches_in_graph": tally.get(sg.segment_gemm, 0),
              "bit_identical": bool(torch.equal(got, want))}
    if past_z["launches_in_graph"] != 2 or not past_z["bit_identical"]:
        raise AssertionError(f"graphs: segment_gemm past MAX_GRID_Z {past_z}")
    del g, got, want, big, fid
    syncs = {"main_class": implicit_syncs(full, spec),
             "small_class": implicit_syncs(tuple(small[k] for k in ARRAY_KEYS), spec)}
    if any(n for n, _ in syncs.values()):
        raise AssertionError(f"graphs: implicit syncs at a captured shape: {syncs}")
    pools = graphs.pool_bytes()
    emit("graphs", shapes={"main_class": list(full[0].shape),
                           "small_class": list(small["pos"].shape)},
         cases=cases, all_bit_identical=True, static_buffers_distinct_per_stream=distinct,
         segment_gemm_past_max_grid_z=past_z,
         launches=launches, launches_per_step=per_step, steps=n_calls[0],
         counts=counts, capture_s=counts["step"]["capture_s"],
         replay_enqueue_ms=[round(t, 3) for t in enqueue_ms],
         fused_pipeline_implicit_syncs={k: n for k, (n, _) in syncs.items()},
         sync_sites={k: v for k, (_, v) in syncs.items()},
         pool_bytes=pools, lru_bound={"step_graphs_per_lane": graphs.MAX_GRAPHS,
                                      "static_bytes_per_lane": graphs.MAX_LANE_STATIC_BYTES,
                                      "epilogues_per_step_graph": graphs.MAX_EPILOGUES},
         phase_seconds=round(time.monotonic() - t_phase, 3), nvidia_smi=smi)
    del x, y, o1, o2, rows, ref
    graphs.clear()
    torch.cuda.empty_cache()
    return {"counts": counts, "pool_bytes": pools}


def stream_turns(in_bam: str, out_bam: str, gp, cp, settings: dict, td: str, smi: str) -> None:
    """The stream cell again in two turns, plain directional cluster then
    kernel (the plain version patched into grouping as the phases'
    wrappers patch modules): each turn's reads/s, dispatch and
    device_wait_fetch busy seconds and wire floor (from its capture), and
    bytes identical to the stream phase's output."""
    import torch

    from duplexumiconsensusreads_torch.kernels import cluster_fixpoint as cf
    from duplexumiconsensusreads_torch.kernels import grouping
    from duplexumiconsensusreads_torch.runtime import graphs
    from duplexumiconsensusreads_torch.runtime.stream import stream_call_consensus
    from duplexumiconsensusreads_torch.telemetry import ledger, report

    want = read_bytes(out_bam)
    rows = []
    for i, turn in enumerate(("plain", "kernel")):
        out = os.path.join(td, f"turn{i}.bam")
        trace = os.path.join(td, f"turn{i}.trace.jsonl")
        if turn == "plain":
            grouping.directional_cluster = cf.directional_cluster_plain
        torch.cuda.synchronize()
        reset_launches()
        try:
            # the plain cluster checks its fixpoint on the host, which a
            # graph capture forbids: its turn runs eagerly
            with graphs.disabled() if turn == "plain" else contextlib.nullcontext():
                t0 = time.monotonic()
                rep = stream_call_consensus(in_bam, out, gp, cp, device="cuda",
                                            trace_path=trace, **settings)
                wall = time.monotonic() - t0
        finally:
            grouping.directional_cluster = cf.directional_cluster
        add_graph_modes(f"stream_turns_{turn}", graph_modes(graphs.read_counts()))
        n_fix = cf.directional_cluster.launches
        if (n_fix > 0) != (turn == "kernel"):
            raise AssertionError(f"turn {i} ({turn}): {n_fix} directional_cluster launches")
        if read_bytes(out) != want:
            raise AssertionError(f"turn {i} ({turn}): output differs from the stream phase's")
        recs = report.load_trace(trace)
        rows.append({
            "turn": turn, "wall_seconds": round(wall, 3),
            "reads_per_s": round(rep.n_valid_reads / wall, 1),
            "dispatch_busy_s": rep.seconds["dispatch"],
            "device_wait_fetch_busy_s": rep.seconds["device_wait_fetch"],
            "main_loop_stall_share": rep.seconds["main_loop_stall"] / wall,
            "wire_floor": ledger.wire_floor(recs), "directional_cluster_launches": n_fix,
            "segment_gemm_launches": kernel_wrappers()["segment_gemm"].launches,
            "bytes_identical_to_stream": True})
        os.remove(out)
        os.remove(trace)
    emit("stream_turns", config="config5 (min_duplex_reads=1)", settings=settings,
         reads_in=rep.n_records, turns=rows, nvidia_smi=smi)


def reader_phase(in_bam: str) -> None:
    """The e2e input through the native and the portable load_input:
    identical ReadBatch arrays and counters."""
    import numpy as np

    from duplexumiconsensusreads_torch.io import load_input

    t0 = time.monotonic()
    _, nb, ninfo = load_input(in_bam, duplex=True, warn_mixed=False)
    nat_s = time.monotonic() - t0
    os.environ["DUT_NO_NATIVE"] = "1"
    try:
        t0 = time.monotonic()
        _, pb, pinfo = load_input(in_bam, duplex=True, warn_mixed=False)
        port_s = time.monotonic() - t0
    finally:
        del os.environ["DUT_NO_NATIVE"]
    for f in ("bases", "quals", "umi", "pos_key", "strand_ab", "frag_end", "valid"):
        x, y = np.asarray(getattr(nb, f)), np.asarray(getattr(pb, f))
        if x.dtype != y.dtype or not np.array_equal(x, y):
            raise AssertionError(f"native and portable readers differ in {f}")
    if not ninfo.get("native") or "native" in pinfo or any(
            ninfo[k] != pinfo[k] for k in pinfo):
        raise AssertionError("native and portable reader counters differ")
    emit("reader", reads=ninfo["n_records"], valid_reads=ninfo["n_valid"],
         native_seconds=round(nat_s, 3), portable_seconds=round(port_s, 3),
         portable_over_native=round(port_s / nat_s, 2), identical=True)


def per_base_phase(in_bam: str, small_bam: str, td: str, gp, cp):
    """The e2e call with per_base_tags and write_index, at full width.
    Returns (the segment_gemm capture holding the largest call's ids,
    the fused_pipeline capture of the largest class, launches)."""
    import numpy as np
    import torch

    from duplexumiconsensusreads_torch.io import read_bam
    from duplexumiconsensusreads_torch.kernels import consensus
    from duplexumiconsensusreads_torch.ops import pipeline
    from duplexumiconsensusreads_torch.runtime.executor import call_consensus_file

    out = os.path.join(td, "per_base.bam")
    torch.cuda.synchronize()
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    with Capture(consensus, "segment_gemm", keep=(1,)) as cap_k, \
            Capture(pipeline, "fused_pipeline") as cap_p:
        rep = call_consensus_file(in_bam, out, gp, cp, capacity=CAPACITY, device="cuda",
                                  per_base_tags=True, write_index=True)
    wall = time.monotonic() - t0
    launches = read_launches("per_base")
    peak_mem = torch.cuda.max_memory_allocated()
    widths = sorted({s[-1] for s in cap_k.shapes})
    header, recs = read_bam(out)
    l_max = int(np.asarray(recs.lengths).max())
    c_full = 9 * l_max + 1
    if c_full not in widths:
        raise AssertionError(f"per-base path: segment_gemm at widths {widths}, "
                             f"want C = {c_full}")
    if len(recs) != rep.n_consensus or rep.n_consensus == 0:
        raise AssertionError(f"output has {len(recs)} records, report {rep.n_consensus}")
    for i, aux in enumerate(recs.aux_raw):
        tags = per_base_tags(aux)[1]
        if set(tags) != {b"cd", b"ce"} or any(len(v) != recs.lengths[i] for v in tags.values()):
            raise AssertionError(f"record {i} lacks per-base cd/ce of its length")
    if not os.path.exists(out + ".bai"):
        raise AssertionError("write_index wrote no .bai")
    # one region through the port's CLI, against a filter of the output
    on0 = np.nonzero(np.asarray(recs.ref_id) == 0)[0]
    mid = int(np.median(np.asarray(recs.pos)[on0]))
    beg, end = max(mid - 5000, 1), mid + 5000
    region = f"{header.ref_names[0]}:{beg}-{end}"
    sub = os.path.join(td, "per_base_region.bam")
    t0 = time.monotonic()
    r = subprocess.run([sys.executable, "-m", "duplexumiconsensusreads_torch", "view", out,
                        region, "-o", sub, "--json"], cwd=HERE, capture_output=True,
                       text=True, timeout=600)
    view_s = time.monotonic() - t0
    if r.returncode != 0:
        raise AssertionError(f"view failed: {r.stderr[-2000:]}")
    spans = np.array([sum(n for n, op in cg if op in "MDN=X") or 1 for cg in recs.cigars])
    pos = np.asarray(recs.pos)
    want = [recs.names[i] for i in np.nonzero(
        (np.asarray(recs.ref_id) == 0) & (pos < end) & (pos + spans > beg - 1))[0]]
    got = read_bam(sub)[1]
    if got.names != want or json.loads(r.stdout)["n_records"] != len(want) or not want:
        raise AssertionError(f"view {region}: {len(got)} records, the filter {len(want)}")
    emit("per_base", config="config5", capacity=CAPACITY, reads_in=rep.n_records,
         consensus_out=rep.n_consensus, wall_seconds=round(wall, 3),
         read_input_seconds=round(rep.seconds["read_input"], 3),
         stage_seconds={k: round(v, 3) for k, v in rep.seconds.items()},
         max_memory_allocated=peak_mem, bytes_d2h=rep.bytes_d2h,
         launches=launches, segment_gemm_widths=widths,
         full_pass_columns=c_full, every_record_has_cd_ce=True, bai=True,
         view={"region": region, "records": len(want), "equal_to_filter": True,
               "seconds": round(view_s, 3)})
    del recs, got

    # card against CPU on the small input, per-base tags and index on
    outs = {}
    for d in ("cuda", "cpu"):
        path = os.path.join(td, f"small_pb_{d}.bam")
        call_consensus_file(small_bam, path, gp, cp, capacity=256, device=d,
                            per_base_tags=True, write_index=True)
        outs[d] = read_bam(path)[1]
    emit("per_base_small_reference", **compare_records(outs["cuda"], outs["cpu"], qual_tol=2,
                                                       duplex_ties=True, per_base=True))
    return cap_k, cap_p, launches


def cli(*argv) -> tuple[str, float]:
    """One in-process run of the port's CLI: (its stdout, its seconds).
    Raises when it does not return 0."""
    import io

    from duplexumiconsensusreads_torch.cli.main import main as cli_main

    buf = io.StringIO()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(buf):
        rc = cli_main([str(a) for a in argv])
    if rc != 0:
        raise AssertionError(f"{argv[0]} exited {rc}")
    return buf.getvalue(), time.monotonic() - t0


def mi_partition(path: str) -> set:
    """The read partition of a ``group`` output: the sets of record
    indices that share an MI value (the labels themselves left out)."""
    from duplexumiconsensusreads_torch.io import read_bam
    from duplexumiconsensusreads_torch.io.bam import iter_aux_fields

    groups: dict = {}
    for i, aux in enumerate(read_bam(path)[1].aux_raw):
        mi = [aux[vs:end] for _, tag, _, vs, end in iter_aux_fields(aux) if tag == b"MI"]
        groups.setdefault(mi[0] if mi else None, []).append(i)
    return {frozenset(v) for k, v in groups.items() if k is not None}


def workflow_phase(in_bam: str, cfg, small_bam: str, td: str) -> int:
    """The fgbio-style workflow through ``cli.main.main`` on the card, at
    full width: simulate -> call (a JSON --config-file setting every
    config5 parameter, per-base tags, index) -> filter -> validate (call
    and filter outputs) -> group. Then, on the small input, group and
    call on the card against the cpu backend, and stats. Returns
    segment_gemm's launches on the full-width chain."""
    import torch

    from duplexumiconsensusreads_torch.io import read_bam
    from duplexumiconsensusreads_torch.kernels import segment_gemm as sg
    from duplexumiconsensusreads_torch.runtime.executor import resolve_device
    from duplexumiconsensusreads_torch.simulate import SimConfig

    # the CLI's simulate flags must express the e2e input in full
    free = {"qual_lo", "qual_hi", "n_frac"}
    if any(getattr(cfg, f) != getattr(SimConfig(), f) for f in free):
        raise AssertionError("the e2e SimConfig sets a field simulate has no flag for")
    t_phase = time.monotonic()
    w = os.path.join(td, "wf")
    os.makedirs(w)
    conf = os.path.join(w, "config5.json")
    with open(conf, "w") as f:
        json.dump({"config": "config5", "grouping": "adjacency", "mode": "duplex",
                   "error_model": "cycle", "max_hamming": 1, "count_ratio": 2,
                   "min_reads": 1, "min_duplex_reads": 1, "max_qual": 90,
                   "max_input_qual": 50, "min_input_qual": 0, "capacity": CAPACITY,
                   "backend": "cuda", "mate_aware": "auto", "read_group_id": "A"}, f)
    p = {k: os.path.join(w, k) for k in ("in.bam", "truth.npz", "call.bam", "filter.bam",
                                        "group.bam")}
    secs = {}
    torch.cuda.synchronize()
    reset_launches()
    _, secs["simulate"] = cli(
        "simulate", "-o", p["in.bam"], "--truth", p["truth.npz"], "--sorted",
        "--molecules", cfg.n_molecules, "--read-len", cfg.read_len, "--umi-len", cfg.umi_len,
        "--positions", cfg.n_positions, "--family-size", cfg.mean_family_size,
        "--max-family-size", cfg.max_family_size, "--base-error", cfg.base_error,
        "--cycle-error-slope", cfg.cycle_error_slope, "--umi-error", cfg.umi_error,
        "--indel-error", cfg.indel_error, "--seed", cfg.seed,
        *([] if cfg.duplex else ["--single-strand"]),
        *(["--paired-reads"] if cfg.paired_reads else []),
    )
    if read_bytes(p["in.bam"]) != read_bytes(in_bam):
        raise AssertionError("simulate's BAM differs from the e2e phase's input")
    rep_out, secs["call"] = cli("call", p["in.bam"], "-o", p["call.bam"], "--config-file", conf,
                                "--per-base-tags", "--write-index", "--report", "-")
    rep = json.loads(rep_out)
    call_launches = sg.segment_gemm.launches
    if call_launches == 0 or rep["backend"] != "cuda" or rep["device"] != str(resolve_device()):
        raise AssertionError(f"call: {call_launches} segment_gemm launches on "
                             f"{rep['backend']}/{rep['device']}")
    if not os.path.exists(p["call.bam"] + ".bai"):
        raise AssertionError("call --write-index wrote no .bai")
    _, secs["filter"] = cli("filter", p["call.bam"], "-o", p["filter.bam"],
                            "--min-base-depth", 2, "--max-base-error-rate", 0.1)
    val = {}
    for name in ("call.bam", "filter.bam"):
        out, secs[f"validate_{name[:-4]}"] = cli("validate", p[name], "--truth",
                                                 p["truth.npz"], "--json")
        val[name[:-4]] = v = json.loads(out)
        if not (v["n_matched_to_truth"] > 0 and v["error_rate"] < cfg.base_error / 10):
            raise AssertionError(f"validate {name}: {v}")
    out, secs["group"] = cli("group", p["in.bam"], "-o", p["group.bam"], "--duplex", "--json")
    grp = json.loads(out)
    if not 0 < grp["group_kernel_launches"] < grp["buckets"] or grp["device"] != "cuda":
        raise AssertionError(f"group: {grp}")
    launches = read_launches("workflow")
    n_filtered = len(read_bam(p["filter.bam"])[1])

    # the small input: the card against the cpu backend, then stats
    small = {}
    for backend in ("cuda", "cpu"):
        out = os.path.join(w, f"small_group_{backend}.bam")
        _, small[f"group_{backend}_seconds"] = cli("group", small_bam, "-o", out, "--duplex",
                                                   "--capacity", 256, "--backend", backend)
        small[f"group_{backend}"] = mi_partition(out)
    if small.pop("group_cuda") != small.pop("group_cpu"):
        raise AssertionError("group: the card's read partition differs from the cpu backend's")
    # config3: the device path fits config5's cycle model per bucket and
    # the oracle per file, in the JAX package too (ROADMAP Faults found
    # 5), so only a model-free call compares across the two backends
    outs = {}
    for backend in ("cuda", "cpu"):
        outs[backend] = os.path.join(w, f"small_call_{backend}.bam")
        _, small[f"call_{backend}_seconds"] = cli(
            "call", small_bam, "-o", outs[backend], "--config", "config3", "--capacity", 256,
            "--backend", backend)
    small["call_card_vs_cpu_backend"] = compare_records(
        read_bam(outs["cuda"])[1], read_bam(outs["cpu"])[1], qual_tol=2, duplex_ties=True)
    out, small["stats_seconds"] = cli("stats", small_bam, "--duplex", "--json")
    small["stats_molecules"] = json.loads(out)["n_molecules"]
    emit("workflow", config="config5 (JSON --config-file)", reads_in=rep["n_records"],
         consensus_out=rep["n_consensus"], filtered_records=n_filtered,
         step_seconds={k: round(v, 3) for k, v in secs.items()},
         chain_seconds=round(sum(secs.values()), 3), simulate_bytes_equal_e2e_input=True,
         call_stage_seconds={k: round(v, 3) for k, v in rep["seconds"].items()},
         launches=launches, validate=val, group=grp,
         base_error=cfg.base_error, small_input=small,
         phase_seconds=round(time.monotonic() - t_phase, 3))
    return launches


def operators_phase() -> int:
    """UmiGrouper + ConsensusCaller with the cuda backend against the cpu
    (oracle) backend on a small duplex batch with the cycle model.
    Returns segment_gemm's launches in the cuda run."""
    import numpy as np
    import torch

    from duplexumiconsensusreads_torch.ops import ConsensusCaller, UmiGrouper
    from duplexumiconsensusreads_torch.simulate import SimConfig, simulate_batch
    from duplexumiconsensusreads_torch.types import ConsensusParams, GroupingParams

    t_phase = time.monotonic()
    batch, _ = simulate_batch(SimConfig(n_molecules=200, read_len=150, n_positions=10,
                                        umi_error=0.01, cycle_error_slope=0.001,
                                        duplex=True, seed=5))
    gp = GroupingParams(strategy="adjacency", paired=True)
    cp = ConsensusParams(mode="duplex", error_model="cycle")
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.monotonic()
    fams = UmiGrouper(gp, backend="cuda")(batch)
    cons = ConsensusCaller(cp, backend="cuda")(batch, fams)
    cuda_s = time.monotonic() - t0
    launches = read_launches("operators")
    t0 = time.monotonic()
    ofams = UmiGrouper(gp, backend="cpu")(batch)
    ocons = ConsensusCaller(cp, backend="cpu")(batch, ofams)
    cpu_s = time.monotonic() - t0
    for f in ("family_id", "molecule_id", "pair_id", "n_families", "n_molecules"):
        if not np.array_equal(np.asarray(getattr(fams, f)), np.asarray(getattr(ofams, f))):
            raise AssertionError(f"operators: UmiGrouper {f} differs between backends")
    for f in ("valid", "depth"):
        if not np.array_equal(np.asarray(getattr(cons, f)), np.asarray(getattr(ocons, f))):
            raise AssertionError(f"operators: ConsensusCaller {f} differs between backends")
    sa, sb = np.asarray(cons.bases), np.asarray(ocons.bases)
    qa, qb = np.asarray(cons.quals).astype(int), np.asarray(ocons.quals).astype(int)
    dq = np.abs(qa - qb)
    # a near-tie (a strand tie, or two strands of near-equal quality that
    # disagree) may call another base, both sides at qual <= 2 * TIE_QUAL;
    # a strand tie under an agreeing call moves the duplex qual by at most
    # 2 * TIE_QUAL + 2
    tie = (((sa != sb) & (qa <= 2 * TIE_QUAL) & (qb <= 2 * TIE_QUAL))
           | ((sa == sb) & (dq > 2) & (dq <= 2 * TIE_QUAL + 2)))
    if ((sa != sb) & ~tie).any() or (np.where(tie, 0, dq) > 2).any():
        raise AssertionError("operators: consensus outside the parity bar")
    # f32 against the oracle's f64 under the cycle model's capped quals:
    # near-ties are far more frequent than between two f32 runs (the JAX
    # package's own tpu and cpu operators show ~1 in 700 cycles here)
    if int(tie.sum()) * 200 > sa.size:
        raise AssertionError(f"operators: {int(tie.sum())} tie cycles of {sa.size}: "
                             f"more than 1 in 200")
    emit("operators", reads=int(np.asarray(batch.valid).sum()),
         families=int(fams.n_families), molecules=int(fams.n_molecules),
         consensus=int(np.asarray(cons.valid).sum()), ids_identical=True,
         tie_cycles=int(tie.sum()), cycles=int(sa.size), max_qual_diff=int(dq.max(initial=0)),
         launches=launches, cuda_seconds=round(cuda_s, 3),
         cpu_backend_seconds=round(cpu_s, 3), phase_seconds=round(time.monotonic() - t_phase, 3))
    return launches


def stream_phases(gp, smi: str, bench_cache: str, launches: dict):
    """The streaming path: the "stream", "stream_turns", "live", "serve",
    "shard", "fleet", "multihost", "stream_small_reference",
    "stream_resume", "ladder" and "capture" phases, on the bench's e2e
    input simulated into ``bench_cache``. Fills ``launches`` for the
    stream, live, serve, shard, multihost and ladder paths and returns
    the ladder run's largest launch at each explicit rung."""
    import numpy as np
    import torch

    from duplexumiconsensusreads_torch import benchmark
    from duplexumiconsensusreads_torch.io import native_reader, read_bam, simulated_bam
    from duplexumiconsensusreads_torch.io.bai import build_bai
    from duplexumiconsensusreads_torch.ops import pipeline
    from duplexumiconsensusreads_torch.runtime import faults
    from duplexumiconsensusreads_torch.runtime.executor import busy_wall_table
    from duplexumiconsensusreads_torch.runtime.stream import stream_call_consensus
    from duplexumiconsensusreads_torch.simulate import SimConfig

    # the bench's e2e workload (benchmark.py _e2e_params / _e2e_input):
    # config5 with min_duplex_reads=1, ~8 reads per molecule
    _, cp = benchmark._e2e_params()
    settings = dict(capacity=CAPACITY, chunk_reads=STREAM_CHUNK_READS, max_inflight=4,
                    drain_workers=2, prefetch_depth=2, packed="auto", d2h_packed="auto",
                    ingest_overlap="auto")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_stream_") as td:
        out_bam = os.path.join(td, "out.bam")
        trace = os.path.join(td, "stream.trace.jsonl")
        # an explicit checkpoint keeps the manifest (and each shard's
        # deflate codec) after the run
        ckpt = os.path.join(td, "stream.ckpt")
        in_bam, sim_s = benchmark._e2e_input(STREAM_READS, bench_cache)
        torch.cuda.synchronize()
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        ref_ev = torch.cuda.Event(enable_timing=True)
        ref_ev.record()
        t0 = time.monotonic()
        # keep no arguments: only each call's CUDA events (recorded on
        # the calling transfer worker's stream)
        with Capture(pipeline, "fused_pipeline", keep=()) as cap, \
                Tally(native_reader, "batch_from_offsets", lambda r: r[1]["native"]) as t_read:
            rep = stream_call_consensus(in_bam, out_bam, gp, cp, device="cuda",
                                        trace_path=trace, checkpoint_path=ckpt, **settings)
        wall = time.monotonic() - t0
        launches["stream"] = read_launches("stream")
        peak_mem = torch.cuda.max_memory_allocated()
        if rep.n_chunks < 4:
            raise AssertionError(f"{rep.n_chunks} chunks: the stream phase wants >= 4")
        with open(ckpt) as f:
            done = json.load(f)["done"]
        codecs = sorted({e["codec"] for e in done.values()})
        if len(done) != rep.n_chunks or codecs != ["native"]:
            raise AssertionError(f"{len(done)} shards of {rep.n_chunks} chunks, codecs {codecs}")
        if len(t_read.seen) < rep.n_chunks or not all(t_read.seen):
            raise AssertionError(f"native chunk parses: {t_read.seen}")
        torch.cuda.synchronize()
        spans = [(ref_ev.elapsed_time(a), ref_ev.elapsed_time(b)) for a, b in cap.events]
        union_ms = interval_union_ms(spans)
        check = trace_sum_check(trace, rep.seconds)
        recs = [json.loads(line) for line in open(trace)]
        # each class dispatch's rungs: H2D from its h2d record's bits
        # per cycle, D2H from its d2h record (wire below logical = packed)
        h2d_rungs = [
            {"chunk": r["chunk"], "cap": r["cap"], "rows_real": r["rows_real"],
             "rung": {16: "off", 8: "byte"}.get(r["bpc"], f"subbyte-{r['bpc']}bit")}
            for r in recs if r["type"] == "xfer" and r["dir"] == "h2d"
        ]
        d2h_rungs = [
            {"chunk": r["chunk"], "rung": "packed" if r["wire"] < r["logical"] else "off"}
            for r in recs if r["type"] == "xfer" and r["dir"] == "d2h"
        ]
        summary = recs[-1]
        _, out_recs = read_bam(out_bam)
        if len(out_recs) != rep.n_consensus or rep.n_consensus == 0:
            raise AssertionError(f"output has {len(out_recs)} records, report {rep.n_consensus}")
        if np.asarray(out_recs.qual).max() > cp.max_qual or rep.n_valid_reads < 0.9 * STREAM_READS:
            raise AssertionError("consensus quals out of range or input too small")
        table, bugs = busy_wall_table(rep.seconds, settings["drain_workers"])
        if bugs:
            raise AssertionError(f"busy-time accounting bug in {bugs}")
        emit(
            "stream", config="config5 (min_duplex_reads=1)", settings=settings,
            reads_in=rep.n_records, valid_reads=rep.n_valid_reads,
            consensus_out=rep.n_consensus, sim_seconds=sim_s,
            n_chunks=rep.n_chunks, buckets=rep.n_buckets, dispatch_specs=rep.n_pipeline_compiles,
            wall_seconds=round(wall, 3), reads_per_s=round(rep.n_valid_reads / wall, 1),
            stage_seconds=rep.seconds, busy_wall_table=table,
            main_loop_stall_share=rep.seconds["main_loop_stall"] / wall,
            drain_utilization=rep.seconds["drain_utilization"],
            bytes_h2d=rep.bytes_h2d, bytes_d2h=rep.bytes_d2h, bytes_ledger=summary["bytes"],
            h2d_rungs=h2d_rungs, d2h_rungs=d2h_rungs,
            first_call_seconds=[r["compile_s"] for r in recs if r.get("name") == "jit_compile"],
            max_memory_allocated=peak_mem, launches=launches["stream"],
            fused_pipeline_calls=len(spans),
            fused_pipeline_span_ms=[round(b - a, 3) for a, b in spans],
            fused_pipeline_span_sum_ms=sum(b - a for a, b in spans),
            fused_pipeline_union_ms=union_ms,
            pipeline_union_share_of_wall=union_ms / 1e3 / wall,
            native=True, native_chunk_parses=len(t_read.seen), deflate="native",
            shard_codecs=codecs, trace_sum_check=check, nvidia_smi=smi,
        )
        del cap, recs, out_recs
        stream_turns(in_bam, out_bam, gp, cp, settings, td, smi)
        # ---- the service path: follow mode, the daemon, scatter-gather
        launches["live"] = live_phase(in_bam, out_bam, gp, cp, settings, td, smi)
        smalls = [benchmark._e2e_input(n, bench_cache)[0] for n in SERVE_SMALL_READS]
        launches["serve"], ref_large, ref_wall, spools = serve_phase(in_bam, smalls, td, smi)
        launches["shard"], shard_spool = shard_phase(in_bam, ref_large, ref_wall, td, smi)
        spools["shard"] = (shard_spool, None)
        fleet_phase(spools, td, smi)
        launches["multihost"] = multihost_phase(smalls[-1], td, smi)
        torch.cuda.empty_cache()
        launches["mesh"], launches["mesh_lanes"] = mesh_phase(smalls[-1], in_bam, td, smi)
        torch.cuda.empty_cache()
        launches["chaos"] = chaos_phase(smalls[-1], td, smi)
        torch.cuda.empty_cache()

        # ---- stream_small_reference: card vs CPU, then the knobs
        small = os.path.join(td, "small.bam")
        simulated_bam(SimConfig(n_molecules=400, read_len=150, n_positions=10, umi_error=0.01,
                                duplex=True, paired_reads=True, seed=3), path=small, sort=True)
        kw = dict(capacity=256, chunk_reads=600)

        def run(name, device="cuda", **knobs):
            path = os.path.join(td, f"small_{name}.bam")
            r = stream_call_consensus(small, path, gp, cp, device=device, **kw, **knobs)
            with open(path, "rb") as f:
                return r, f.read(), path

        ref_rep, ref_bytes, ref_path = run("cuda")
        _, _, cpu_path = run("cpu", device="cpu")
        if ref_rep.n_chunks < 3 or not ref_rep.mate_aware:
            raise AssertionError("the small reference wants >= 3 chunks of paired mates")
        parity = compare_records(read_bam(ref_path)[1], read_bam(cpu_path)[1], qual_tol=2,
                                 duplex_ties=True)
        same = {}
        for name, knobs in (("packed_off", dict(packed="off")),
                            ("d2h_packed_off", dict(d2h_packed="off")),
                            ("drain_workers_1", dict(drain_workers=1)),
                            ("ingest_overlap_off", dict(ingest_overlap="off")),
                            ("ingest_overlap_on", dict(ingest_overlap="on"))):
            r, b, _ = run(name, **knobs)
            if b != ref_bytes:
                raise AssertionError(f"stream output bytes moved with {knobs}")
            same[name] = {"identical": True, "bytes_h2d": r.bytes_h2d, "bytes_d2h": r.bytes_d2h}
        # per-base tags + index: card against CPU, and the .bai is the
        # one build_bai makes of the output
        pb = {}
        for d in ("cuda", "cpu"):
            r, b, path = run(f"per_base_{d}", device=d, per_base_tags=True, write_index=True)
            if read_bytes(path + ".bai") != read_bytes(build_bai(path, path + ".check.bai")):
                raise AssertionError(f"the {d} run's .bai is not build_bai's")
            pb[d] = (r, path)
        per_base = compare_records(read_bam(pb["cuda"][1])[1], read_bam(pb["cpu"][1])[1],
                                   qual_tol=2, duplex_ties=True, per_base=True)
        # the portable codec: the same chunks and records as the native run
        os.environ["DUT_NO_NATIVE"] = "1"
        try:
            r, _, path = run("no_native")
        finally:
            del os.environ["DUT_NO_NATIVE"]
        a, b = read_bam(ref_path)[1], read_bam(path)[1]
        if (r.n_chunks != ref_rep.n_chunks or a.names != b.names or list(a.aux_raw) != list(b.aux_raw)
                or not np.array_equal(a.seq, b.seq) or not np.array_equal(a.qual, b.qual)):
            raise AssertionError("DUT_NO_NATIVE=1 changed the streamed records")
        emit("stream_small_reference", chunks=ref_rep.n_chunks, card_vs_cpu=parity,
             byte_identical_to_default=same, bytes_h2d=ref_rep.bytes_h2d,
             bytes_d2h=ref_rep.bytes_d2h,
             per_base_write_index={"card_vs_cpu": per_base, "bai_is_build_bai": True,
                                   "bytes_d2h": pb["cuda"][0].bytes_d2h},
             no_native={"chunks": r.n_chunks, "records_identical": True})

        # ---- stream_resume: killed at chunk 1's checkpoint mark (hit 1
        # is the fresh manifest, hit 2 chunk 0's mark), then resumed
        killed = os.path.join(td, "small_killed.bam")
        faults.install(faults.FaultPlan.parse("ckpt.save:3:kill"))
        try:
            stream_call_consensus(small, killed, gp, cp, device="cuda", **kw)
            raise AssertionError("the injected kill did not fire")
        except faults.InjectedKill:
            pass
        finally:
            faults.uninstall()
        with open(killed + ".ckpt") as f:
            committed = len(json.load(f)["done"])
        if committed < 1 or os.path.exists(killed):
            raise AssertionError(f"killed run: {committed} committed chunks")
        r = stream_call_consensus(small, killed, gp, cp, device="cuda", resume=True, **kw)
        with open(killed, "rb") as f:
            if f.read() != ref_bytes:
                raise AssertionError("resumed output differs from the uninterrupted run")
        emit("stream_resume", kill="ckpt.save:3:kill", committed_before_kill=committed,
             chunks_skipped=r.n_chunks_skipped, chunks=r.n_chunks, identical=True)

        launches["ladder"], rung_calls, captures = ladder_phase(
            in_bam, out_bam, gp, cp, settings, td, smi, smalls[-1])
        capture_phase({"stream": (trace, out_bam), **captures}, td, smi)
    return rung_calls


class LaneKeeper:
    """The mesh phase's per-lane view of the kernels. While entered it
    wraps parallel/sharded.py's ``lane_streams`` (in the modules that
    call it) to learn which stream serves which lane, and the two
    kernels' wrappers and ``group_kernel`` at their call sites to keep
    each lane's last inputs. Each lane's launches are the wrappers' own
    counts by (device, stream), read by :meth:`lane_launches`. A lane
    alone on its card runs on the card's current stream, so it is known
    by its card."""

    def __init__(self):
        self.stream_lane, self.card_lane = {}, {}
        self.last = {}
        self._undo = []

    def lane_launches(self) -> dict:
        """{kernel: {lane: launches since reset_launches()}}, from each
        wrapper's count by the device and stream it launched on; a
        launch on a stream of no lane counts under lane -1."""
        per = {}
        for name, fn in kernel_wrappers().items():
            lanes = per[name] = {}
            for (dev, stream), n in fn.stream_launches.items():
                lane = self.stream_lane.get(stream, self.card_lane.get(dev, -1))
                lanes[lane] = lanes.get(lane, 0) + n
        return per

    def lane(self, device, stream=None) -> int:
        import torch

        s = stream or torch.cuda.current_stream(device).cuda_stream
        return self.stream_lane.get(s, self.card_lane.get(device.index, -1))

    def _patch(self, module, name, make):
        inner = getattr(module, name)
        setattr(module, name, make(inner))
        self._undo.append((module, name, inner))

    def __enter__(self):
        import threading

        import torch

        from duplexumiconsensusreads_torch.kernels import consensus, grouping
        from duplexumiconsensusreads_torch.ops import pipeline
        from duplexumiconsensusreads_torch.parallel import sharded
        from duplexumiconsensusreads_torch.runtime import graphs, stream

        lock = threading.Lock()
        # the stream of the step this thread runs: a capture runs on a
        # side stream (runtime/graphs.py), and its kernels are the lane's
        step_stream = threading.local()

        def steps(inner):
            def wrapped(args, *a, **k):
                dev = next(iter(args.values())).device
                step_stream.s = (torch.cuda.current_stream(dev).cuda_stream
                                 if dev.type == "cuda" else None)
                return inner(args, *a, **k)
            return wrapped

        def streams(inner):
            def wrapped(mesh, *a, **k):
                out = inner(mesh, *a, **k)
                with lock:
                    for i, (d, st) in enumerate(zip(mesh.devices, out)):
                        if st is not None:
                            self.stream_lane[st.cuda_stream] = i
                        else:
                            self.card_lane[d.index] = i
                return out
            return wrapped

        def kept(name):
            def make(inner):
                def wrapped(*args, **kwargs):
                    if args[0].is_cuda:
                        s = getattr(step_stream, "s", None) if capturing() else None
                        with lock:
                            self.last[(name, self.lane(args[0].device, s))] = (args, kwargs)
                    return inner(*args, **kwargs)
                return wrapped
            return make

        for mod in (sharded, stream):
            self._patch(mod, "lane_streams", streams)
        self._patch(graphs, "run_step", steps)
        self._patch(consensus, "segment_gemm", kept("segment_gemm"))
        self._patch(grouping, "directional_cluster", kept("directional_cluster"))
        self._patch(pipeline, "group_kernel", kept("group_kernel"))
        return self

    def __exit__(self, *exc):
        for module, name, inner in reversed(self._undo):
            setattr(module, name, inner)

    def reset(self):
        self.last = {}


@contextlib.contextmanager
def enqueue_timer(graphs_module):
    """While entered, times every ``run_step`` call (runtime/graphs.py):
    the host enqueue of one lane's step, eager or replayed (the call
    returns once its work is queued). Yields the list of seconds, in
    call order."""
    inner = graphs_module.run_step
    times = []

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        out = inner(*args, **kwargs)
        times.append(time.perf_counter() - t0)
        return out

    graphs_module.run_step = timed
    try:
        yield times
    finally:
        graphs_module.run_step = inner


@contextlib.contextmanager
def one_card_lanes(n: int):
    """On a one-card machine, the device pool of a CUDA run is ``n``
    lanes of cuda:0, each with its own stream (parallel/mesh.py
    device_pool; the user-facing pools hold distinct cards): how the
    mesh path is driven where there is no second card. A no-op with
    n = 0."""
    import torch

    from duplexumiconsensusreads_torch.parallel import mesh

    inner = mesh.device_pool

    def pool(device="cuda", devices=None):
        if torch.device(device).type == "cuda" and not devices:
            return [torch.device("cuda", 0)] * n
        return inner(device, devices)

    if n:
        mesh.device_pool = pool
    try:
        yield
    finally:
        mesh.device_pool = inner


def mesh_phase(in_bam: str, step_bam: str, td: str, smi: str):
    """The mesh path: every visible card as a data lane (two lanes on
    cuda:0 when there is one card). The serve phase's 250k-read config5
    input streamed at 1 lane and at all lanes, d2h_packed auto and off
    (bytes identical; the lanes run traced, and wirestat reads its
    dev-N lanes and passes the mesh sum-check), both kernels launched
    on every lane and each held against its plain version at tolerance
    0 on every lane's last block, and group_kernel on every lane's last
    block under torch.cuda.set_sync_debug_mode("error"); then
    call_batch on a config3 slice at 1 lane, at all data lanes
    (identical) and at cycle shards (lanes/2, 2) (held to the JAX
    package's bar for a partitioned run, and whether identical). Walls
    and e2e_mesh_scaling (1-lane over all-lane stream walls, in turns).
    Last the device side alone: a config5 class of MESH_STEP_BUCKETS
    buckets of ``step_bam`` resident on the lanes, one fused step at 1
    lane and at all lanes, in turns, with each lane's host enqueue (its
    ``fused_pipeline`` call) timed; then that class staged at all lanes,
    each lane's host time split into staging (stack and pack into its
    pinned buffers, as a dispatch does before it takes its class's
    slot), and what a dispatch does holding the slot: the H2D issue,
    the pipeline call and the fetch start; beside it the all-lane
    stream's dispatches (PATH_DISPATCH["mesh"]: waits for the slot and
    for a graph lane's lock, one host copy of a lane's block). Returns
    the kernels' launches on the lanes run and their launches per
    lane."""
    import numpy as np
    import torch

    from duplexumiconsensusreads_torch.cli.main import params_for
    from duplexumiconsensusreads_torch.io import load_input
    from duplexumiconsensusreads_torch.kernels import cluster_fixpoint as cf
    from duplexumiconsensusreads_torch.kernels import grouping
    from duplexumiconsensusreads_torch.kernels import segment_gemm as sg
    from duplexumiconsensusreads_torch.bucketing import build_buckets
    from duplexumiconsensusreads_torch.parallel.mesh import run_mesh
    from duplexumiconsensusreads_torch.interop import ARRAY_KEYS
    from duplexumiconsensusreads_torch.parallel.sharded import (
        lane_context,
        lane_specs,
        lane_streams,
        presharded_pipeline,
        put_lane,
        put_lanes,
        release_streams,
        stage_lanes,
    )
    from duplexumiconsensusreads_torch.runtime import graphs
    from duplexumiconsensusreads_torch.runtime.executor import (
        PACKED_FETCH_KEYS,
        call_batch,
        d2h_k_pad,
        fetch_outputs,
        pack_fetch_outputs,
        partition_buckets,
        start_fetch,
    )
    from duplexumiconsensusreads_torch.runtime.stream import stream_call_consensus

    cards = torch.cuda.device_count()
    lanes = cards if cards >= 2 else 2
    cfg = {k: v for k, v in SERVE_CONFIG.items()
           if k not in ("grouping", "mode", "error_model", "min_duplex_reads", "write_index")}
    cfg["chunk_reads"] = TAKEOVER_CHUNK_READS
    gp, cp, _ = params_for("config5")
    cp = dataclasses.replace(cp, min_duplex_reads=1)
    runs, walls, out = {}, {}, {}
    with LaneKeeper() as keep, one_card_lanes(0 if cards >= 2 else lanes):
        # in turns (1, lanes, lanes, 1): drift over the four runs falls
        # on both lane counts alike
        for n, d2h in ((1, "auto"), (lanes, "auto"), (lanes, "off"), (1, "off")):
            name = f"{n}lane_d2h_{d2h}"
            path = os.path.join(td, f"mesh_{name}.bam")
            traced = n == lanes and d2h == "auto"
            trace = os.path.join(td, "mesh.trace.jsonl") if traced else None
            torch.cuda.synchronize()
            if traced:
                reset_launches()
                keep.reset()
            t0 = time.monotonic()
            rep = stream_call_consensus(in_bam, path, gp, cp, n_devices=n, d2h_packed=d2h,
                                        trace_path=trace, device="cuda", **cfg)
            walls[name] = round(time.monotonic() - t0, 3)
            if traced:
                launches = read_launches("mesh")
                lane_launches = keep.lane_launches()
                last = dict(keep.last)
            runs[name] = {"wall_s": walls[name], "n_devices": rep.n_devices,
                          "mesh_pad_buckets": rep.n_mesh_pad_buckets,
                          "chunks": rep.n_chunks, "bytes_h2d": rep.bytes_h2d,
                          "bytes_d2h": rep.bytes_d2h,
                          "reads_per_s": round(rep.n_valid_reads / walls[name], 1)}
            out[name] = read_bytes(path)
        ref = out["1lane_d2h_off"]
        if any(b != ref for b in out.values()):
            raise AssertionError("mesh: stream bytes moved with the lane count or d2h rung")
        for k, per in lane_launches.items():
            if k in PATH_KERNELS and (sorted(per) != list(range(lanes))
                                      or min(per.values()) == 0):
                raise AssertionError(f"mesh: {k} launched per lane {per} (want all {lanes})")
            if sum(per.values()) != launches[k]:
                raise AssertionError(f"mesh: {k}'s lanes {per} do not sum to {launches[k]}")
        rc, stat, err = run_tool("wirestat", [os.path.join(td, "mesh.trace.jsonl")])
        if rc != 0 or "dev-0" not in stat or "mesh_pad" not in stat:
            raise AssertionError(f"mesh: wirestat exit {rc}: {stat[-1500:]} {err[-500:]}")
        # each kernel against its plain version on every lane's last
        # block, on the lane's card (these launches are not the path's)
        held = {}
        for lane in range(lanes):
            (big, fid, f_max), _ = last[("segment_gemm", lane)]
            table, _ = last[("directional_cluster", lane)]
            with torch.cuda.device(big.device):
                e1 = (sg.segment_gemm(big, fid, f_max)
                      - sg.segment_gemm_plain(big, fid, f_max)).abs().max().item()
                e2 = max((a.long() - b.long()).abs().max().item() for a, b in
                         zip(cf.directional_cluster(*table), cf.directional_cluster_plain(*table)))
                g_args, g_kw = last[("group_kernel", lane)]
                torch.cuda.synchronize(big.device)
                torch.cuda.set_sync_debug_mode("error")
                try:
                    grouping.group_kernel(*g_args, **g_kw)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                torch.cuda.synchronize(big.device)
            if e1 != 0 or e2 != 0:
                raise AssertionError(f"mesh: lane {lane}'s kernels differ from plain: {e1}, {e2}")
            held[lane] = {"device": str(big.device), "segment_gemm_shape": list(big.shape),
                          "segment_gemm_max_abs_err": e1,
                          "directional_cluster_shape": list(table[0].shape),
                          "directional_cluster_max_abs_err": e2,
                          "group_kernel_sync_debug": "ran through"}
        del last
        # the whole-file path on a config3 slice
        gp3, cp3, _ = params_for("config3")
        _, batch, _ = load_input(in_bam, duplex=True)
        res, cwalls = {}, {}
        # an untimed one-lane call first (the first call of a fresh
        # shape grows the allocator), then the timed ones
        call_batch(batch, gp3, cp3, capacity=CAPACITY, device="cuda", n_devices=1)
        for name, kw in ((str(lanes), dict(n_devices=lanes)),
                         (f"{lanes // 2}x2", dict(n_devices=lanes, cycle_shards=2)),
                         ("1", dict(n_devices=1))):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            res[name] = call_batch(batch, gp3, cp3, capacity=CAPACITY, device="cuda", **kw)
            cwalls[name] = round(time.monotonic() - t0, 3)
        # the device side alone: a config5 class of MESH_STEP_BUCKETS
        # buckets (the largest class of ``step_bam``, cut to size),
        # resident on the lanes, one step at 1 lane and at all lanes
        # (every card synchronized after the reps)
        _, step_batch, _ = load_input(step_bam, duplex=True)
        buckets = build_buckets(step_batch, capacity=CAPACITY, grouping=gp)
        del step_batch
        cb, cspec = max(partition_buckets(buckets, gp, cp, device="cuda"),
                        key=lambda p: len(p[0]))
        cb = cb[:MESH_STEP_BUCKETS]
        step_ms, enqueue_ms = {}, {}
        # the largest class the smoke captures: the earlier phases'
        # graphs and cached blocks give the card back first
        graphs.clear()
        torch.cuda.empty_cache()
        for n in (1, lanes, 1, lanes):
            m = run_mesh("cuda", n)
            ss = lane_streams(m)
            args = put_lanes(stage_lanes(cb, m, cspec, streams=ss), m, cspec, streams=ss)

            def step():
                presharded_pipeline(args, cspec, m, streams=ss)
                for d in set(m.devices):
                    torch.cuda.synchronize(d)

            # eager at the class's first sight on a lane, captured at
            # the second (runtime/graphs.py): the timed steps replay
            step()
            step()
            with enqueue_timer(graphs) as enq:
                t0 = time.monotonic()
                for _ in range(MESH_STEP_REPS):
                    step()
                dt = time.monotonic() - t0
            step_ms.setdefault(str(n), []).append(round(dt / MESH_STEP_REPS * 1e3, 3))
            # the lanes are issued in lane order, one call each a step
            enqueue_ms.setdefault(str(n), []).append(
                [round(sum(enq[i::n]) / len(enq[i::n]) * 1e3, 3) for i in range(n)])
            del args
            release_streams(ss)
        # the same class staged at all lanes as the stream's dispatch
        # stages it (stack and pack straight into each lane's pinned
        # buffers, before the class's slot is taken; the lanes' share
        # each), then each lane issued in turn, its host time split: the
        # H2D (into the step graph's static inputs once it exists), the
        # step (eager, captured, then replayed), the packed compaction +
        # D2H start (ms, the median of the dispatches); "slot_held" is
        # their sum, what a dispatch does holding its class's slot
        m = run_mesh("cuda", lanes)
        ss = lane_streams(m)
        specs, k_pad = lane_specs(cspec, m), d2h_k_pad(cb, cspec, m.n_data)
        split = {part: [[] for _ in range(lanes)]
                 for part in ("staging", "h2d", "pipeline", "fetch", "slot_held")}
        for _ in range(MESH_SPLIT_REPS):
            fetches = []
            staging = [[] for _ in range(lanes)]
            t0 = time.perf_counter()
            blocks = stage_lanes(cb, m, cspec, streams=ss, keep=staging)
            t_stage = (time.perf_counter() - t0) / lanes
            for i, dev in enumerate(m.devices):
                with lane_context(dev, ss[i]):
                    t0 = time.perf_counter()
                    a = put_lane(blocks[i], dev, specs[i])
                    t1 = time.perf_counter()
                    o, _ = graphs.run_step(a, specs[i], ARRAY_KEYS)
                    t2 = time.perf_counter()
                    fetches.append(start_fetch(pack_fetch_outputs(o, cspec, k_pad),
                                               keys=PACKED_FETCH_KEYS, staging=staging[i]))
                    t3 = time.perf_counter()
                for part, dt in zip(split, (t_stage, t1 - t0, t2 - t1, t3 - t2, t3 - t0)):
                    split[part][i].append(dt)
            for f in fetches:
                fetch_outputs(f)
        split = {part: [round(float(np.median(v)) * 1e3, 3) for v in per]
                 for part, per in split.items()}
        del blocks, fetches
        release_streams(ss)
    if PATH_DISPATCH["mesh"]["pinned_writes_per_lane"] != 1:
        raise AssertionError(f"mesh: a lane's block written into pinned memory "
                             f"{PATH_DISPATCH['mesh']} times a lane dispatch (want once)")
    one = res["1"]
    if not all(np.array_equal(a, b) for a, b in zip(one, res[str(lanes)])):
        raise AssertionError("mesh: call_batch on the data lanes differs from one lane")
    cyc = res[f"{lanes // 2}x2"]
    # call_batch's columns: base, qual, dstats, valid, pos, umi, mate,
    # pair, end; all but the quals exact, quals at the JAX bar
    for i, name in enumerate(("base", "qual", "dstats", "valid", "pos", "umi", "mate", "pair",
                              "end")):
        if name != "qual" and not np.array_equal(one[i], cyc[i]):
            raise AssertionError(f"mesh: cycle shards moved the {name} column")
    dq = one[1] != cyc[1]
    if dq.mean() >= 1e-4 or (dq.any() and min(one[1][dq].min(), cyc[1][dq].min()) <= 60):
        raise AssertionError(f"mesh: cycle shards moved {int(dq.sum())} quals")
    scaling = round((walls["1lane_d2h_auto"] + walls["1lane_d2h_off"])
                    / (walls[f"{lanes}lane_d2h_auto"] + walls[f"{lanes}lane_d2h_off"]), 3)
    emit("mesh", nvidia_smi=smi, cards=cards, lanes=lanes,
         lane_devices=[str(torch.device("cuda", i if cards >= 2 else 0)) for i in range(lanes)],
         stream=runs, stream_bytes_identical=True, wirestat="dev-N lanes, mesh sum-check OK",
         e2e_mesh_scaling=scaling, launches=launches, lane_launches=lane_launches,
         lanes_held=held, whole_file_config="config3", whole_file_reads=int(batch.valid.sum()),
         whole_file_walls_s=cwalls, whole_file_data_lanes_identical=True,
         whole_file_cycle_shards=f"{lanes // 2}x2", whole_file_cycle_bar="jax",
         whole_file_cycle_identical=bool(all(np.array_equal(a, b) for a, b in zip(one, cyc))),
         whole_file_cycle_quals_moved=int(dq.sum()),
         compute_class=[len(cb), CAPACITY], compute_step_ms=step_ms,
         compute_enqueue_ms=enqueue_ms, staged_lane_split_ms=split,
         stream_dispatch=PATH_DISPATCH["mesh"],
         compute_scaling=round(sum(step_ms["1"]) / sum(step_ms[str(lanes)]), 3))
    return launches, lane_launches


# a serve daemon run in a subprocess by the serve and shard phases: the
# port's serve.daemon main, then its kernel launch counts written to
# the file named by the first argument (the counters live in the
# daemon's process)
DAEMON_CHILD = """
import json, sys
sys.path.insert(0, {here!r})
from duplexumiconsensusreads_torch.kernels import cluster_fixpoint, segment_gemm
from duplexumiconsensusreads_torch.runtime import graphs
from duplexumiconsensusreads_torch.serve import daemon
rc = daemon.main(sys.argv[2:])
with open(sys.argv[1], "w") as f:
    json.dump({{"segment_gemm": segment_gemm.segment_gemm.launches,
               "directional_cluster": cluster_fixpoint.directional_cluster.launches}}, f)
with open(sys.argv[1] + ".graphs", "w") as f:
    c = graphs.read_counts()
    json.dump({{**{{k: {{m: c[k][m] for m in graphs.MODES}} for k in graphs.KINDS}},
               "classes": c["classes"],
               "pools": {{k: c[k] for k in ("pool_peak_bytes", "card_free_min")}}}}, f)
sys.exit(rc)
"""


# the chaos phase's stream sites (the port's faults.KNOWN_SITES up to
# finalise.write), its seeded multi-fault plan, and its kills
CHAOS_STREAM_SITES = 11
CHAOS_SEED, CHAOS_N_FAULTS = 20260803, 8
CHAOS_KILLS = (("dispatch.pack", 2), ("fetch.unpack", 2))


def chaos_phase(in_bam: str, td: str, smi: str) -> dict:
    """The stream's fault matrix on the card: the serve phase's 250k-read
    config5 input in 50k-read chunks, fault-free once, then one seeded
    transient at each stream site, the seeded multi-fault plan, and two
    kills each followed by a resume. Every output is byte-identical to
    the fault-free run, both kernels launch in every run, and the device
    memory allocated after each kill-and-resume pair is back within one
    chunk's footprint of where it started (a retried H2D or D2H reusing
    a pinned staging buffer still in flight, or tensors kept alive by a
    killed run, would show here). Over the phase, the memory allocated
    after every run from the third on is within one chunk's footprint
    of what it was after the second (ROADMAP Faults 16): the first two
    runs see each class of the fault-free path twice, and so capture its
    graphs (runtime/graphs.py). The graphs' static and pool bytes are
    reported beside each run's memory: the statics may still grow by
    the graphs of classes that only a fault's retry dispatches (another
    d2h rung), captured when a later run meets them again, and that
    growth is inside the check. Returns the path's launches, summed
    over the runs."""
    import gc
    import zlib

    import torch

    from duplexumiconsensusreads_torch import benchmark
    from duplexumiconsensusreads_torch.runtime import faults, graphs
    from duplexumiconsensusreads_torch.runtime.stream import stream_call_consensus

    gp, cp = benchmark._e2e_params()
    kw = dict(capacity=CAPACITY, chunk_reads=TAKEOVER_CHUNK_READS, device="cuda")
    runs, total = [], {}

    def run(name, plan=None, **extra):
        out = os.path.join(td, f"chaos_{name}.bam")
        torch.cuda.synchronize()
        reset_launches()
        if plan is not None:
            faults.install(plan)
        t0 = time.monotonic()
        try:
            rep = stream_call_consensus(in_bam, out, gp, cp, **kw, **extra)
        finally:
            faults.uninstall()
        wall = time.monotonic() - t0
        got = read_launches(f"chaos {name}")
        for k, v in got.items():
            total[k] = total.get(k, 0) + v
        gc.collect()
        torch.cuda.synchronize()
        row = {"run": name, "wall_seconds": round(wall, 3), "n_retries": rep.n_retries,
               "n_fired": plan.n_fired if plan is not None else 0, "launches": got,
               "chunks": rep.n_chunks, "chunks_skipped": rep.n_chunks_skipped,
               "allocated_after": torch.cuda.memory_allocated(),
               "graph_static_bytes": graphs.static_bytes(),
               "graph_pool_bytes": sum(graphs.pool_bytes().values())}
        runs.append(row)
        return out, row

    gc.collect()
    torch.cuda.synchronize()
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ref_path, ref_row = run("fault_free")
    ref = read_bytes(ref_path)
    # one chunk's device footprint: the fault-free run's peak above its
    # start, over the chunks it keeps in flight (max_inflight, default 4)
    chunk_bytes = (torch.cuda.max_memory_allocated() - base_mem) / 4
    if ref_row["chunks"] < 4:
        raise AssertionError(f"chaos input gave {ref_row['chunks']} chunks (want >= 4)")

    def same(name, path, row):
        if read_bytes(path) != ref:
            raise AssertionError(f"chaos {name}: output differs from the fault-free run")
        row["identical"] = True

    for site in faults.KNOWN_SITES[:CHAOS_STREAM_SITES]:
        plan = faults.FaultPlan.seeded(zlib.crc32(site.encode()), sites=(site,), n_faults=1,
                                       max_nth=1)
        path, row = run(f"transient_{site}", plan)
        if plan.n_fired < 1:
            raise AssertionError(f"chaos: the transient at {site} never fired")
        same(site, path, row)
    plan = faults.FaultPlan.seeded(CHAOS_SEED, n_faults=CHAOS_N_FAULTS)
    path, row = run(f"seed_{CHAOS_SEED}_{CHAOS_N_FAULTS}", plan)
    if plan.n_fired < 1:
        raise AssertionError("chaos: the seeded plan never fired")
    same("seeded", path, row)
    kills = []
    for site, nth in CHAOS_KILLS:
        name = f"kill_{site}_{nth}"
        out = os.path.join(td, f"chaos_{name}.bam")
        gc.collect()
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        reset_launches()
        plan = faults.FaultPlan.parse(f"{site}:{nth}:kill")
        faults.install(plan)
        t0 = time.monotonic()
        try:
            stream_call_consensus(in_bam, out, gp, cp, **kw)
            raise AssertionError(f"chaos: the kill at {site}:{nth} did not fire")
        except faults.InjectedKill:
            pass
        finally:
            faults.uninstall()
        kill_s = time.monotonic() - t0
        killed = {k: fn.launches for k, fn in kernel_wrappers().items()}
        if os.path.exists(out):
            raise AssertionError(f"chaos: a killed run left {out}")
        gc.collect()
        torch.cuda.synchronize()
        mem_killed = torch.cuda.memory_allocated()
        path, row = run(f"resume_{site}_{nth}", resume=True)
        same(name, path, row)
        gc.collect()
        torch.cuda.synchronize()
        mem1 = torch.cuda.memory_allocated()
        if mem1 - mem0 > chunk_bytes:
            raise AssertionError(
                f"chaos {name}: {mem1 - mem0} bytes still allocated after the kill and resume "
                f"(one chunk is {chunk_bytes:.0f})")
        row.update(kill_wall_seconds=round(kill_s, 3), kill_n_fired=plan.n_fired,
                   kill_launches=killed)
        for k, v in killed.items():
            total[k] = total.get(k, 0) + v
        kills.append({"kill": f"{site}:{nth}:kill", "allocated_before": mem0,
                      "allocated_after_kill": mem_killed, "allocated_after_resume": mem1,
                      "chunk_footprint_bytes": int(chunk_bytes),
                      "chunks_skipped": row["chunks_skipped"]})
    # and over the whole phase: device memory does not grow run by run
    # (ROADMAP Faults 16: a new stream per run left a cuBLAS workspace)
    # once the second run has captured the fault-free path's graphs
    second = runs[1]
    for row in runs[2:]:
        if row["allocated_after"] - second["allocated_after"] > chunk_bytes:
            raise AssertionError(
                f"chaos {row['run']}: {row['allocated_after'] - second['allocated_after']} "
                f"bytes more allocated than after the second run (one chunk is "
                f"{chunk_bytes:.0f})")
    emit("chaos", input_reads=SERVE_SMALL_READS[1], chunk_reads=TAKEOVER_CHUNK_READS,
         allocated_at_start=base_mem, allocated_after_second_run=second["allocated_after"],
         config="config5 (min_duplex_reads=1)", runs=runs, kills=kills,
         wall_seconds=round(sum(r["wall_seconds"] + r.get("kill_wall_seconds", 0)
                                for r in runs), 3),
         all_identical=True, launches=total, nvidia_smi=smi)
    return total


def entry_phase(smi: str):
    """The port's entry points on the card: ``entry()``'s fused step
    against ``entry(device="cpu")`` at the parity bar, each kernel of the
    step held against its plain version at the step's shapes (tolerance
    0), then ``dryrun_multichip(2)`` on two lanes of cuda:0 (two CUDA
    streams of one card; every card a lane where there are two or
    more). Returns (entry launches, dry-run launches, segment_gemm case,
    directional_cluster case)."""
    import numpy as np
    import torch

    from duplexumiconsensusreads_torch import entry
    from duplexumiconsensusreads_torch.kernels import cluster_fixpoint as cf
    from duplexumiconsensusreads_torch.kernels import consensus, grouping
    from duplexumiconsensusreads_torch.kernels import segment_gemm as sg

    fn, args = entry.entry()
    fn(*args)  # warm
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.monotonic()
    with Capture(consensus, "segment_gemm") as cap_s, \
            Capture(grouping, "directional_cluster") as cap_f:
        out = fn(*args)
        torch.cuda.synchronize()
    step_s = time.monotonic() - t0
    launches = read_launches("entry")
    cfn, cargs = entry.entry(device="cpu")
    cout = cfn(*cargs)
    host = {k: v.cpu().numpy() for k, v in out.items()}
    chost = {k: v.numpy() for k, v in cout.items()}
    exact = ("family_id", "molecule_id", "n_families", "n_molecules", "n_overflow", "cons_valid",
             "cons_depth", "depth_max", "depth_min_pos", "cons_mate", "cons_pair", "cons_end")
    for k in exact:
        if not np.array_equal(host[k], chost[k]):
            raise AssertionError(f"entry: {k} differs between the card and the CPU")
    # the parity bar of compare_records: quals within 2 (one per
    # strand), bases identical, but for counted duplex ties
    sa, sb = host["cons_base"], chost["cons_base"]
    qa, qb = host["cons_qual"].astype(int), chost["cons_qual"].astype(int)
    dq = np.abs(qa - qb)
    tie = np.logical_or.reduce(list(tie_kinds(sa, sb, qa, qb, 2, duplex=True).values()))
    if ((sa != sb) & ~tie).any() or np.where(tie, 0, dq).max() > 2:
        raise AssertionError("entry: bases or quals apart between the card and the CPU")
    (big, fid, f_max), _ = cap_s.args
    seg_case = kernel_case(sg, "entry_step", big, fid, f_max)
    table, _ = cap_f.args
    got = cf.directional_cluster(*table)
    want = cf.directional_cluster_plain(*table)
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("entry: the directional_cluster kernel differs from its plain version")
    fix_case = {"case": "entry_step", "shape": list(table[0].shape), "max_abs_err": 0,
                "tolerance": 0}
    del big, fid, table, got, want, cap_s, cap_f
    lanes = 2
    cards = torch.cuda.device_count()
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.monotonic()
    with one_card_lanes(0 if cards >= 2 else lanes):
        balance = entry.dryrun_multichip(lanes)
    dry_s = time.monotonic() - t0
    dry = read_launches("dryrun")
    emit("entry", step_seconds=round(step_s, 4), shape=list(args[0].shape),
         cons_valid=int(host["cons_valid"].sum()), card_vs_cpu={
             "integers_identical": True, "max_qual_diff": int(np.where(tie, 0, dq).max()),
             "tie_cycles": int(tie.sum()), "cycles": int(sa.size)},
         launches=launches, segment_gemm_case=seg_case, directional_cluster_case=fix_case,
         dryrun={"cards": min(cards, lanes), "lanes": lanes, "seconds": round(dry_s, 3),
                 "balance": balance, "launches": dry},
         nvidia_smi=smi)
    return launches, dry, seg_case, fix_case


# the features phase: each feature path of the JAX package, card against
# CPU, at read_len 150 and the configuration's own capacity. A path is
# (name, preset, GroupingParams and ConsensusParams fields over the
# preset's, call knobs, input parts, the kernels it must launch). A part
# is SimConfig fields (each part at its own positions) or "jumbo": one
# duplex molecule of JUMBO_READS reads, past config4's capacity.
FEATURE_READ_LEN = 150
JUMBO_READS = 5_000
SEG, DC = "segment_gemm", "directional_cluster"
FEATURE_PATHS = (
    # config1's bench plan (benchmark.py:_config_plans) cut to 2k
    # molecules; exact grouping runs no cluster kernel
    ("exact_single_strand", "config1", {}, {}, {},
     [dict(n_molecules=2000, n_positions=24, mean_family_size=6, duplex=False, seed=11)],
     (SEG,)),
    ("adjacency_single_strand", "config2", {}, {}, {},
     [dict(n_molecules=2000, n_positions=400, mean_family_size=5, umi_error=0.02,
           duplex=False, seed=12)], (SEG, DC)),
    # tests/test_jumbo.py's seed-43 geometry scaled so its position holds
    # > 3 x capacity reads (host-preclustered, then exact on the card),
    # beside positions the card groups with the count ratio at 0
    ("cluster_duplex", "config3", {"strategy": "cluster"}, {"min_duplex_reads": 1}, {},
     [dict(n_molecules=1000, n_positions=1, mean_family_size=4, umi_error=0.04, duplex=True,
           seed=43),
      dict(n_molecules=1000, n_positions=40, mean_family_size=4, umi_error=0.04, duplex=True,
           seed=44)], (SEG, DC)),
    # an oversized position (> 3 x 4096 reads), one family past the
    # capacity (a jumbo pow2 bucket), and config4's bench plan cut down
    ("jumbo_config4", "config4", {}, {}, {},
     [dict(n_molecules=3500, n_positions=1, mean_family_size=4, umi_error=0.01, duplex=True,
           seed=14), "jumbo",
      dict(n_molecules=2000, n_positions=1600, mean_family_size=3, umi_error=0.01,
           duplex=True, seed=15)], (SEG, DC)),
    # tests/test_refproject.py:test_indel_sim_truth_and_parity's input
    ("ref_projected", "config3", {}, {}, {"ref_projected": True},
     [dict(n_molecules=100, mean_family_size=5, indel_error=0.08, base_error=0.01,
           duplex=True, seed=21)], (SEG, DC)),
    # tests/test_mate.py:test_cli_mate_aware_end_to_end's input
    ("mate_aware", "config3", {}, {}, {"mate_aware": "on"},
     [dict(n_molecules=150, n_positions=16, mean_family_size=5, umi_error=0.02, duplex=True,
           paired_reads=True, seed=31)], (SEG, DC)),
    # the e2e_small_reference input with per-base tags, then ``filter``
    ("filter", "config5", {}, {}, {"per_base_tags": True},
     [dict(n_molecules=400, n_positions=10, umi_error=0.01, duplex=True, seed=3)], (SEG, DC)),
)
FILTER_ARGS = ("--min-base-depth", "3", "--max-n-frac", "0.1")


def jumbo_molecule(pos_key: int, seed: int):
    """One duplex molecule of JUMBO_READS reads (half a strand each) at
    ``pos_key``, 1 % base errors, quals 20-40: a family past config4's
    capacity, which bucketing gives a pow2 bucket of its own."""
    import numpy as np

    from duplexumiconsensusreads_torch.types import ReadBatch

    rng = np.random.default_rng(seed)
    n, l = JUMBO_READS, FEATURE_READ_LEN
    bases = np.tile(rng.integers(0, 4, l, dtype=np.uint8), (n, 1))
    err = rng.random((n, l)) < 0.01
    bases[err] = (bases[err] + rng.integers(1, 4, int(err.sum()), dtype=np.uint8)) % 4
    return ReadBatch(bases=bases, quals=rng.integers(20, 41, (n, l), dtype=np.uint8),
                     umi=np.tile(rng.integers(0, 4, 12, dtype=np.uint8), (n, 1)),
                     pos_key=np.full(n, pos_key, np.int64),
                     strand_ab=np.arange(n) % 2 == 0, frag_end=np.zeros(n, bool),
                     valid=np.ones(n, bool))


def feature_input(path: str, parts: list) -> "np.ndarray":
    """A sorted BAM at ``path`` of the parts, each shifted to positions of
    its own; returns its reads' pos_keys. One simulated part is the
    simulator's own BAM (indels injected as ``simulated_bam`` does)."""
    import numpy as np

    from duplexumiconsensusreads_torch.io import simulated_bam
    from duplexumiconsensusreads_torch.io.bam import BamHeader, write_bam
    from duplexumiconsensusreads_torch.io.convert import readbatch_to_records
    from duplexumiconsensusreads_torch.simulate import SimConfig, simulate_batch
    from duplexumiconsensusreads_torch.types import ReadBatch

    if len(parts) == 1:
        _, _, batch, _ = simulated_bam(SimConfig(read_len=FEATURE_READ_LEN, **parts[0]),
                                       path=path, sort=True)
        return np.asarray(batch.pos_key)[np.asarray(batch.valid, bool)]
    batches = []
    for k, part in enumerate(parts):
        offset = 1_000_000 * (k + 1)
        if part == "jumbo":
            batches.append(jumbo_molecule(offset, seed=k))
            continue
        b, _ = simulate_batch(SimConfig(read_len=FEATURE_READ_LEN, **part))
        b.pos_key = np.asarray(b.pos_key) + offset
        batches.append(b)
    fields = [f.name for f in dataclasses.fields(ReadBatch)]
    batch = ReadBatch(**{f: np.concatenate([np.asarray(getattr(b, f)) for b in batches])
                         for f in fields})
    batch = batch.take(np.argsort(batch.pos_key, kind="stable"))
    write_bam(path, BamHeader.synthetic(sort_order="coordinate"),
              readbatch_to_records(batch, duplex=True))
    return np.asarray(batch.pos_key)


def features_phase(smi: str):
    """Every path of FEATURE_PATHS through ``call_consensus_file`` on the
    card and on the CPU (plain versions) on one input: the records
    agree at the parity bar (compare_records, ties counted by kind, 1 in
    10,000); the ``filter`` path then filters both outputs and compares
    those. The kernels each path must launch did; at the path's largest
    class (and its widest bucket) segment_gemm, and at its largest slot
    table directional_cluster, equal their plain versions (tolerance
    0). One line per path. Returns (the launches over the phase, the
    segment_gemm cases, the directional_cluster cases)."""
    t_phase = time.monotonic()
    total = {name: 0 for name in kernel_wrappers()}
    seg_cases, dc_cases = [], []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_features_") as td:
        for path in FEATURE_PATHS:
            feature_path(path, td, total, seg_cases, dc_cases, smi)
    emit("features_total", paths=[p[0] for p in FEATURE_PATHS], launches=total,
         phase_seconds=round(time.monotonic() - t_phase, 3), nvidia_smi=smi)
    return total, seg_cases, dc_cases


def feature_path(path: tuple, td: str, total: dict, seg_cases: list, dc_cases: list,
                 smi: str) -> None:
    """One path of FEATURE_PATHS (see features_phase): adds its launches
    to ``total`` and its kernel cases to the lists."""
    import numpy as np
    import torch

    from duplexumiconsensusreads_torch import bucketing
    from duplexumiconsensusreads_torch.cli.main import params_for
    from duplexumiconsensusreads_torch.io import read_bam
    from duplexumiconsensusreads_torch.kernels import cluster_fixpoint as cf
    from duplexumiconsensusreads_torch.kernels import consensus, grouping
    from duplexumiconsensusreads_torch.kernels import segment_gemm as sg
    from duplexumiconsensusreads_torch.runtime.executor import call_consensus_file

    name, preset, g_over, c_over, knobs, parts, expect = path
    gp, cp, capacity = params_for(preset)
    gp, cp = dataclasses.replace(gp, **g_over), dataclasses.replace(cp, **c_over)
    duplex = cp.mode == "duplex"
    in_bam = os.path.join(td, f"feature_{name}.bam")
    keys = feature_input(in_bam, parts)
    largest_pos = int(np.unique(keys, return_counts=True)[1].max())
    outs = {d: os.path.join(td, f"feature_{name}_{d}.bam") for d in ("cuda", "cpu")}
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.monotonic()
    with Capture(consensus, "_reduce") as cap_c, \
            Capture(consensus, "_reduce", size=lambda a: a[0].shape[1]) as cap_r, \
            Capture(grouping, "directional_cluster") as cap_g, \
            Tally(bucketing, "build_buckets", lambda bks: (
                len(bks), sum(b.preclustered for b in bks),
                max((b.n_unique_umi for b in bks if b.preclustered), default=0),
                sorted({b.capacity for b in bks}))) as t_bk:
        rep = call_consensus_file(in_bam, outs["cuda"], gp, cp, capacity=capacity,
                                  device="cuda", **knobs)
        torch.cuda.synchronize()
    secs = {"cuda": round(time.monotonic() - t0, 3)}
    got = {k: fn.launches for k, fn in kernel_wrappers().items()}
    t0 = time.monotonic()
    call_consensus_file(in_bam, outs["cpu"], gp, cp, capacity=capacity, device="cpu", **knobs)
    secs["cpu"] = round(time.monotonic() - t0, 3)
    missing = [k for k in expect if got[k] == 0]
    if missing:
        raise AssertionError(f"the {name} feature path launched {missing} no time")
    for k, v in got.items():
        total[k] += v
    parity = compare_records(read_bam(outs["cuda"])[1], read_bam(outs["cpu"])[1],
                             qual_tol=2 if duplex else 1, duplex_ties=duplex,
                             ss_ties=not duplex, per_base=bool(knobs.get("per_base_tags")))
    n_bk, n_pre, pre_u, caps = t_bk.seen[0]
    if name in ("cluster_duplex", "jumbo_config4"):
        if largest_pos <= 3 * capacity or n_pre == 0:
            raise AssertionError(f"{name}: largest position {largest_pos} reads, "
                                 f"{n_pre} preclustered buckets (want > 3 x {capacity})")
    if name == "jumbo_config4" and max(caps) <= capacity:
        raise AssertionError(f"{name}: no jumbo bucket (capacities {caps})")
    filtered = None
    if name == "filter":
        for d in ("cuda", "cpu"):
            cli("filter", outs[d], "-o", outs[d] + ".filtered.bam", *FILTER_ARGS)
        filtered = compare_records(read_bam(outs["cuda"] + ".filtered.bam")[1],
                                   read_bam(outs["cpu"] + ".filtered.bam")[1], qual_tol=2,
                                   duplex_ties=True, per_base=True)
        filtered["args"] = list(FILTER_ARGS)
    # each kernel against its plain version: segment_gemm at the
    # largest class and at the widest bucket, directional_cluster at
    # the largest slot table
    cases = {}
    for which, cap in (("largest_class", cap_c), ("widest_bucket", cap_r)):
        (big, fid, f_max, _method), _ = cap.args
        case = kernel_case(sg, f"features_{name}_{which}", big, fid, f_max)
        seg_cases.append(case)
        cases[which] = case
    shapes = sorted({tuple(s) for s in cap_c.shapes})
    dc_case = None
    if cap_g.args is not None:
        table, _ = cap_g.args
        g_got = cf.directional_cluster(*table)
        g_want = cf.directional_cluster_plain(*table)
        err = max((a.long() - b.long()).abs().max().item() for a, b in zip(g_got, g_want))
        if not all(torch.equal(a, b) for a, b in zip(g_got, g_want)):
            raise AssertionError(f"features {name}: directional_cluster max abs err {err}")
        dc_case = {"case": f"features_{name}", "shape": list(table[0].shape),
                   "umi_len": table[3], "max_hamming": table[4], "count_ratio": table[5],
                   "max_abs_err": err, "tolerance": 0}
        dc_cases.append(dc_case)
        if name == "cluster_duplex" and table[5] != 0:
            raise AssertionError(f"{name}: directional_cluster ran at count ratio {table[5]}")
        del table, g_got, g_want
    del cap_c, cap_r, cap_g
    torch.cuda.empty_cache()
    emit("features", path=name, config=preset, grouping=gp.strategy, mode=cp.mode,
         knobs=knobs, capacity=capacity, reads=int(keys.size),
         largest_position_reads=largest_pos, buckets=n_bk, preclustered_buckets=n_pre,
         preclustered_max_unique_umis=pre_u, bucket_capacities=caps,
         consensus_out=rep.n_consensus, card_vs_cpu=parity,
         filtered_card_vs_cpu=filtered,
         launches=got, segment_gemm_shapes=[list(s) for s in shapes],
         largest_class=cases["largest_class"]["shape"],
         largest_class_f_max=cases["largest_class"]["f_max"],
         segment_gemm_vs_plain=cases, directional_cluster_vs_plain=dc_case,
         seconds=secs, nvidia_smi=smi)


def start_daemon(spool: str, daemon_id: str, counts: str, device: str, *extra):
    """A serve daemon subprocess on ``device``, loading the kernels this
    process built (its --build-dir is the build directory in force)."""
    from duplexumiconsensusreads_torch.kernels import build
    from duplexumiconsensusreads_torch.utils.compile_cache import build_dir

    argv = [sys.executable, "-c", DAEMON_CHILD.format(here=HERE), counts, spool,
            "--device", device, "--daemon-id", daemon_id, "--poll", "0.05",
            "--build-dir", build_dir(build.BUILD_DIR), *extra]
    return subprocess.Popen(argv, cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def finish_daemon(proc, timeout_s: float, what: str) -> str:
    """Wait for a daemon subprocess; raise with its stderr unless it
    exited 0. Returns its stderr."""
    try:
        _, err = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        proc.kill()
        _, err = proc.communicate()
        raise AssertionError(f"{what} did not finish in {timeout_s} s: {err[-2000:]}")
    if proc.returncode != 0:
        raise AssertionError(f"{what} exited {proc.returncode}: {err[-2000:]}")
    return err


def add_launches(total: dict, counts_path: str, path: str) -> dict:
    """``total`` plus a subprocess's launch counts; its graph counts go
    into GRAPH_PATHS[path]."""
    note_child_graphs(path, counts_path)
    with open(counts_path) as f:
        got = json.load(f)
    return {k: total.get(k, 0) + got[k] for k in got}


def job_reference(in_bam: str, out: str, config: dict, device: str) -> tuple[bytes, float]:
    """The one-shot stream of a job's config with its canonical @PG line
    (what every service output of the job must equal); its wall."""
    from duplexumiconsensusreads_torch.runtime.stream import stream_call_consensus
    from duplexumiconsensusreads_torch.serve.job import job_params, serve_provenance, validate_spec

    spec = validate_spec({"job_id": "ref", "input": in_bam, "output": out, "config": config})
    gp, cp, kw = job_params(spec)
    kw.pop("mesh")
    t0 = time.monotonic()
    stream_call_consensus(in_bam, out, gp, cp, device=device,
                          provenance_cl=serve_provenance(config), **kw)
    return read_bytes(out), time.monotonic() - t0


def capture_events(path: str) -> tuple[float, list]:
    """(the capture's epoch on the machine's monotonic clock, its events)."""
    recs = [json.loads(line) for line in open(path)]
    return float(recs[0]["epoch_m"]), [r for r in recs if r.get("type") == "event"]


def live_phase(in_bam: str, stream_out: str, gp, cp, settings: dict, td: str, smi: str,
               device: str = "cuda") -> dict:
    """Follow mode on the stream cell: a paced writer appends the stream
    phase's input, whole BGZF blocks at a time over LIVE_APPEND_S, while
    the port follows it with a snapshot per committed chunk. The final
    bytes equal the stream phase's output; every snapshot is an indexed
    BAM whose bytes are a prefix of it. Reports the time to the first
    snapshot and the lag from the last append to the published output.
    Returns the kernels' launches on the path."""
    import threading

    import torch

    from duplexumiconsensusreads_torch.io import bgzf, read_bam
    from duplexumiconsensusreads_torch.io.bai import read_bai
    from duplexumiconsensusreads_torch.runtime.stream import stream_call_consensus

    raw = read_bytes(in_bam)
    blocks = [o + n for o, n in bgzf.iter_block_offsets(raw)]
    n_writes = int(LIVE_APPEND_S / LIVE_WRITE_S)
    per = max(1, -(-len(blocks) // n_writes))
    grow = os.path.join(td, "live_in.bam")
    out = os.path.join(td, "live_out.bam")
    snap = out + ".snapshot.bam"
    open(grow, "wb").close()
    t_last = [0.0]

    def writer():
        with open(grow, "ab") as f:
            prev = 0
            for i in range(per - 1, len(blocks) + per - 1, per):
                end = blocks[min(i, len(blocks) - 1)]
                f.write(raw[prev:end])
                f.flush()
                prev = end
                time.sleep(LIVE_WRITE_S)
            if prev < len(raw):
                f.write(raw[prev:])
        t_last[0] = time.monotonic()

    snaps, t_first = [], [None]

    def progress(_k, rep):
        if rep.snapshot_seq and t_first[0] is None:
            t_first[0] = time.monotonic()
        snaps.append((rep.snapshot_seq, read_bytes(snap), read_bytes(snap + ".bai"),
                      rep.n_consensus))

    if device == "cuda":
        torch.cuda.synchronize()
    reset_launches()
    wt = threading.Thread(target=writer, daemon=True)
    t0 = time.monotonic()
    wt.start()
    try:
        rep = stream_call_consensus(grow, out, gp, cp, device=device, follow=True,
                                    live_poll_s=0.05, snapshot_chunks=1, progress=progress,
                                    **settings)
    finally:
        wt.join(timeout=LIVE_APPEND_S * 4)
    t_out = time.monotonic()
    launches = read_launches("live")
    final = read_bytes(out)
    if final != read_bytes(stream_out):
        raise AssertionError("live: the follow output differs from the stream phase's")
    if wt.is_alive() or rep.snapshot_seq != rep.n_chunks or len(snaps) != rep.n_chunks:
        raise AssertionError(f"live: {rep.snapshot_seq} snapshots of {rep.n_chunks} chunks")
    # each snapshot: a byte prefix of the output closed by an EOF block,
    # whose index counts exactly the records committed when it was
    # published; the first one is also parsed whole
    n_prev = -1
    path = os.path.join(td, "snap_check.bam")
    for i, (seq, b, bai, n_committed) in enumerate(snaps):
        if seq != i + 1 or not bgzf.has_eof_block(b):
            raise AssertionError(f"live: snapshot {i} is not a closed BAM")
        if b[:-28] != final[:len(b) - 28]:
            raise AssertionError(f"live: snapshot {i} is not a prefix of the output")
        with open(path + ".bai", "wb") as f:
            f.write(bai)
        idx = read_bai(path + ".bai")
        n = idx["n_no_coor"] + sum(r["meta"][2] + r["meta"][3] for r in idx["refs"] if r["meta"])
        if n != n_committed or n <= n_prev:
            raise AssertionError(f"live: snapshot {i} indexes {n} records, "
                                 f"{n_committed} committed, {n_prev} before")
        if i == 0:
            with open(path, "wb") as f:
                f.write(b)
            if len(read_bam(path)[1]) != n:
                raise AssertionError("live: the first snapshot does not parse to its records")
        n_prev = n
    for leftover in (snap, snap + ".bai", out + ".livemark"):
        if os.path.exists(leftover):
            raise AssertionError(f"live: {leftover} left behind")
    emit("live", config="config5 (min_duplex_reads=1)", settings=settings,
         reads_in=rep.n_records, n_chunks=rep.n_chunks, snapshots=rep.snapshot_seq,
         append_seconds=round(t_last[0] - t0, 3), blocks=len(blocks), writes=n_writes,
         first_snapshot_s=round(t_first[0] - t0, 3),
         lag_last_append_to_output_s=round(t_out - t_last[0], 3),
         wall_seconds=round(t_out - t0, 3), live_poll_s=rep.seconds["live_poll"],
         live_wait_s=rep.seconds["live_wait"], bytes_identical_to_stream=True,
         snapshots_valid_prefixes=True, snapshot_records_last=n_prev, launches=launches,
         nvidia_smi=smi)
    os.remove(grow)
    os.remove(out)
    return launches


def serve_phase(in_bam: str, small_bams: list, td: str, smi: str,
                device: str = "cuda") -> tuple[dict, str, float, dict]:
    """The service on the card: an in-process ConsensusService runs a job
    on the stream cell's input and two smaller jobs under a chunk budget
    that preempts the large one; each output equals the one-shot stream
    with serve_provenance. Then daemon A (a subprocess) is SIGKILLed once
    its job (on the larger small input) has committed a chunk, and
    daemon B --once takes the job over:
    the bytes equal the reference, the job's token is 2 or more, and
    the port's serve_report reads one takeover and no fenced slice.
    Reports each job's wall and queue wait and the takeover gap.
    Returns the kernels' launches on the path (B's included), the large
    job's one-shot reference (its path, with a .bai, and wall), and the
    two spools it leaves for the fleet phase ({"serve": (spool, the
    in-process daemon's capture), "takeover": (spool, None)})."""
    import io
    import signal

    import torch

    from duplexumiconsensusreads_torch.serve import ConsensusService, client
    from duplexumiconsensusreads_torch.tools import serve_report

    config = dict(SERVE_CONFIG)
    refs = {}
    for name, path in [("large", in_bam)] + [(f"small{i}", p) for i, p in enumerate(small_bams)]:
        refs[name] = job_reference(path, os.path.join(td, f"ref_{name}.bam"), config, device)
    spool = os.path.join(td, "serve_spool")
    trace = os.path.join(td, "serve.trace.jsonl")
    jobs = {}
    for name, path in [("large", in_bam)] + [(f"small{i}", p) for i, p in enumerate(small_bams)]:
        out = os.path.join(td, f"serve_{name}.bam")
        jobs[name] = (client.submit(spool, path, out, config=config), out)
    if device == "cuda":
        torch.cuda.synchronize()
    reset_launches()
    t0 = time.monotonic()
    svc = ConsensusService(spool, device=device, chunk_budget=SERVE_CHUNK_BUDGET,
                           trace_path=trace, poll_s=0.05)
    snap = svc.run_until_idle()
    serve_wall = time.monotonic() - t0
    launches = read_launches("serve")
    if snap["jobs_done"] != len(jobs) or snap["preemptions"] < 1:
        raise AssertionError(f"serve: {snap}")
    for name, (jid, out) in jobs.items():
        ref = os.path.join(td, f"ref_{name}.bam")
        if read_bytes(out) != refs[name][0] or read_bytes(out + ".bai") != read_bytes(ref + ".bai"):
            raise AssertionError(f"serve: job {name} differs from its one-shot reference")
    epoch, events = capture_events(trace)
    summary = serve_report.summarize([json.loads(line) for line in open(trace)])
    per_job = {}
    for name, (jid, _) in jobs.items():
        acc = next(e["t"] for e in events if e.get("job") == jid and e["name"] == "job_accepted")
        start = next(e["t"] for e in events if e.get("job") == jid and e["name"] == "job_started")
        j = summary["jobs"][jid]
        per_job[name] = {"wall_s": j["wall_s"], "queue_wait_s": round(start - acc, 3),
                         "slices": j["slices"], "preemptions": j["preemptions"],
                         "warm": j["warm"], "mfu": j.get("mfu"),
                         "oneshot_wall_s": round(refs[name][1], 3), "bytes_identical": True}
    for _, out in jobs.values():
        os.remove(out)
        os.remove(out + ".bai")

    # ---- kill and takeover: daemon A dies holding the lease, B takes over
    tk_spool = os.path.join(td, "takeover_spool")
    tk_out = os.path.join(td, "takeover.bam")
    tk_in = small_bams[-1]
    tk_config = dict(config, chunk_reads=TAKEOVER_CHUNK_READS)
    tk_ref, _ = job_reference(tk_in, os.path.join(td, "ref_takeover.bam"), tk_config, device)
    jid = client.submit(tk_spool, tk_in, tk_out, config=tk_config)
    if device == "cuda":
        torch.cuda.empty_cache()
    a = start_daemon(tk_spool, "smoke-A", os.path.join(td, "a.counts"), device,
                     "--heartbeat", "0.5", "--lease", "60")
    try:
        deadline = time.monotonic() + SERVE_DAEMON_TIMEOUT_S
        while True:
            try:
                with open(tk_out + ".ckpt") as f:
                    if json.load(f).get("done"):
                        break
            except (OSError, ValueError):
                pass
            if a.poll() is not None:
                raise AssertionError(f"daemon A exited {a.returncode}: {a.communicate()[1][-2000:]}")
            if time.monotonic() > deadline:
                raise AssertionError("daemon A committed no chunk in time")
            time.sleep(0.05)
        a.send_signal(signal.SIGKILL)
        t_kill = time.monotonic()
        a.communicate(timeout=60)
    finally:
        if a.poll() is None:
            a.kill()
            a.communicate(timeout=60)
    st = client.status(tk_spool, jid)
    if st.get("state") != "running" or st["lease"]["owner"] != "smoke-A":
        raise AssertionError(f"after the kill: {st}")
    b_counts = os.path.join(td, "b.counts")
    b = start_daemon(tk_spool, "smoke-B", b_counts, device, "--once", "--heartbeat", "0")
    finish_daemon(b, SERVE_DAEMON_TIMEOUT_S, "daemon B")
    b_done = time.monotonic()
    launches = add_launches(launches, b_counts, "serve")
    st = client.status(tk_spool, jid)
    if st["state"] != "done" or st["token"] < 2 or read_bytes(tk_out) != tk_ref:
        raise AssertionError(f"takeover: {st.get('state')} token {st.get('token')}, "
                             f"bytes identical {read_bytes(tk_out) == tk_ref}")
    b_trace = os.path.join(tk_spool, "service.smoke-B.trace.jsonl")
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        rc = serve_report.main([b_trace, "--json"])
    rep_b = json.loads(buf.getvalue())
    if rc != 0 or rep_b["n_takeovers"] != 1 or rep_b["n_fenced"] != 0:
        raise AssertionError(f"serve_report on B's capture: {rc} {rep_b}")
    epoch_b, ev_b = capture_events(b_trace)
    takeover_t = next(epoch_b + e["t"] for e in ev_b if e["name"] == "lease_takeover")
    started_t = next(epoch_b + e["t"] for e in ev_b
                     if e["name"] == "job_started" and e.get("job") == jid)
    emit("serve", config=config, chunk_budget=SERVE_CHUNK_BUDGET, jobs=per_job,
         service_wall_s=round(serve_wall, 3), preemptions=snap["preemptions"],
         compile_hit_rate=snap["compile_hit_rate"], mfu=snap["mfu"],
         device_s=snap["device_s"],
         takeover={"input_reads": st["result"]["n_records"],
                   "chunk_reads": TAKEOVER_CHUNK_READS, "token": st["token"],
                   "n_takeovers": rep_b["n_takeovers"],
                   "n_fenced": rep_b["n_fenced"], "reason": "dead-owner",
                   "kill_to_takeover_s": round(takeover_t - t_kill, 3),
                   "kill_to_claim_s": round(started_t - t_kill, 3),
                   "kill_to_done_s": round(b_done - t_kill, 3),
                   "bytes_identical": True},
         launches=launches, nvidia_smi=smi)
    for name in refs:
        if name != "large":
            os.remove(os.path.join(td, f"ref_{name}.bam"))
            os.remove(os.path.join(td, f"ref_{name}.bam.bai"))
    for path in (tk_out, os.path.join(td, "ref_takeover.bam")):
        os.remove(path)
        os.remove(path + ".bai")
    return (launches, os.path.join(td, "ref_large.bam"), refs["large"][1],
            {"serve": (spool, trace), "takeover": (tk_spool, None)})


def shard_phase(in_bam: str, ref: str, unsharded_s: float, td: str, smi: str,
                device: str = "cuda") -> tuple[dict, str]:
    """Scatter-gather on the card: ``call --submit --shards 4
    --write-index`` of the stream cell's input, run by two daemon
    subprocesses on one spool; ``call --wait`` exits 0 and the merged
    BAM and .bai equal the unsharded one-shot run's (the serve phase's
    large-job reference ``ref``, timed ``unsharded_s``: the job's @PG
    line is the same). Reports the sharded and the unsharded wall.
    Returns the kernels' launches on the path (the daemons' counts) and
    the spool, which it leaves for the fleet phase."""
    import io

    import torch

    from duplexumiconsensusreads_torch.cli.main import main as cli_main
    from duplexumiconsensusreads_torch.serve import client
    from duplexumiconsensusreads_torch.serve.job import serve_provenance

    spool = os.path.join(td, "shard_spool")
    out = os.path.join(td, "sharded.bam")
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        rc = cli_main(["call", in_bam, "-o", out, "--submit", "--spool", spool,
                       "--config", "config5", "--min-duplex-reads", "1",
                       "--capacity", str(CAPACITY), "--chunk-reads", str(STREAM_CHUNK_READS),
                       "--write-index", "--shards", str(SHARDS)])
    jid = buf.getvalue().strip()
    if rc != 0 or not jid.startswith("job-"):
        raise AssertionError(f"shard: call --submit exited {rc}")
    with open(os.path.join(spool, "inbox", f"{jid}.json")) as f:
        config = json.load(f)["config"]
    if serve_provenance(config) != serve_provenance(SERVE_CONFIG):
        raise AssertionError("shard: the job's @PG line is not the serve reference's")
    ref_bytes = read_bytes(ref)
    if device == "cuda":
        torch.cuda.empty_cache()
    reset_launches()
    counts = [os.path.join(td, f"shard{i}.counts") for i in range(2)]
    t0 = time.monotonic()
    procs = [start_daemon(spool, f"shard-{i}", counts[i], device, "--once", "--heartbeat", "0")
             for i in range(2)]
    for i, p in enumerate(procs):
        finish_daemon(p, SERVE_DAEMON_TIMEOUT_S, f"shard daemon {i}")
    sharded_s = time.monotonic() - t0
    launches = {}
    for c in counts:
        launches = add_launches(launches, c, "shard")
    if not path_launched(launches):
        raise AssertionError(f"the shard path launched {launches}")
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        rc = cli_main(["call", "--wait", jid, "--spool", spool, "--wait-timeout", "60", "--json"])
    st = client.status(spool, jid)
    if rc != 0 or st["state"] != "done" or st["shards"]["done"] != SHARDS:
        raise AssertionError(f"shard: --wait exited {rc}, {st.get('state')} {st.get('shards')}")
    if read_bytes(out) != ref_bytes or read_bytes(out + ".bai") != read_bytes(ref + ".bai"):
        raise AssertionError("shard: the merged BAM or .bai differs from the unsharded run")
    emit("shard", config=config, shards=SHARDS, daemons=2, reads=st["result"]["n_records"],
         sharded_wall_s=round(sharded_s, 3), unsharded_wall_s=round(unsharded_s, 3),
         merge_s=st["result"]["sharded"]["merge_s"], shard_states=st["shards"],
         bam_identical=True, bai_identical=True, launches=launches, nvidia_smi=smi)
    for p in (out, out + ".bai", ref, ref + ".bai"):
        os.remove(p)
    return launches, spool


def fleet_phase(spools: dict, td: str, smi: str) -> None:
    """The port's fleet_report over the spools the serve and shard
    phases left ({name: (spool, extra capture or None)}): each exits 0
    with ok true, every job's segments plus gaps tile its admission to
    terminal exactly, the takeover spool shows one takeover and the
    shard spool one split and one merge, and the --prom and --chrome
    files are written. Then a copy of the takeover spool's captures
    with daemon B's job_started line dropped must exit 1. Launches no
    kernel: it reads files. Removes the spools."""
    import shutil

    rows = {}
    for name, (spool, capture) in spools.items():
        prom, chrome = os.path.join(td, f"{name}.prom"), os.path.join(td, f"{name}.fleet.json")
        argv = [spool, *([capture] if capture else []), "--json", "--prom", prom,
                "--chrome", chrome]
        rc, text, err = run_tool("fleet_report", argv)
        doc = json.loads(text) if text else {}
        if rc != 0 or not doc.get("ok"):
            raise AssertionError(f"fleet_report on the {name} spool exited {rc}: "
                                 f"{doc.get('problems')} {err[-1000:]}")
        jobs = doc["jobs"]
        for jid, tl in jobs.items():
            tiled = sum(s["t1_us"] - s["t0_us"] for s in tl["segments"]) + sum(
                g["t1_us"] - g["t0_us"] for g in tl["gaps"])
            if tl["sum_check_ok"] is not True or tiled != tl["wall_us"]:
                raise AssertionError(f"fleet {name}: job {jid} does not tile its life")
        m = doc["metrics"]
        if not (os.path.getsize(prom) > 0 and json.load(open(chrome))["traceEvents"]):
            raise AssertionError(f"fleet {name}: empty --prom or --chrome output")
        want = {"serve": {"fleet_takeovers": 0, "fleet_done": 3},
                "takeover": {"fleet_takeovers": 1, "fleet_done": 1},
                "shard": {"fleet_splits": 1, "fleet_merges": 1, "fleet_done": 1 + SHARDS}}[name]
        got = {k: m[k] for k in want}
        if got != want or (name == "serve" and m["fleet_preemptions"] < 1):
            raise AssertionError(f"fleet {name}: {got} (want {want}), "
                                 f"preemptions {m['fleet_preemptions']}")
        rows[name] = {k: m[k] for k in ("fleet_daemons", "fleet_jobs", "fleet_done",
                                        "fleet_takeovers", "fleet_preemptions",
                                        "fleet_splits", "fleet_merges", "fleet_wall_s",
                                        "queue_wait_p95_s", "e2e_p50_s", "e2e_p95_s",
                                        "takeover_gap_max_s")}
        rows[name].update(jobs=len(jobs), sum_checks_exact=True,
                          daemons=sorted(m["daemons"]), warnings=len(doc["warnings"]))
    # the tamper: daemon B's capture (a clean one) without its claim
    tk_spool = spools["takeover"][0]
    tampered = os.path.join(td, "fleet_tamper")
    os.makedirs(tampered)
    b_trace = os.path.join(tk_spool, "service.smoke-B.trace.jsonl")
    with open(b_trace) as f:
        recs = [json.loads(line) for line in f]
    keep = [r for r in recs if r.get("name") != "job_started"]
    if len(keep) != len(recs) - 1 or keep[-1].get("type") != "summary":
        raise AssertionError("fleet tamper: B's capture is not a clean one-claim capture")
    with open(os.path.join(tampered, "service.smoke-B.trace.jsonl"), "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in keep)
    shutil.copy(os.path.join(tk_spool, "service.smoke-A.trace.jsonl"), tampered)
    rc, _, err = run_tool("fleet_report", [os.path.join(tampered, n)
                                           for n in sorted(os.listdir(tampered))])
    if rc != 1 or "FLEET TIMELINE DRIFT" not in err:
        raise AssertionError(f"fleet_report exited {rc} on the dropped job_started")
    emit("fleet", spools=rows, tampered={"dropped": "job_started", "capture": "smoke-B",
                                         "exit": rc},
         e2e_p95_s=rows["serve"]["e2e_p95_s"],
         takeover_gap_max_s=rows["takeover"]["takeover_gap_max_s"], nvidia_smi=smi)
    for spool, _ in spools.values():
        shutil.rmtree(spool, ignore_errors=True)
    shutil.rmtree(tampered, ignore_errors=True)


# one host of a multi-host call run in a subprocess by the multihost
# phase: the port's CLI main, then its kernel launch counts, its wall
# and its coordination barriers' times written to the file named by the
# first argument (the counters live in the host's process)
HOST_CHILD = """
import json, sys, time
sys.path.insert(0, {here!r})
from duplexumiconsensusreads_torch.kernels import cluster_fixpoint, segment_gemm
from duplexumiconsensusreads_torch.runtime import graphs
from duplexumiconsensusreads_torch.parallel import distributed
from duplexumiconsensusreads_torch.cli.main import main
barriers = []
inner = distributed.coordination_barrier
def timed(name, *a, **k):
    t0 = time.monotonic()
    out = inner(name, *a, **k)
    barriers.append([name, t0, time.monotonic()])
    return out
distributed.coordination_barrier = timed
t0 = time.monotonic()
rc = main(sys.argv[2:])
with open(sys.argv[1], "w") as f:
    json.dump({{"segment_gemm": segment_gemm.segment_gemm.launches,
               "directional_cluster": cluster_fixpoint.directional_cluster.launches,
               "wall_s": time.monotonic() - t0, "barriers": barriers}}, f)
with open(sys.argv[1] + ".graphs", "w") as f:
    c = graphs.read_counts()
    json.dump({{**{{k: {{m: c[k][m] for m in graphs.MODES}} for k in graphs.KINDS}},
               "classes": c["classes"],
               "pools": {{k: c[k] for k in ("pool_peak_bytes", "card_free_min")}}}}, f)
sys.exit(rc)
"""


def start_host(in_bam: str, out: str, pid: int, chunk_reads: int, counts: str, env: dict,
               *extra):
    """Host ``pid`` of 2 of ``call --config config3`` on the card, in a
    subprocess loading the kernels this process built."""
    from duplexumiconsensusreads_torch.kernels import build
    from duplexumiconsensusreads_torch.utils.compile_cache import ENV_VAR, build_dir

    argv = [sys.executable, "-c", HOST_CHILD.format(here=HERE), counts, "call", in_bam,
            "-o", out, "--config", "config3", "--chunk-reads", str(chunk_reads),
            "--n-hosts", "2", "--host-id", str(pid), *extra]
    env = {**os.environ, ENV_VAR: build_dir(build.BUILD_DIR), **env}
    return subprocess.Popen(argv, cwd=HERE, env=env, stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)


def store_env(port: int, pid: int) -> dict:
    return {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port), "WORLD_SIZE": "2",
            "RANK": str(pid)}


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def compare_host_concat(parts: list, whole: str) -> dict:
    """The hosts' outputs, concatenated in host order, against a one-host
    stream of the same input: every record identical but its name. A
    name carries its host's ``h{pid}_`` tag and its chunk's number and
    molecule count, which follow each host's own chunking; the position
    fields of the names must agree. An idle host (no records in its
    range) wrote nothing. Raises otherwise."""
    import numpy as np

    from duplexumiconsensusreads_torch.io import read_bam

    _, w = read_bam(whole)
    cat = [(pid, read_bam(p)[1]) for pid, p in parts if os.path.exists(p)]
    if sum(len(r) for _, r in cat) != len(w):
        raise AssertionError("multihost: the hosts' record count is not the one-host run's")
    if not all(n.startswith(f"consh{pid}_") for pid, r in cat for n in r.names):
        raise AssertionError("multihost: a host's names lack its tag")
    if [n.split(":")[1:3] for _, r in cat for n in r.names] != [
            n.split(":")[1:3] for n in w.names]:
        raise AssertionError("multihost: the names' positions differ from the one-host run's")
    for f in ("flags", "ref_id", "pos", "mapq", "tlen", "seq", "qual", "lengths"):
        got = np.concatenate([np.asarray(getattr(r, f)) for _, r in cat])
        if not np.array_equal(got, np.asarray(getattr(w, f))):
            raise AssertionError(f"multihost: the concatenation differs in {f}")
    if [a for _, r in cat for a in r.aux_raw] != list(w.aux_raw):
        raise AssertionError("multihost: the concatenation differs in its aux tags")
    return {"records": len(w), "per_host": [len(r) for _, r in cat],
            "identical_but_names": True}


def multihost_phase(in_bam: str, td: str, smi: str) -> dict:
    """Two hosts of ``call --n-hosts 2 --config config3`` on the serve
    phase's 250k input in 50k-read chunks, concurrently on this card
    over a localhost TCPStore, with no .dlix at the start: both report
    a 2-process runtime and launch both kernels, one .dlix is written,
    and the concatenated outputs equal a one-host config3 stream record
    by record (names aside). Then, the input indexed every
    RESUME_INDEX_EVERY records, host 1 is SIGKILLed once its manifest
    holds a done chunk and relaunched alone with --resume: it skips
    exactly the manifest's chunks and the concatenation is unchanged.
    Reports each host's wall, the one-host wall and the index election's
    time. Returns the kernels' launches, summed over the hosts."""
    import shutil
    import signal

    from duplexumiconsensusreads_torch.cli.main import params_for
    from duplexumiconsensusreads_torch.io.index import BamLinearIndex, build_linear_index
    from duplexumiconsensusreads_torch.runtime.stream import stream_call_consensus

    gp3, cp3, cap3 = params_for("config3")
    mh = os.path.join(td, "multihost")
    os.makedirs(mh)
    src = os.path.join(mh, "in.bam")
    os.link(in_bam, src)  # the .dlix lands here, not beside the cached input
    whole = os.path.join(mh, "whole.bam")
    t0 = time.monotonic()
    stream_call_consensus(src, whole, gp3, cp3, device="cuda", capacity=cap3,
                          chunk_reads=TAKEOVER_CHUNK_READS)
    one_host_s = time.monotonic() - t0
    port = free_port()
    counts = [os.path.join(mh, f"host{pid}.counts") for pid in range(2)]
    out = os.path.join(mh, "mh.bam")
    t0 = time.monotonic()
    procs = [start_host(src, out, pid, TAKEOVER_CHUNK_READS, counts[pid],
                        store_env(port, pid)) for pid in range(2)]
    errs = [finish_daemon(p, SERVE_DAEMON_TIMEOUT_S, f"host {pid}")
            for pid, p in enumerate(procs)]
    both_s = time.monotonic() - t0
    hosts = []
    launches = {}
    for pid, (err, c) in enumerate(zip(errs, counts)):
        if f"distributed runtime: process {pid}/2" not in err:
            raise AssertionError(f"host {pid} ran without the 2-process runtime: {err[-1000:]}")
        with open(c) as f:
            got = json.load(f)
        if not path_launched(got):
            raise AssertionError(f"host {pid} launched {got}")
        b = {name: (t0_, t1_) for name, t0_, t1_ in got["barriers"]}
        hosts.append({"wall_s": round(got["wall_s"], 3),
                      "launches": {k: got[k] for k in kernel_wrappers()},
                      "index_election_s": round(b["duplexumi:index:done"][1]
                                                - b["duplexumi:index:elect"][0], 3)})
        launches = {k: launches.get(k, 0) + got[k] for k in kernel_wrappers()}
        note_child_graphs("multihost", c)
    if sorted(n for n in os.listdir(mh) if ".dlix" in n) != ["in.bam.dlix"]:
        raise AssertionError(f"multihost: index files {os.listdir(mh)}")
    parts = [(pid, os.path.join(mh, f"mh.host{pid}.bam")) for pid in range(2)]
    concat = compare_host_concat(parts, whole)
    # a host is idle only when the index has a single tile
    tiles = len(BamLinearIndex.load(src + ".dlix").pos_key)
    if tiles > 1 and len(concat["per_host"]) != 2:
        raise AssertionError(f"multihost: {tiles} index tiles, hosts {concat['per_host']}")
    concat["index_tiles"] = tiles
    for _, p in parts:
        if os.path.exists(p):
            os.remove(p)

    # kill and resume: host 1 dies after a committed chunk and resumes
    # alone (host 0 has finished: its store is gone)
    build_linear_index(src, every=RESUME_INDEX_EVERY).save(src + ".dlix")
    ckpt = os.path.join(mh, "ckpt")
    port = free_port()
    p0, p1 = (start_host(src, out, pid, TAKEOVER_CHUNK_READS, counts[pid], store_env(port, pid),
                         "--checkpoint", ckpt) for pid in range(2))
    try:
        deadline = time.monotonic() + SERVE_DAEMON_TIMEOUT_S
        while True:
            try:
                with open(ckpt + ".host1") as f:
                    if json.load(f).get("done"):
                        break
            except (OSError, ValueError):
                pass
            if p1.poll() is not None:
                raise AssertionError(f"host 1 exited {p1.returncode} before its kill: "
                                     f"{p1.communicate()[1][-2000:]}")
            if time.monotonic() > deadline:
                raise AssertionError("host 1 committed no chunk in time")
            time.sleep(0.02)
        p1.send_signal(signal.SIGKILL)
        p1.communicate(timeout=60)
        finish_daemon(p0, SERVE_DAEMON_TIMEOUT_S, "host 0 beside the killed host")
    finally:
        for p in (p0, p1):
            if p.poll() is None:
                p.kill()
                p.communicate(timeout=60)
    with open(ckpt + ".host1") as f:
        done_before = len(json.load(f)["done"])
    report = os.path.join(mh, "report.json")
    env = {k: "" for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")}
    r1 = start_host(src, out, 1, TAKEOVER_CHUNK_READS, counts[1], env, "--checkpoint", ckpt,
                    "--resume", "--report", report)
    err = finish_daemon(r1, SERVE_DAEMON_TIMEOUT_S, "the resumed host 1")
    with open(report + ".host1") as f:
        rep = json.load(f)
    if "distributed runtime" in err or rep["n_chunks_skipped"] != done_before \
            or rep["n_chunks"] <= rep["n_chunks_skipped"]:
        raise AssertionError(f"resumed host 1: skipped {rep['n_chunks_skipped']} of "
                             f"{rep['n_chunks']}, manifest {done_before}")
    resumed = compare_host_concat(parts, whole)
    shutil.rmtree(mh)
    emit("multihost", config="config3", input="the serve phase's 250k-read input",
         chunk_reads=TAKEOVER_CHUNK_READS, hosts=hosts, both_hosts_wall_s=round(both_s, 3),
         one_host_wall_s=round(one_host_s, 3), concat=concat, dlix_written=1,
         kill_resume={"index_every": RESUME_INDEX_EVERY, "done_before_kill": done_before,
                      "chunks_skipped": rep["n_chunks_skipped"], "chunks": rep["n_chunks"],
                      "concat": resumed},
         launches=launches, nvidia_smi=smi)
    return launches


class RungKeeper:
    """Wraps consensus.segment_gemm and keeps, for each key of a call on
    the card (``key(big, f_max)``; by default the row count R, a ladder
    rung), the arguments of its call with the most elements."""

    def __init__(self, module, key=lambda big, f_max: big.shape[1]):
        self.module, self.inner, self.key = module, module.segment_gemm, key
        self.calls: dict = {}
        self.shapes: set = set()

    def __enter__(self):
        def wrapped(big, fid, f_max):
            self.shapes.add(tuple(big.shape))
            k = self.key(big, f_max)
            if big.is_cuda and (k not in self.calls or big.numel() > self.calls[k][0].numel()):
                self.calls[k] = (big, fid, f_max)
            return self.inner(big, fid, f_max)

        self.module.segment_gemm = wrapped
        return self

    def __exit__(self, *exc):
        self.module.segment_gemm = self.inner


def ladder_phase(in_bam: str, out_bam: str, gp, cp, settings: dict, td: str, smi: str,
                 free_bam: str):
    """The stream phase's input and settings with bucket_ladder "auto"
    and LADDER.

    The main path (config5): verdicts, fills, walls and launch shapes,
    and the records against the ladder-off output of the stream phase.
    config5's quals move with the ladder, in the JAX package too: its
    cycle error model is fit per bucket, and a ladder regroups the
    buckets (ROADMAP Faults found); those cycles are counted, and every
    other field must be identical. Byte identity is held where the
    output does not depend on the bucket composition: ``free_bam`` (the
    serve phase's 250k-read input, in TAKEOVER_CHUNK_READS chunks) under
    the model-free duplex config, ladder off, auto and LADDER, then a
    kill under auto and a resume under LADDER. Returns the
    launches of the two config5 ladder runs, the explicit run's largest
    launch per rung, and {name: (trace, output)} of their captures."""
    import numpy as np
    import torch

    from duplexumiconsensusreads_torch.io import read_bam
    from duplexumiconsensusreads_torch.kernels import consensus
    from duplexumiconsensusreads_torch.runtime import faults
    from duplexumiconsensusreads_torch.runtime.stream import stream_call_consensus

    t_phase = time.monotonic()
    off = read_bam(out_bam)[1]
    runs, captures = {}, {}
    torch.cuda.synchronize()
    reset_launches()
    for name, ladder in (("auto", "auto"), ("explicit", LADDER)):
        out = os.path.join(td, f"ladder_{name}.bam")
        trace = os.path.join(td, f"ladder_{name}.trace.jsonl")
        with RungKeeper(consensus) as keep:
            t0 = time.monotonic()
            rep = stream_call_consensus(in_bam, out, gp, cp, device="cuda", trace_path=trace,
                                        bucket_ladder=ladder, **settings)
            wall = time.monotonic() - t0
        recs = [json.loads(line) for line in open(trace)]
        verdicts = [{k: r[k] for k in ("chunk", "ladder", "fill_factor", "fill_factor_off",
                                       "predicted_speedup", "n_groups", "source")}
                    for r in recs if r.get("name") == "tuner_verdict"]
        if (name == "auto") != bool(verdicts) or len(verdicts) > 1:
            raise AssertionError(f"{name}: tuner verdicts {verdicts}")
        # against the ladder-off output: every field but seq/qual equal
        got = read_bam(out)[1]
        if len(got) != len(off) or got.names != off.names or any(
                not np.array_equal(np.asarray(getattr(got, f)), np.asarray(getattr(off, f)))
                for f in ("flags", "ref_id", "pos", "lengths")) or got.cigars != off.cigars:
            raise AssertionError(f"bucket_ladder={ladder!r} changed the consensus records")
        sa, sb = np.asarray(got.seq), np.asarray(off.seq)
        dq = np.abs(np.asarray(got.qual).astype(int) - np.asarray(off.qual).astype(int))
        rows = sorted({s[1] for s in keep.shapes})
        runs[name] = {
            "bucket_ladder": rep.bucket_ladder, "wall_seconds": round(wall, 3),
            "reads_per_s": round(rep.n_valid_reads / wall, 1), "verdict": verdicts,
            "fill_measured": rep.n_rows_real / rep.n_rows_padded,
            "n_rows_real": rep.n_rows_real, "n_rows_padded": rep.n_rows_padded,
            "buckets": rep.n_buckets, "dispatch_specs": rep.n_pipeline_compiles,
            "segment_gemm_shapes": sorted(list(s) for s in keep.shapes),
            "segment_gemm_rows": rows, "bytes_h2d": rep.bytes_h2d, "bytes_d2h": rep.bytes_d2h,
            "stage_seconds": rep.seconds,
            "vs_ladder_off": {"records": len(got), "other_fields_identical": True,
                              "cycles": int(sa.size), "bases_differ": int((sa != sb).sum()),
                              "quals_differ": int((dq > 0).sum()),
                              "max_qual_diff": int(dq.max(initial=0))},
        }
        captures[f"ladder_{name}"] = (trace, out)
        if name == "explicit":
            want = [int(r) for r in LADDER.split(",")]
            if rep.bucket_ladder != want or not set(want) <= set(rows):
                raise AssertionError(f"explicit ladder {rep.bucket_ladder}: launch rows {rows}")
            torch.cuda.synchronize()
            rung_calls = {r: keep.calls[r] for r in want}
        del keep, got
    launches = read_launches("ladder")
    del off

    # byte identity where the output cannot depend on the buckets' make-up
    cp_free = dataclasses.replace(cp, error_model=None)
    in_bam, settings = free_bam, dict(settings, chunk_reads=TAKEOVER_CHUNK_READS)
    ident = {}
    ref_path = os.path.join(td, "ladder_free_off.bam")
    t0 = time.monotonic()
    rep = stream_call_consensus(in_bam, ref_path, gp, cp_free, device="cuda", **settings)
    ident["off"] = {"wall_seconds": round(time.monotonic() - t0, 3),
                    "n_rows_padded": rep.n_rows_padded}
    ref_bytes = read_bytes(ref_path)
    for name, ladder in (("auto", "auto"), ("explicit", LADDER)):
        path = os.path.join(td, f"ladder_free_{name}.bam")
        t0 = time.monotonic()
        rep = stream_call_consensus(in_bam, path, gp, cp_free, device="cuda",
                                    bucket_ladder=ladder, **settings)
        if read_bytes(path) != ref_bytes:
            raise AssertionError(f"bucket_ladder={ladder!r} changed the model-free bytes")
        ident[name] = {"bucket_ladder": rep.bucket_ladder, "identical": True,
                       "wall_seconds": round(time.monotonic() - t0, 3),
                       "n_rows_padded": rep.n_rows_padded}
    # killed at chunk 1's checkpoint mark under auto, resumed under LADDER
    killed = os.path.join(td, "ladder_killed.bam")
    faults.install(faults.FaultPlan.parse("ckpt.save:3:kill"))
    try:
        stream_call_consensus(in_bam, killed, gp, cp_free, device="cuda", bucket_ladder="auto",
                              **settings)
        raise AssertionError("the injected kill did not fire")
    except faults.InjectedKill:
        pass
    finally:
        faults.uninstall()
    with open(killed + ".ckpt") as f:
        committed = len(json.load(f)["done"])
    if committed < 1 or os.path.exists(killed):
        raise AssertionError(f"killed ladder run: {committed} committed chunks")
    r = stream_call_consensus(in_bam, killed, gp, cp_free, device="cuda", bucket_ladder=LADDER,
                              resume=True, **settings)
    if read_bytes(killed) != ref_bytes:
        raise AssertionError("the resume under another ladder changed the bytes")
    emit("ladder", config="config5 (min_duplex_reads=1)",
         ladders={"auto": "auto", "explicit": LADDER}, runs=runs,
         launches=launches,
         byte_identity={"config": "config5 with error_model=None", "input": free_bam,
                        "chunk_reads": TAKEOVER_CHUNK_READS, "runs": ident,
                        "resume": {"kill": "ckpt.save:3:kill", "killed_under": "auto",
                                   "resumed_under": LADDER, "committed_before_kill": committed,
                                   "chunks_skipped": r.n_chunks_skipped, "identical": True}},
         phase_seconds=round(time.monotonic() - t_phase, 3), nvidia_smi=smi)
    return launches, rung_calls, captures


def _tamper(src: str, dst: str, pick, change) -> str:
    """A copy of a capture with the first record ``pick`` accepts
    changed by ``change``."""
    done = False
    with open(src) as f, open(dst, "w") as g:
        for line in f:
            rec = json.loads(line)
            if not done and pick(rec):
                change(rec)
                done = True
            g.write(json.dumps(rec) + "\n")
    if not done:
        raise AssertionError(f"nothing to tamper in {src}")
    return dst


def run_tool(name: str, argv: list) -> tuple[int, str, str]:
    """One in-process run of a port tool's main: (exit code, stdout,
    stderr)."""
    import importlib
    import io

    mod = importlib.import_module(f"duplexumiconsensusreads_torch.tools.{name}")
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = mod.main([str(a) for a in argv])
    return rc, out.getvalue(), err.getvalue()


def capture_phase(captures: dict, td: str, smi: str) -> None:
    """The port's analysers on each capture ({name: (trace, output)}):
    the time, byte, output and device sum-checks; the per-class device
    ledger against the resolved peak (an h100 entry); the wire floor and
    measured bandwidth; every tool exits 0 on each capture and 1 on its
    tampered copy."""
    from duplexumiconsensusreads_torch.telemetry import devledger, ledger, report
    from duplexumiconsensusreads_torch.telemetry.device import device_peak_flops

    peak, entry = device_peak_flops()
    if not entry.startswith("h100"):
        raise AssertionError(f"the device table resolved {entry!r} on this card")
    out = {}
    for name, (trace, bam) in captures.items():
        recs = report.load_trace(trace)
        problems = report.validate_trace(recs)
        t_rows, t_ok = report.sum_check(recs)
        b_rows, b_ok = ledger.sum_check_bytes(recs)
        o_problems, o_ok = ledger.output_check(recs)
        d_rows, d_ok = devledger.sum_check_dev(recs)
        fill = ledger.fill_stats(recs)
        if problems or not (t_ok and b_ok and o_ok and d_ok and fill.get("sum_check_ok", True)):
            raise AssertionError(f"{name}: problems {problems[:5]}, sum-checks time {t_ok} "
                                 f"bytes {b_ok} output {o_ok} {o_problems} device {d_ok}")
        exits = {}
        for tool, flags in (("trace_report", []), ("check_trace", ["--require-summary"]),
                            ("wirestat", ["--out", bam]), ("devstat", [])):
            rc, text, err = run_tool(tool, [trace, *flags])
            if rc != 0:
                raise AssertionError(f"{tool} exited {rc} on {name}: {err[-1000:]}")
            exits[tool] = rc
            if tool == "devstat":
                devstat_table = text.splitlines()
        roof = devledger.roofline(recs)
        out[name] = {
            "sum_checks": {"time": t_ok, "bytes": b_ok, "output": o_ok, "device": d_ok,
                           "fill": fill.get("sum_check_ok", True)},
            "device_sum_check_rows": d_rows,
            "classes": {k: {f: d[f] for f in ("n", "buckets", "flops", "busy_s", "mfu",
                                              "intensity")}
                        | {"verdict": roof["classes"][k]["verdict"]}
                        for k, d in devledger.class_stats(recs).items()},
            "totals": devledger.device_totals(recs),
            "roofline": {k: v for k, v in roof.items() if k != "classes"},
            "wire_floor": ledger.wire_floor(recs), "bandwidth": ledger.bandwidth_stats(recs),
            "fill": fill, "packing": ledger.packing_stats(recs),
            "devstat_table": devstat_table, "tool_exits": exits,
        }
    # tampered copies of the stream capture: each tool refuses its own
    trace = captures["stream"][0]
    tampered = {
        "xfer_wire": ("wirestat", _tamper(
            trace, os.path.join(td, "t_wire.jsonl"),
            lambda r: r.get("type") == "xfer" and r.get("dir") == "shard",
            lambda r: r.update(wire=r["wire"] + 12345))),
        "dev_flops": ("devstat", _tamper(
            trace, os.path.join(td, "t_flops.jsonl"), lambda r: r.get("type") == "dev",
            lambda r: r.update(flops=-1.0))),
        "dev_dur": ("devstat", _tamper(
            trace, os.path.join(td, "t_dur.jsonl"), lambda r: r.get("type") == "dev",
            lambda r: r.update(dur=round(r["dur"] + 1.5, 6)))),
        "span_dur": ("trace_report", _tamper(
            trace, os.path.join(td, "t_span.jsonl"),
            lambda r: r.get("type") == "span" and r.get("stage") == "scatter",
            lambda r: r.update(dur=round(r["dur"] + 1.5, 6)))),
        "float_wire": ("check_trace", _tamper(
            trace, os.path.join(td, "t_fwire.jsonl"), lambda r: r.get("type") == "xfer",
            lambda r: r.update(wire=1.5))),
    }
    refused = {}
    for case, (tool, path) in tampered.items():
        rc, _, err = run_tool(tool, [path])
        if rc != 1:
            raise AssertionError(f"{tool} exited {rc} on the {case} tamper")
        refused[case] = {"tool": tool, "exit": rc, "message": err.strip().splitlines()[-1][:160]}
    emit("capture", peak_entry=entry, peak_flops=peak, captures=out, tampered=refused,
         nvidia_smi=smi)


def race_phase(smi: str) -> int:
    """race_ssc_methods() on the card at its defaults with blockseg T
    64/128/256, then every method's fused-pipeline outputs on the same
    buckets against segment_gemm's, and blockseg run to run. Returns
    segment_gemm's launches in the race."""
    import numpy as np
    import torch

    from duplexumiconsensusreads_torch.bucketing import stack_buckets
    from duplexumiconsensusreads_torch.interop import ARRAY_KEYS, stacked_from_numpy
    from duplexumiconsensusreads_torch.ops.pipeline import fused_pipeline
    from duplexumiconsensusreads_torch.runtime.executor import partition_buckets, resolve_device
    from duplexumiconsensusreads_torch.tuning import race_ssc_methods
    from duplexumiconsensusreads_torch.tuning.tuner import race_workload

    t_phase = time.monotonic()
    dev = resolve_device("cuda")
    torch.cuda.synchronize()
    reset_launches()
    race = race_ssc_methods(blockseg_ts=(64, 128, 256))
    torch.cuda.synchronize()
    launches = read_launches("race")
    race_s = time.monotonic() - t_phase
    if race["backend"] != dev.type:
        raise AssertionError(f"race ran on {race['backend']}")

    gp, cp, n_reads, buckets = race_workload()

    def run(method, t=None):
        res = []
        for cb, spec in partition_buckets(buckets, gp, cp, method, blockseg_t=t):
            args = stacked_from_numpy(stack_buckets(cb, multiple_of=1), dev)
            o = fused_pipeline(*(args[k] for k in ARRAY_KEYS), spec)
            res.append({k: v.cpu() for k, v in o.items()})
        torch.cuda.synchronize()
        return res

    ref = run("segment_gemm")
    parity = {}
    for label, row in race["methods"].items():
        if row["method"] == "segment_gemm":
            continue
        got = run(row["method"], row["blockseg_t"])
        runsum = row["method"] == "runsum"
        n_tie = n_cyc = n_base = n_qual = max_dq = 0
        for a, b in zip(ref, got):
            for key in a:
                if key not in ("cons_base", "cons_qual") and not torch.equal(a[key], b[key]):
                    raise AssertionError(f"race parity: {label} {key} differs from segment_gemm")
            sa, sb = a["cons_base"].numpy(), b["cons_base"].numpy()
            qa, qb = a["cons_qual"].numpy().astype(int), b["cons_qual"].numpy().astype(int)
            dq = np.abs(qa - qb)
            n_cyc += sa.size
            n_base += int((sa != sb).sum())
            n_qual += int((dq > 0).sum())
            if not runsum:
                # within one per strand (a duplex qual sums two), except at
                # evidence ties: a strand tie may call another base (both
                # sides at qual <= 2 * TIE_QUAL) or move an agreeing duplex
                # qual by up to 2 * TIE_QUAL + 2
                tie = (((sa != sb) & (qa <= 2 * TIE_QUAL) & (qb <= 2 * TIE_QUAL))
                       | ((sa == sb) & (dq > 2) & (dq <= 2 * TIE_QUAL + 2)))
                if ((sa != sb) & ~tie).any() or (np.where(tie, 0, dq) > 2).any():
                    raise AssertionError(f"race parity: {label} outside the parity bar")
                n_tie += int(tie.sum())
            max_dq = max(max_dq, int(dq.max(initial=0)))
        if runsum:
            ok = (n_base < RUNSUM_BASE_FRAC * n_cyc and n_qual < RUNSUM_QUAL_FRAC * n_cyc
                  and max_dq <= RUNSUM_QUAL_GAP)
        else:
            ok = n_tie * 10_000 <= n_cyc
        if not ok:
            raise AssertionError(f"race parity: {label}: {n_base} bases, {n_qual} quals, "
                                 f"{n_tie} ties of {n_cyc}, largest qual gap {max_dq}")
        parity[label] = {"integers_identical": True, "cycles": n_cyc, "bases_differ": n_base,
                         "quals_differ": n_qual, "tie_cycles": n_tie, "max_qual_diff": max_dq,
                         "tolerance": "jax runsum" if runsum else "parity bar"}
        del got
    again = [run("blockseg", 128) for _ in range(2)]
    for a, b in zip(*again):
        for key in a:
            if a[key].numpy().tobytes() != b[key].numpy().tobytes():
                raise AssertionError(f"blockseg run to run: {key} differs")
    emit("race", n_reads=race["n_reads"], capacity=race["capacity"], reps=race["reps"],
         methods=race["methods"], winner=race["winner"], winner_method=race["winner_method"],
         race_seconds=round(race_s, 3), launches=launches,
         parity_vs_segment_gemm=parity, blockseg_run_to_run_identical=True,
         classes=len(ref), phase_seconds=round(time.monotonic() - t_phase, 3), nvidia_smi=smi)
    return launches


def bench_phase(bench_cache: str, smi: str):
    """The bench through ``benchmark.main(device="cuda")`` (what the
    CLI's ``bench`` runs) with its env knobs cut to fit the smoke's
    time, then the profile tools once each; every result checked.
    Returns the kernels' launches over the phase, the largest launch at
    each (R, C, f_max) the phase gave segment_gemm, and the kernels'
    launches within the four fleet legs (serve_fleet, serve_defense,
    serve_shard, serve_xhost: in-process daemons on the card)."""
    import io

    import torch

    from duplexumiconsensusreads_torch import benchmark
    from duplexumiconsensusreads_torch.kernels import consensus
    from duplexumiconsensusreads_torch.tools import profile_components, profile_phases

    knobs = dict(
        DUT_BENCH_CACHE=bench_cache,
        # the stream phase's input: the bench finds it in its cache
        DUT_BENCH_E2E_READS=str(STREAM_READS),
        # the A/B legs and the CPU denominator at one chunk, one rep
        DUT_BENCH_E2E_AB=str(STREAM_CHUNK_READS),
        DUT_BENCH_CPU_E2E_READS=str(STREAM_CHUNK_READS),
        DUT_BENCH_CPU_E2E_REPS="1",
        # the serve_n_jobs and live_follow legs at the serve phase's
        # small-job size (its input is in the cache), two serve jobs
        DUT_BENCH_SERVE_JOBS="2",
        DUT_BENCH_SERVE_READS=str(SERVE_SMALL_READS[0]),
        DUT_BENCH_LIVE_READS=str(SERVE_SMALL_READS[0]),
        DUT_BENCH_LIVE_SLAB_S="0.1",
        DUT_BENCH_GATE="0",
        DUT_PROF_READS=str(BENCH_PROF_READS),
        # the mesh-scaling A/B at every card (two at least): on one card
        # the bench reports e2e_mesh_error
        DUT_BENCH_MESH=str(max(2, torch.cuda.device_count())),
    )
    fleet_legs = ("run_serve_fleet_bench", "run_serve_defense_bench",
                  "run_serve_shard_bench", "run_serve_xhost_bench")
    fleet_launches = dict.fromkeys(kernel_wrappers(), 0)

    def counted(fn):
        def wrapped(*args, **kwargs):
            before = {n: w.launches for n, w in kernel_wrappers().items()}
            try:
                return fn(*args, **kwargs)
            finally:
                for n, w in kernel_wrappers().items():
                    fleet_launches[n] += w.launches - before[n]
        return wrapped

    torch.cuda.synchronize()
    reset_launches()
    t0 = time.monotonic()
    with environ(**knobs), contextlib.ExitStack() as legs, \
            RungKeeper(consensus, key=lambda big, f_max: (*big.shape[1:], f_max)) as keep:
        for leg in fleet_legs:
            inner = getattr(benchmark, leg)
            setattr(benchmark, leg, counted(inner))
            legs.callback(setattr, benchmark, leg, inner)
        with contextlib.redirect_stdout(io.StringIO()) as buf:
            benchmark.main(device="cuda")
        bench_s = time.monotonic() - t0
        lines = buf.getvalue().splitlines()
        t1 = time.monotonic()
        tools = {}
        for tool in (profile_components, profile_phases):
            with contextlib.redirect_stdout(io.StringIO()) as out:
                if tool.main([]) != 0:
                    raise AssertionError(f"{tool.__name__} failed")
            tools[tool.__name__.rsplit(".", 1)[1]] = json.loads(out.getvalue().splitlines()[-1])
        tools_s = time.monotonic() - t1
    launches = read_launches("bench")
    if len(lines[-1]) >= 1400:
        raise AssertionError(f"the bench's compact line is {len(lines[-1])} bytes")
    compact, full = json.loads(lines[-1]), json.loads(lines[-2])
    mesh_ok = "e2e_mesh_error" if torch.cuda.device_count() < 2 else "e2e_mesh_scaling"
    problems = [k for k in full if k.endswith("_error") and k != mesh_ok]
    if mesh_ok not in full:
        problems.append(f"no {mesh_ok}")
    if compact["value"] <= 0 or full["value"] != compact["value"]:
        problems.append(f"value {compact['value']}")
    if full["peak_entry"] != "h100-sxm-f32" or full["device"] != torch.cuda.get_device_name(0):
        problems.append(f"peak entry {full['peak_entry']} on {full['device']}")
    if sorted(full.get("per_config", {})) != [f"config{i}" for i in range(1, 6)]:
        problems.append(f"per_config rows {sorted(full.get('per_config', {}))}")
    want = ("vs_baseline", "vs_vectorized_cpu", "mfu", "tflops", "e2e_fill_factor",
            "bucket_tuner_fill_factor_off", "tuner_predicted_speedup", "tuner_ladder",
            "e2e_reads_per_sec", "e2e_wall_s", "e2e_wire_floor_frac",
            "e2e_wire_floor_frac_measured", "e2e_bytes_per_read", "e2e_mfu",
            "e2e_packed_speedup", "e2e_d2h_packed_speedup", "e2e_ingest_overlap",
            "cpu_e2e_reads_per_sec", "e2e_vs_cpu_e2e", "serve_amortised_speedup",
            "serve_oneshot_cold_wall_s", "serve_job_walls_s", "serve_compile_hit_rate",
            "live_first_snapshot_latency_s", "live_steady_lag_chunks",
            "live_snapshots_published", "serve_fleet_takeover_latency_s",
            "serve_fleet_recovered", "serve_fleet_class_queue_wait", "fleet_e2e_p95_s",
            "fleet_takeover_gap_s", "serve_quarantine_after_crashes",
            "serve_watchdog_detect_latency_s", "serve_shard_k1_wall_s",
            "serve_shard_k4_wall_s", "serve_shard_speedup", "serve_shard_merge_s",
            "serve_xhost_takeover_latency_s", "serve_xhost_recovered")
    problems += [f"no {k}" for k in want if k not in full]
    if full.get("serve_fleet_stitch_ok") is not True:
        problems.append(f"serve_fleet_stitch_ok {full.get('serve_fleet_stitch_ok')}")
    if not path_launched(fleet_launches):
        problems.append(f"the fleet legs launched {fleet_launches}")
    for probe in ("wire_before_e2e", "wire_after_e2e"):
        p = full.get(probe, {})
        if not (p.get("wire_h2d_mb_s", 0) > 0 and p.get("wire_d2h_mb_s", 0) > 0):
            problems.append(f"{probe} {p}")
    if [k for k in full if k.endswith("_skipped")]:
        problems.append("a *_skipped leg")
    if full.get("e2e_reads", 0) < 0.9 * STREAM_READS or full.get("e2e_consensus", 0) == 0:
        problems.append(f"e2e streamed {full.get('e2e_reads')} reads")
    if not full["consensus_error_rate"] < 1e-3:
        problems.append(f"consensus error rate {full['consensus_error_rate']}")
    for name, res in tools.items():
        if res["device"] != "cuda" or not all(r["step_s"] > 0 for r in res["rows"].values()):
            problems.append(f"{name} {res}")
    if problems:
        raise AssertionError(f"bench: {problems}")
    emit("bench", compact=compact, full=full, profile_components=tools["profile_components"],
         profile_phases=tools["profile_phases"], launches=launches,
         fleet_leg_launches=fleet_launches,
         segment_gemm_shapes=sorted(list(sh) for sh in keep.shapes),
         bench_seconds=round(bench_s, 3), tools_seconds=round(tools_s, 3), knobs=knobs,
         nvidia_smi=smi)
    torch.cuda.synchronize()
    return launches, keep.calls, fleet_launches


if __name__ == "__main__":
    sys.exit(main())
