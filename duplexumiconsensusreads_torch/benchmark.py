"""Benchmark harness of the torch port: reads/s consensus-called on one
CUDA device, against the NumPy oracle and the port's own pipeline on
the host CPU.

    python -m duplexumiconsensusreads_torch bench [--reads N] [--capacity R]
    python -m duplexumiconsensusreads_torch bench --device cpu

The JAX package's benchmark.py on torch, leg for leg where the port has
the modules. The workload is benchmark config 5 (duplex consensus with
adjacency grouping and the per-cycle error model, the hardest fused
path) on a synthetic ctDNA-like batch. Legs, in order:

  compute     the batch's dispatch classes stacked once onto the
              device, ``fused_pipeline`` over every class
              DUT_BENCH_REPS times, one synchronize as the barrier:
              ``value`` (reads/s), ``tflops``/``mfu`` (analytic FLOPs
              against telemetry/device.py's peak, ``peak_entry``), the
              consensus error rate against the simulator's truth (the
              journal line), ``vs_baseline`` (the NumPy oracle on
              DUT_BENCH_CPU_SAMPLE reads) and ``vs_vectorized_cpu``
              (``run_bucket`` on the host CPU with the CPU's default
              ssc method, best of DUT_BENCH_VEC_REPS)
  per_config  configs 1-5 at their plans on the compute leg's mesh
  tuner       the bucket auto-tuner's measured fill (host only)
  e2e         the wire probe (pinned H2D/D2H MB/s), a cached
              simulated BAM streamed through ``stream_call_consensus``
              (ingest, bucketing, device compute, scatter, shard
              write, finalise) with its capture read back by the
              port's analysers, the probe again, then the packed /
              d2h / ingest-overlap A/B legs and the same stream on the
              CPU in a subprocess (the end-to-end denominator)
  serve_n_jobs  N identical jobs through an in-process
              ``ConsensusService`` on the device against the same job
              one-shot in a fresh process with a throwaway kernel build
              directory (interpreter, CUDA context, nvcc and allocator
              growth paid per process): ``serve_*`` keys
  serve_fleet  jobs through DUT_BENCH_SERVE_DAEMONS in-process daemons
              on one spool and the device, one killed mid-job and taken
              over, the spool stitched by telemetry/fleet.py; then the
              defense (poison quarantine, watchdog), shard (K=1 against
              K=4) and cross-host (sharedfs store, skewed epochs) legs:
              ``serve_fleet_*``, ``fleet_*``, ``serve_quarantine_*``,
              ``serve_watchdog_*``, ``serve_shard_*``, ``serve_xhost_*``
  live_follow  the stream following a BAM a paced writer is still
              appending, with a snapshot per committed chunk:
              ``live_*`` keys

The compute and ``per_config`` legs run on the mesh of every visible
card (parallel/mesh.py:run_mesh; one lane on the CPU), each class
padded to the data lanes. ``DUT_BENCH_MESH=K`` sizes the e2e legs'
mesh and, for K > 1, adds the mesh-scaling A/B: the A/B leg's input at
K devices (``e2e_meshk_*``) and at 1 (``e2e_mesh1_*``), with
``e2e_mesh_devices`` and ``e2e_mesh_scaling`` (1-device wall over
K-device wall); with fewer than K devices in the pool it reports
``e2e_mesh_error`` instead (and the other e2e legs run at the
default mesh, where the JAX bench's would raise).

Runs on the card; with no CUDA device it raises unless the caller asks
for ``device="cpu"`` (``--device cpu``), which runs every leg's device
work on the host with the kernels' plain versions.

The grouping fixpoint checks for a change on the host once per sweep
(kernels/grouping.py), so the compute leg's reps are not fully
asynchronous, and an e2e capture's ``xfer`` spans hold device time:
there ``e2e_wire_floor_frac_measured`` reads a dispatch floor, not
the wire's.

Env knobs (the JAX bench's, same defaults): DUT_BENCH_READS (600000),
DUT_BENCH_CAPACITY (2048), DUT_BENCH_CPU_SAMPLE (3000), DUT_BENCH_REPS
(10), DUT_BENCH_VEC_REPS (3), DUT_BENCH_VEC_SAMPLE (30000),
DUT_SSC_METHOD (the compute leg's reduction; the JAX method names are
accepted and mapped), DUT_BENCH_PER_CONFIG (1), DUT_BENCH_CONFIG_READS
(200000), DUT_BENCH_CONFIG_REPS (6), DUT_BENCH_TUNER (1),
DUT_BENCH_TUNER_MOLECULES (20000), DUT_BENCH_DRAIN_WORKERS (2),
DUT_BENCH_PREFETCH_DEPTH (2), DUT_BENCH_E2E_READS (10000000; 0 disables
every e2e leg), DUT_BENCH_E2E_AB (2000000; 0 disables the A/B legs),
DUT_BENCH_AB_BUDGET_S (480), DUT_BENCH_INGEST_AB (1), DUT_BENCH_WIRE_MB
(32), DUT_BENCH_CPU_E2E_READS (1000000), DUT_BENCH_CPU_E2E_REPS (2),
DUT_BENCH_TRACE (1), DUT_BENCH_CACHE (.bench_cache), DUT_BENCH_GATE (1),
DUT_BENCH_GATE_THRESHOLD (0.5), DUT_BENCH_SERVE_JOBS (3; 0 disables the
serve_n_jobs leg and the fleet legs), DUT_BENCH_SERVE_READS (120000),
DUT_BENCH_SERVE_DAEMONS (2; below 2 disables the fleet legs),
DUT_BENCH_LIVE_READS (120000; 0 disables the live_follow leg) and
DUT_BENCH_LIVE_SLAB_S (0.2) and DUT_BENCH_MESH (0: the executor's
default mesh).

Stdout contract: the LAST stdout line is the compact canonical JSON
(COMPACT_KEYS, under 1400 bytes), the full result JSON is the line
above it and mirrored to <cache>/bench_full.json; the human journal
goes to stderr.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

import numpy as np

# ONE shared e2e workload definition: both the device run (run_e2e) and
# the CPU denominator (run_cpu_e2e) stream the identical input with
# identical params, or e2e_vs_cpu_e2e compares different work
E2E_CHUNK_READS = 500_000
E2E_MAX_INFLIGHT = 4

# The final stdout line is a COMPACT canonical summary limited to these
# keys (the JAX bench's): a reader keeping only a ~2000-byte tail of
# the output parses its JSON out of that window, so the full result
# rides the line above (and <cache>/bench_full.json) and the canonical
# metrics — the ones tools/bench_history.py tracks — a last line that
# always fits.
COMPACT_KEYS = (
    "metric", "value", "unit", "vs_baseline", "tflops", "mfu",
    "vs_vectorized_cpu", "ssc_method",
    "e2e_reads_per_sec", "e2e_wall_s",
    "e2e_mfu", "e2e_roofline_frac",
    "e2e_wire_floor_frac", "e2e_wire_floor_frac_measured",
    "e2e_wire_h2d_mb_s_measured", "e2e_wire_d2h_mb_s_measured",
    "e2e_bytes_per_read", "e2e_packed_speedup", "e2e_d2h_packed_speedup",
    "e2e_h2d_bits_per_cycle", "e2e_prefetch_depth", "e2e_ingest_overlap",
    "e2e_fill_factor", "tuner_predicted_speedup", "e2e_vs_cpu_e2e",
    "e2e_mesh_devices", "e2e_mesh_scaling",
    "serve_amortised_speedup", "serve_fleet_takeover_latency_s",
    "serve_quarantine_after_crashes", "serve_watchdog_detect_latency_s",
    "serve_shard_speedup", "serve_shard_merge_s",
    "serve_xhost_takeover_latency_s", "serve_xhost_recovered",
    "fleet_e2e_p95_s", "fleet_takeover_gap_s",
    "live_first_snapshot_latency_s", "live_steady_lag_chunks",
)

def _cache() -> str:
    return os.environ.get("DUT_BENCH_CACHE", ".bench_cache")


def _sync(dev) -> None:
    """Wait for the device's work: a torch.device, or every card of a
    mesh (parallel/mesh.py:DeviceMesh)."""
    import torch

    for d in set(getattr(dev, "devices", [dev])):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def time_step(fn, dev, reps: int) -> float:
    """Mean seconds of one ``fn()``: one untimed call (kernel library
    load, allocator growth), then ``reps`` calls enqueued back to back
    and ONE synchronize as the barrier, as the streaming executor
    overlaps its dispatches (the JAX bench's one-fetch barrier). The
    grouping fixpoint's per-sweep host check still waits inside each
    call."""
    fn()
    _sync(dev)
    t0 = time.monotonic()
    for _ in range(reps):
        fn()
    _sync(dev)
    return (time.monotonic() - t0) / reps


def bench_batch(n_target: int):
    """The compute leg's workload: (grouping, consensus, batch, truth,
    SimConfig) of a simulated ctDNA-like config5 batch of ~n_target
    reads (~9 reads per duplex molecule, 150-cycle reads, panel-like
    tiling of 48 molecules per position, seed 7)."""
    from duplexumiconsensusreads_torch.simulate import SimConfig, simulate_batch
    from duplexumiconsensusreads_torch.types import ConsensusParams, GroupingParams

    gp = GroupingParams(strategy="adjacency", paired=True)
    cp = ConsensusParams(mode="duplex", error_model="cycle", min_duplex_reads=1)
    n_mol = max(64, n_target // 9)
    sim_cfg = SimConfig(
        n_molecules=n_mol,
        read_len=150,
        n_positions=max(8, n_mol // 48),
        mean_family_size=4,
        umi_error=0.01,
        duplex=True,
        seed=7,
    )
    batch, truth = simulate_batch(sim_cfg)
    return gp, cp, batch, truth, sim_cfg


def device_classes(buckets, gp, cp, ssc_method, dev) -> list:
    """[(class buckets, spec, [device tensors in fused_pipeline's
    argument order])]: the dispatch classes exactly as the executors
    make them, each stacked onto ``dev`` once (one device: no mesh-pad
    buckets; the profile tools' form), so a timed loop measures compute, not the H2D of
    its inputs. ``ssc_method`` None: ``dev``'s default."""
    from duplexumiconsensusreads_torch.bucketing import stack_buckets
    from duplexumiconsensusreads_torch.interop import ARRAY_KEYS, stacked_from_numpy
    from duplexumiconsensusreads_torch.runtime.executor import partition_buckets

    classes = []
    for cbuckets, cspec in partition_buckets(buckets, gp, cp, ssc_method, device=dev):
        args = stacked_from_numpy(stack_buckets(cbuckets, multiple_of=1), dev)
        classes.append((cbuckets, cspec, [args[k] for k in ARRAY_KEYS]))
    _sync(dev)
    return classes


def mesh_classes(buckets, gp, cp, ssc_method, mesh, streams) -> list:
    """[(class buckets, spec, per-lane device tensor dicts)]: the
    dispatch classes as the executors make them, each staged to a
    multiple of the mesh's data lanes and put on its lanes once
    (parallel/sharded.py:stage_lanes, put_lanes), so a timed loop of
    ``presharded_pipeline`` measures compute, not the H2D of its
    inputs. ``ssc_method`` None: the lanes' default."""
    from duplexumiconsensusreads_torch.parallel.sharded import put_lanes, stage_lanes
    from duplexumiconsensusreads_torch.runtime.executor import partition_buckets

    classes = []
    for cbuckets, cspec in partition_buckets(buckets, gp, cp, ssc_method,
                                             device=mesh.devices[0]):
        blocks = stage_lanes(cbuckets, mesh, cspec, streams=streams)
        classes.append((cbuckets, cspec, put_lanes(blocks, mesh, cspec, streams=streams)))
    _sync(mesh)
    return classes


def bench_mesh(dev):
    """(mesh, lane streams) of the compute and per_config legs: the
    executors' default mesh (one lane)."""
    from duplexumiconsensusreads_torch.parallel.mesh import run_mesh
    from duplexumiconsensusreads_torch.parallel.sharded import lane_streams

    mesh = run_mesh(dev)
    return mesh, lane_streams(mesh)


def compact_result(result: dict, full_path: str | None = None) -> dict:
    """The last-stdout-line summary: COMPACT_KEYS present in
    ``result``, plus a pointer at the mirrored full JSON."""
    out = {k: result[k] for k in COMPACT_KEYS if k in result}
    if full_path:
        out["full"] = full_path
    return out


def run_bench_gate(result: dict) -> tuple[bool, list[str]]:
    """``tools.bench_history --check`` wired into the bench: this run's
    canonical metrics as the candidate round against the port's
    recorded ``BENCH_torch_rNN.json`` trajectory in the cwd (never the
    JAX package's ``BENCH_rNN.json`` rounds). No trajectory -> vacuously
    OK. DUT_BENCH_GATE=0 skips, DUT_BENCH_GATE_THRESHOLD overrides the
    loose 50% default."""
    from duplexumiconsensusreads_torch import benchhist

    paths = benchhist.default_paths(".")
    if not paths:
        return True, []
    try:
        rounds = [benchhist.load_round(p) for p in paths]
    except (OSError, ValueError) as e:
        return True, [f"gate skipped: unreadable trajectory ({e})"]
    rounds.append({
        "name": "current", "path": "<this run>",
        "metrics": dict(result), "salvaged": False, "rc": None,
    })
    threshold = float(os.environ.get("DUT_BENCH_GATE_THRESHOLD", 0.5))
    return benchhist.check_regression(rounds, threshold=threshold)


def wire_probe(dev, mb: int | None = None) -> dict:
    """The raw host<->device wire, both directions, with a ~mb-MiB u8
    payload copied as the executors copy: H2D from pinned host memory
    (interop.stacked_from_numpy), D2H into a pinned host buffer
    (runtime/executor.start_fetch), both non-blocking. Each direction
    is timed by CUDA events around its copy, after one untimed warm copy
    each way. Reports decimal MB/s: the e2e byte counters report
    bytes/1e6, and the floor arithmetic divides one by the other."""
    import torch

    if mb is None:
        mb = int(os.environ.get("DUT_BENCH_WIRE_MB", 32))
    gen = torch.Generator().manual_seed(0)
    payload = torch.randint(0, 256, (mb << 20,), dtype=torch.uint8, generator=gen).pin_memory()
    back = torch.empty(payload.shape, dtype=payload.dtype, pin_memory=True)

    def timed(fn) -> tuple:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end) / 1e3

    with torch.cuda.device(dev):
        warm = payload.to(dev, non_blocking=True)
        back.copy_(warm, non_blocking=True)
        torch.cuda.synchronize(dev)
        del warm
        x, h2d_s = timed(lambda: payload.to(dev, non_blocking=True))
        _, d2h_s = timed(lambda: back.copy_(x, non_blocking=True))
    if not torch.equal(back[-16:], payload[-16:]):
        raise RuntimeError("wire probe: the payload did not survive the round trip")
    del x
    dec_mb = (mb << 20) / 1e6
    return {
        "wire_mb": mb,
        "wire_h2d_mb_s": round(dec_mb / max(h2d_s, 1e-9), 1),
        "wire_d2h_mb_s": round(dec_mb / max(d2h_s, 1e-9), 1),
    }


def _e2e_params():
    from duplexumiconsensusreads_torch.types import ConsensusParams, GroupingParams

    gp = GroupingParams(strategy="adjacency", paired=True)
    cp = ConsensusParams(mode="duplex", error_model="cycle", min_duplex_reads=1)
    return gp, cp


def _e2e_input(n_target: int, cache: str | None = None) -> tuple[str, float]:
    """Simulate-or-reuse the cached coordinate-sorted input BAM for an
    ~n_target-read e2e run in ``cache`` (default: the bench's cache
    dir). Returns (path, sim_seconds). The cache key covers the FULL
    workload definition (the JAX bench's key), so editing the config can
    never silently reuse a stale input BAM."""
    import hashlib

    from duplexumiconsensusreads_torch.simulate import SimConfig
    from duplexumiconsensusreads_torch.simulate.bigsim import simulate_bam_file

    cache = cache or _cache()
    os.makedirs(cache, exist_ok=True)
    n_mol = n_target // 8  # ~8 reads/molecule with the config below
    cfg = SimConfig(
        read_len=150,
        n_positions=1000,
        mean_family_size=4,
        umi_error=0.01,
        duplex=True,
    )
    tag = hashlib.sha256(
        json.dumps([dataclasses.asdict(cfg), n_mol, 7], sort_keys=True).encode()
    ).hexdigest()[:10]
    in_path = os.path.join(cache, f"e2e_{tag}.bam")
    sim_s = 0.0
    if not os.path.exists(in_path):
        res = simulate_bam_file(
            in_path + ".tmp", n_mol, cfg=cfg, chunk_molecules=25_000, seed=7
        )
        os.replace(in_path + ".tmp", in_path)
        sim_s = res["seconds"]
    return in_path, sim_s


def run_e2e(
    n_target: int, dev, packed: str = "auto", prefix: str = "e2e",
    d2h_packed: str = "auto", ingest_overlap: str = "auto",
    n_devices: int | None = None,
) -> dict:
    """Stream a cached large simulated BAM through the full pipeline on
    ``dev``; return wall-clock metrics including ingest and write.
    packed="off" disables the H2D wire packing and d2h_packed="off" the
    packed consensus-only return path — the same-run A/B legs.

    Every leg records a span capture (DUT_BENCH_TRACE=0 disables) and
    the JSON carries the per-chunk latency percentiles, the byte
    ledger's wire model and the device ledger's MFU from it, through
    the port's telemetry analysers. The capture stays in the cache dir
    (``python -m duplexumiconsensusreads_torch.tools.trace_report
    <cache>/e2e_trace.jsonl``)."""
    from duplexumiconsensusreads_torch.runtime.executor import default_ssc_method
    from duplexumiconsensusreads_torch.runtime.stream import stream_call_consensus

    cache = _cache()
    in_path, sim_s = _e2e_input(n_target)
    out_path = os.path.join(cache, "e2e_out.bam")
    trace_path = None
    if int(os.environ.get("DUT_BENCH_TRACE", 1)):
        trace_path = os.path.join(cache, f"{prefix}_trace.jsonl")
    gp, cp = _e2e_params()
    prefetch_depth = int(os.environ.get("DUT_BENCH_PREFETCH_DEPTH", 2))
    # mesh size for this leg: the explicit kwarg (the scaling A/B), or
    # DUT_BENCH_MESH when the pool holds that many devices (0/unset, or
    # more than the pool = the executor default, one lane: the scaling
    # A/B then reports e2e_mesh_error instead of the run dying)
    if n_devices is None:
        from duplexumiconsensusreads_torch.parallel.mesh import device_pool

        n_env = int(os.environ.get("DUT_BENCH_MESH", 0))
        n_devices = n_env if 0 < n_env <= len(device_pool(dev)) else None
    t0 = time.monotonic()
    rep = stream_call_consensus(
        in_path,
        out_path,
        gp,
        cp,
        n_devices=n_devices,
        capacity=int(os.environ.get("DUT_BENCH_CAPACITY", 2048)),
        chunk_reads=E2E_CHUNK_READS,
        max_inflight=E2E_MAX_INFLIGHT,
        drain_workers=int(os.environ.get("DUT_BENCH_DRAIN_WORKERS", 2)),
        packed=packed,
        d2h_packed=d2h_packed,
        prefetch_depth=prefetch_depth,
        ingest_overlap=ingest_overlap,
        trace_path=trace_path,
        device=dev,
    )
    wall = time.monotonic() - t0
    try:
        os.remove(out_path)
    except OSError:
        pass

    extra = {}
    if trace_path:
        from duplexumiconsensusreads_torch.telemetry import devledger
        from duplexumiconsensusreads_torch.telemetry import ledger as trace_ledger
        from duplexumiconsensusreads_torch.telemetry import report as trace_report

        try:
            records = trace_report.load_trace(trace_path)
            pct = trace_report.chunk_latency_percentiles(records)
            extra = {
                f"{prefix}_chunk_p50_s": pct["p50_s"],
                f"{prefix}_chunk_p95_s": pct["p95_s"],
                f"{prefix}_chunk_max_s": pct["max_s"],
                f"{prefix}_chunk_dominant": pct["dominant_stages"],
                f"{prefix}_trace": trace_path,
            }
            # the byte ledger's wire model from the run's own transfer
            # spans; an xfer h2d span holds the whole dispatch, which
            # waits on the grouping fixpoint's per-sweep host check, so
            # on this engine the "floor" is a dispatch floor
            fl = trace_ledger.wire_floor(records)
            bw = trace_ledger.bandwidth_stats(records)
            extra[f"{prefix}_wire_floor_frac_measured"] = fl["frac"]
            if "h2d" in bw:
                extra[f"{prefix}_wire_h2d_mb_s_measured"] = bw["h2d"]["effective_mb_s"]
            if "d2h" in bw:
                extra[f"{prefix}_wire_d2h_mb_s_measured"] = bw["d2h"]["effective_mb_s"]
            # the H2D rung the run used, modal across the dispatches'
            # bits per cycle: 16 = unpacked, 8 = byte, 7/5 = sub-byte
            bpcs = [
                r["bpc"] for r in trace_ledger.xfer_records(records)
                if r.get("dir") == "h2d" and "bpc" in r
            ]
            if bpcs:
                extra[f"{prefix}_h2d_bits_per_cycle"] = max(set(bpcs), key=bpcs.count)
            pk = trace_ledger.packing_stats(records)
            if "d2h_packing_ratio" in pk:
                extra[f"{prefix}_d2h_packing_ratio"] = pk["d2h_packing_ratio"]
            # the device ledger: MFU and roofline position from the
            # capture's own dev records
            dtot = devledger.device_totals(records)
            if dtot:
                extra[f"{prefix}_mfu"] = dtot["mfu"]
                extra[f"{prefix}_device_gflops"] = round(dtot["flops"] / 1e9, 3)
                roofl = devledger.roofline(records)
                if roofl:
                    extra[f"{prefix}_roofline_frac"] = roofl["attainable_frac"]
            comp = devledger.compile_stats(records)
            if comp:
                extra[f"{prefix}_compile_s"] = comp["compile_s"]
        except (OSError, ValueError) as e:
            # telemetry must never sink the bench capture itself
            extra = {f"{prefix}_trace_error": str(e)[:200]}
    if prefix == "e2e":
        from duplexumiconsensusreads_torch.runtime.executor import busy_wall_table

        lines, bugs = busy_wall_table(
            rep.seconds, drain_workers=max(rep.n_drain_workers, 1)
        )
        print("# e2e busy-vs-wall (per-stage busy seconds, overlapped):", file=sys.stderr)
        for ln in lines:
            print(f"#   {ln}", file=sys.stderr)
        if bugs:
            print(f"#   ACCOUNTING BUG in stages: {', '.join(bugs)}", file=sys.stderr)
        sys.stderr.flush()

    return {
        **extra,
        f"{prefix}_reads": rep.n_records,
        f"{prefix}_wall_s": round(wall, 2),
        f"{prefix}_reads_per_sec": round(rep.n_records / wall, 1),
        f"{prefix}_consensus": rep.n_consensus,
        f"{prefix}_sim_s": round(sim_s, 1),
        f"{prefix}_input_mb": round(os.path.getsize(in_path) / 1e6, 1),
        # the streaming executor dispatches its device's default method;
        # DUT_SSC_METHOD steers the compute leg only
        f"{prefix}_ssc_method": default_ssc_method(rep.device),
        f"{prefix}_device": rep.device,
        # measured wire payload of this run (device inputs dispatched /
        # outputs fetched): divides against the wire probe's MB/s for
        # the arithmetic wall floor
        f"{prefix}_h2d_mb": round(rep.bytes_h2d / 1e6, 1),
        f"{prefix}_d2h_mb": round(rep.bytes_d2h / 1e6, 1),
        f"{prefix}_bytes_per_read": round(
            (rep.bytes_h2d + rep.bytes_d2h) / max(rep.n_records, 1), 1
        ),
        # per-stage BUSY seconds: stages overlap, so main_loop_stall /
        # drain_utilization are the wall-side views
        f"{prefix}_phases": {k: v for k, v in rep.seconds.items() if k != "total"},
        f"{prefix}_drain_workers": rep.n_drain_workers,
        f"{prefix}_prefetch_depth": prefetch_depth,
        f"{prefix}_mesh_devices": rep.n_devices,
        f"{prefix}_mesh_pad_buckets": rep.n_mesh_pad_buckets,
    }


# configs 1-5 (BASELINE.json) at the JAX bench's sim geometry, grouping,
# consensus and capacity each: amplicon / panel / ctDNA / exome-sharded /
# low-VAF. Config 4's axis on one device is its jumbo capacity.
def _config_plans() -> dict:
    from duplexumiconsensusreads_torch.types import ConsensusParams, GroupingParams

    adj = dict(strategy="adjacency")
    return {
        "config1": (
            dict(read_len=150, n_positions=24, mean_family_size=6,
                 duplex=False, seed=11),
            GroupingParams(strategy="exact"),
            ConsensusParams(mode="single_strand"),
            2048,
        ),
        "config2": (
            dict(read_len=150, n_positions=400, mean_family_size=5,
                 umi_error=0.02, duplex=False, seed=12),
            GroupingParams(**adj),
            ConsensusParams(mode="single_strand"),
            2048,
        ),
        "config3": (
            dict(read_len=150, n_positions=450, mean_family_size=4,
                 umi_error=0.01, duplex=True, seed=13),
            GroupingParams(paired=True, **adj),
            ConsensusParams(mode="duplex"),
            2048,
        ),
        "config4": (
            dict(read_len=150, n_positions=1600, mean_family_size=3,
                 umi_error=0.01, duplex=True, seed=14),
            GroupingParams(paired=True, **adj),
            ConsensusParams(mode="duplex"),
            4096,
        ),
        "config5": (
            dict(read_len=150, n_positions=450, mean_family_size=4,
                 umi_error=0.01, cycle_error_slope=0.002, duplex=True,
                 seed=15),
            GroupingParams(paired=True, **adj),
            ConsensusParams(mode="duplex", error_model="cycle"),
            2048,
        ),
    }


def run_per_config(dev) -> dict:
    """Device-compute reads/s for EACH named config on its sim geometry,
    so a regression in any single path (e.g. the exact-match fast path)
    shows, not hidden inside the composite headline. The compute leg's
    method (``time_step``), best of two timing rounds: one round right
    after a burst of host work can absorb one-off stalls that a second
    never shows."""
    import torch

    from duplexumiconsensusreads_torch.bucketing import build_buckets
    from duplexumiconsensusreads_torch.parallel.sharded import presharded_pipeline
    from duplexumiconsensusreads_torch.simulate import SimConfig, simulate_batch

    n_target = int(os.environ.get("DUT_BENCH_CONFIG_READS", 200_000))
    reps = int(os.environ.get("DUT_BENCH_CONFIG_REPS", 6))
    mesh, streams = bench_mesh(dev)
    out = {}
    for name, (sim_kw, gp, cp, capacity) in _config_plans().items():
        per_mol = sim_kw["mean_family_size"] * (2 if sim_kw["duplex"] else 1)
        batch, _ = simulate_batch(
            SimConfig(n_molecules=max(64, n_target // per_mol), **sim_kw)
        )
        n_reads = int(np.asarray(batch.valid).sum())
        buckets = build_buckets(batch, capacity=capacity, grouping=gp)
        classes = mesh_classes(buckets, gp, cp, None, mesh, streams)

        def run_all():
            return [presharded_pipeline(args, cspec, mesh, streams=streams)
                    for _, cspec, args in classes]

        with torch.no_grad():
            dt = min(time_step(run_all, mesh, reps) for _ in range(2))
        del classes
        out[name] = {
            "reads_per_sec": round(n_reads / dt, 1),
            "n_reads": n_reads,
            "capacity": capacity,
            "step_s": round(dt, 4),
        }
    return out


def run_bucket_tuner_bench() -> dict:
    """The ``bucket_tuner`` leg: MEASURED fill factors of the bucket
    auto-tuner on the canonical long-tail fixture, host only (fill is a
    pure function of the group-size mix and the packer).

    The fixture long-tails a simulated batch by merging its uniform
    position groups in runs cycling 1..8 long: many shallow tiles plus
    a hot tail, where one global capacity pays tail padding on every
    flush. Exact grouping: merging positions can collide UMIs across
    molecules, which matters only to adjacency semantics; this leg
    measures PACKING. Emits:

      e2e_fill_factor              measured fill (real rows / padded
                                   row-slots) under the auto verdict
      bucket_tuner_fill_factor_off the single-capacity baseline fill
      tuner_predicted_speedup      the verdict's cost-model ratio
      tuner_ladder                 the chosen rungs
    """
    from duplexumiconsensusreads_torch.bucketing import build_buckets
    from duplexumiconsensusreads_torch.simulate import SimConfig, simulate_batch
    from duplexumiconsensusreads_torch.tuning import choose_ladder, group_sizes
    from duplexumiconsensusreads_torch.types import GroupingParams

    capacity = int(os.environ.get("DUT_BENCH_CAPACITY", 2048))
    n_mol = int(os.environ.get("DUT_BENCH_TUNER_MOLECULES", 20_000))
    cfg = SimConfig(
        n_molecules=n_mol, read_len=150, n_positions=600,
        mean_family_size=3, umi_error=0.01, duplex=True, seed=17,
    )
    batch, _ = simulate_batch(cfg)
    pos = np.asarray(batch.pos_key)
    uniq, inv = np.unique(pos, return_inverse=True)
    merged = np.zeros(len(uniq), np.int64)
    m = j = 0
    while j < len(uniq):
        run = 1 + (m % 8)
        merged[j : j + run] = m
        j += run
        m += 1
    batch.pos_key[:] = merged[inv]
    gp = GroupingParams(strategy="exact")

    verdict = choose_ladder(group_sizes(batch), capacity, pack_mult=1)

    def measured_fill(ladder):
        bks = build_buckets(batch, capacity=capacity, grouping=gp, ladder=ladder)
        real = sum(int(b.valid.sum()) for b in bks)
        pad = sum(b.capacity for b in bks)
        return round(real / max(pad, 1), 4)

    fill_off = measured_fill(None)
    fill_auto = measured_fill(verdict.ladder) if len(verdict.ladder) > 1 else fill_off
    return {
        "e2e_fill_factor": fill_auto,
        "bucket_tuner_fill_factor_off": fill_off,
        "tuner_predicted_speedup": verdict.predicted_speedup,
        "tuner_ladder": list(verdict.ladder),
        "bucket_tuner_reads": int(np.asarray(batch.valid).sum()),
    }


def run_serve_bench(n_jobs: int, dev) -> dict:
    """The ``serve_n_jobs`` leg (the JAX bench's keys): N identical jobs
    through an in-process daemon on ``dev`` against the same job
    one-shot in a fresh process.

    The one-shot subprocess gets a throwaway kernel build directory
    (utils/compile_cache.py), so it pays what every ``call`` process
    pays without the service: interpreter and torch start-up, the CUDA
    context, nvcc for both kernels and the allocator's growth. The
    daemon runs on this warm process with the build directory in
    force, so per-job wall against one-shot wall is what keeping the
    card warm buys. Per-job walls come from the service capture's
    job_completed events (completion order)."""
    import shutil
    import subprocess
    import tempfile

    from duplexumiconsensusreads_torch.kernels.build import BUILD_DIR
    from duplexumiconsensusreads_torch.serve import ConsensusService, client
    from duplexumiconsensusreads_torch.telemetry import report as trace_report
    from duplexumiconsensusreads_torch.utils.compile_cache import ENV_VAR, build_dir

    cache = _cache()
    n_reads = int(os.environ.get("DUT_BENCH_SERVE_READS", 120_000))
    in_path, _ = _e2e_input(n_reads)
    config = dict(
        grouping="adjacency", mode="duplex", error_model="cycle",
        capacity=int(os.environ.get("DUT_BENCH_CAPACITY", 2048)),
        chunk_reads=max(n_reads // 4, 10_000),
    )
    out_cold = os.path.join(cache, "serve_cold.bam")
    spec_json = json.dumps({
        "job_id": "job-bench-cold", "input": os.path.abspath(in_path),
        "output": os.path.abspath(out_cold), "config": config,
    })
    child = f"""
import json, time
from duplexumiconsensusreads_torch.runtime.stream import stream_call_consensus
from duplexumiconsensusreads_torch.serve.job import job_params, serve_provenance, validate_spec
spec = validate_spec(json.loads({spec_json!r}))
gp, cp, kw = job_params(spec)
kw.pop("mesh")
t0 = time.monotonic()
rep = stream_call_consensus(spec.input, spec.output, gp, cp,
                            provenance_cl=serve_provenance(spec.config),
                            device={str(dev)!r}, **kw)
print(json.dumps({{"wall": time.monotonic() - t0, "reads": rep.n_records}}))
"""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cold_build = tempfile.mkdtemp(prefix="serve_cold_build")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (root, env.get("PYTHONPATH")) if p)
    env[ENV_VAR] = cold_build  # the cold leg must really be cold
    out: dict = {"serve_n_jobs": n_jobs, "serve_reads_per_job": n_reads}
    proc = subprocess.run([sys.executable, "-c", child], capture_output=True, text=True,
                          env=env)
    shutil.rmtree(cold_build, ignore_errors=True)
    try:
        os.remove(out_cold)
    except OSError:
        pass
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-2000:])
        return {**out, "serve_error": f"cold one-shot exit {proc.returncode}"}
    cold = json.loads(proc.stdout.strip().splitlines()[-1])
    out["serve_oneshot_cold_wall_s"] = round(cold["wall"], 2)

    spool = os.path.join(cache, "serve_spool")
    shutil.rmtree(spool, ignore_errors=True)
    trace_path = os.path.join(cache, "serve_trace.jsonl")
    outs = [os.path.join(cache, f"serve_out{i}.bam") for i in range(n_jobs)]
    for o in outs:
        client.submit(spool, in_path, o, config=config)
    t0 = time.monotonic()
    # the daemon builds into (and loads from) this process's build dir
    snap = ConsensusService(spool, chunk_budget=0, trace_path=trace_path, device=dev,
                            build_dir=build_dir(BUILD_DIR)).run_until_idle()
    serve_wall = time.monotonic() - t0
    for o in outs:
        try:
            os.remove(o)
        except OSError:
            pass
    if snap["jobs_done"] != n_jobs:
        return {**out, "serve_error": f"daemon finished {snap['jobs_done']}/{n_jobs} jobs"}
    walls = [
        float(r["wall_s"]) for r in trace_report.load_trace(trace_path)
        if r.get("type") == "event" and r.get("name") == "job_completed"
    ]
    out.update({
        "serve_wall_s": round(serve_wall, 2),
        "serve_job_walls_s": [round(w, 2) for w in walls],
        "serve_compile_hit_rate": snap["compile_hit_rate"],
        "serve_amortised_speedup": round(
            cold["wall"] / max(min(walls), 1e-9), 2) if walls else 0.0,
        "serve_trace": trace_path,
    })
    return out


def _serve_workload(chunk_div: int) -> tuple[str, str, dict]:
    """(cache dir, input BAM, job config) of the serve sub-legs: the e2e
    workload cut to DUT_BENCH_SERVE_READS reads, in chunks of a
    ``chunk_div``-th of it (at least 10k reads), as the JAX legs run it."""
    n_reads = int(os.environ.get("DUT_BENCH_SERVE_READS", 120_000))
    in_path, _ = _e2e_input(n_reads)
    config = dict(
        grouping="adjacency", mode="duplex", error_model="cycle",
        capacity=int(os.environ.get("DUT_BENCH_CAPACITY", 2048)),
        chunk_reads=max(n_reads // chunk_div, 10_000),
    )
    return _cache(), in_path, config


def _remove(paths) -> None:
    for p in paths:
        try:
            os.remove(p)
        except OSError:
            pass


def _swallow(fn):
    try:
        fn()
    except BaseException:  # noqa: BLE001 — bench harness, never fatal
        pass


def _kill_after_one_chunk(svc, why: str) -> None:
    """Make ``svc``'s next slice commit one fresh chunk and then die with
    its lease held: the budget check consults should_yield, which raises
    ``faults.InjectedKill`` exactly as a SIGKILL mid-slice would."""
    from duplexumiconsensusreads_torch.runtime import faults

    orig_run_slice = svc.worker.run_slice

    def dying_run_slice(spec, budget, should_yield, drain_event, lease=None):
        def die():
            raise faults.InjectedKill(why)

        return orig_run_slice(spec, 1, die, drain_event, lease=lease)

    svc.worker.run_slice = dying_run_slice


def _run_until_dead(svc) -> float:
    """Run ``svc`` in a thread until its injected death; the monotonic
    time of death, or 0.0 if it never died."""
    import threading

    t_dead = [0.0]

    def run():
        try:
            svc.run_until_idle()
        except BaseException:  # noqa: BLE001 — the injected death
            t_dead[0] = time.monotonic()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout=600)
    return 0.0 if t.is_alive() else t_dead[0]


def _takeover_latency(spool: str, jid: str, victim_id: str, t_dead: float) -> float | None:
    """Seconds from the victim's death until ``jid`` runs under another
    daemon's lease (or is done); None after 300 s."""
    from duplexumiconsensusreads_torch.serve.queue import SpoolQueue

    q = SpoolQueue(spool)
    deadline = time.monotonic() + 300
    while time.monotonic() < deadline:
        q.refresh()
        e = q.jobs.get(jid, {})
        if e.get("state") == "done" or (
            e.get("state") == "running"
            and (e.get("lease") or {}).get("owner") != victim_id
        ):
            return time.monotonic() - t_dead
        time.sleep(0.005)
    return None


def _running_jobs(spool: str) -> list[str]:
    from duplexumiconsensusreads_torch.serve.queue import SpoolQueue

    q = SpoolQueue(spool)
    q.refresh()
    return [jid for jid, e in q.jobs.items() if e.get("state") == "running"]


def _n_done(spool: str) -> int:
    from duplexumiconsensusreads_torch.serve.queue import SpoolQueue

    q = SpoolQueue(spool)
    q.refresh()
    return sum(1 for e in q.jobs.values() if e.get("state") == "done")


def run_serve_fleet_bench(n_daemons: int, dev) -> dict:
    """The ``serve_fleet`` leg (the JAX bench's keys): jobs submitted
    through ``n_daemons`` in-process daemons on ``dev`` sharing ONE
    spool; daemon 0 dies mid-job (``faults.InjectedKill`` from its own
    slice, the modelled SIGKILL) and the survivors take its lease over.

      serve_fleet_takeover_latency_s  the victim's death to its job
                                      running again elsewhere
      serve_fleet_class_queue_wait    per-priority-class queue-wait
                                      p50/p95 from metrics.json
      serve_fleet_stitch_ok, fleet_e2e_p95_s, fleet_takeover_gap_s
                                      the spool's captures and journal
                                      stitched by telemetry/fleet.py, as
                                      tools/fleet_report prints them

    All daemons share the one card in this process."""
    import shutil
    import threading

    from duplexumiconsensusreads_torch.serve import ConsensusService, client

    cache, in_path, config = _serve_workload(4)
    spool = os.path.join(cache, "serve_fleet_spool")
    shutil.rmtree(spool, ignore_errors=True)
    n_jobs = max(3, n_daemons + 1)
    outs = [os.path.join(cache, f"serve_fleet_out{i}.bam") for i in range(n_jobs)]
    for i, o in enumerate(outs):
        # one urgent job in the mix so the per-class latency table has
        # two rows; the rest ride the default class
        client.submit(spool, in_path, o, config=config,
                      priority=(0 if i == n_jobs - 1 else 1))
    out: dict = {"serve_fleet_daemons": n_daemons, "serve_fleet_jobs": n_jobs}

    victim = ConsensusService(
        spool, chunk_budget=0, poll_s=0.02, lease_s=5.0, daemon_id="fleet-victim",
        trace_path=os.path.join(spool, "service.fleet-victim.trace.jsonl"), device=dev,
    )
    _kill_after_one_chunk(victim, "serve_fleet: victim daemon killed")
    t_dead = _run_until_dead(victim)
    if not t_dead:
        return {**out, "serve_fleet_error": "victim did not die on schedule"}
    victim_jobs = _running_jobs(spool)
    if not victim_jobs:
        return {**out, "serve_fleet_error": "victim died holding no lease"}

    t0 = time.monotonic()
    survivors = [
        ConsensusService(
            spool, chunk_budget=0, poll_s=0.02, lease_s=5.0,
            daemon_id=f"fleet-survivor-{i}",
            trace_path=os.path.join(spool, f"service.fleet-survivor-{i}.trace.jsonl"),
            device=dev,
        )
        for i in range(1, n_daemons)
    ]
    sthreads = [threading.Thread(target=s.run_until_idle, daemon=True) for s in survivors]
    for t in sthreads:
        t.start()
    takeover = _takeover_latency(spool, victim_jobs[0], "fleet-victim", t_dead)
    for t in sthreads:
        t.join(timeout=600)
    fleet_wall = time.monotonic() - t0
    n_done = _n_done(spool)
    _remove(outs)
    if n_done != n_jobs:
        return {**out, "serve_fleet_error": f"fleet finished {n_done}/{n_jobs} jobs"}
    out.update({
        "serve_fleet_wall_s": round(fleet_wall, 2),
        "serve_fleet_takeover_latency_s": (
            round(takeover, 3) if takeover is not None else None
        ),
        "serve_fleet_recovered": sum(s.counters["jobs_recovered"] for s in survivors),
    })
    try:
        with open(os.path.join(spool, "metrics.json")) as f:
            metrics = json.load(f)
        out["serve_fleet_class_queue_wait"] = {
            pri: {
                "p50_s": row.get("queue_wait_p50_s"),
                "p95_s": row.get("queue_wait_p95_s"),
                "n": row.get("n_queue_wait"),
            }
            for pri, row in metrics.get("class_latency", {}).items()
        }
    except (OSError, ValueError):
        pass  # the metrics snapshot is best-effort observability
    # the leg reads its own observability layer: a failed stitch is
    # worth seeing in the trajectory (the keys go absent)
    try:
        from duplexumiconsensusreads_torch.telemetry import fleet

        caps = fleet.load_captures(fleet.discover_service_captures(spool))
        stitched = fleet.stitch(
            caps, journal=fleet.load_journal(os.path.join(spool, "queue.json"))
        )
        fm = fleet.fleet_metrics(stitched, metrics_docs=fleet.load_metrics_docs(spool))
        out["serve_fleet_stitch_ok"] = stitched["ok"]
        if stitched["ok"]:
            if isinstance(fm.get("e2e_p95_s"), (int, float)):
                out["fleet_e2e_p95_s"] = round(fm["e2e_p95_s"], 3)
            if isinstance(fm.get("takeover_gap_max_s"), (int, float)):
                out["fleet_takeover_gap_s"] = round(fm["takeover_gap_max_s"], 3)
        else:
            out["serve_fleet_stitch_problems"] = stitched["problems"][:5]
    except Exception as e:  # noqa: BLE001 — the bench must still report
        out["serve_fleet_stitch_error"] = repr(e)[:200]
    return out


def run_serve_xhost_bench(dev) -> dict:
    """The ``serve_xhost`` sub-leg (the JAX bench's keys): the
    serve_fleet takeover re-run across two synthetic hosts on one
    sharedfs-store spool (distinct host ids, epoch skews of +-3600 s the
    store's clock calibration must cancel), host A killed mid-slice.
    Detection is translated lease expiry, never a pid probe, so the
    latency is lease-dominated by design (informational, non-gating).

      serve_xhost_takeover_latency_s  the victim's death to its job
                                      running (or done) under host B
      serve_xhost_recovered           takeovers host B journaled"""
    import shutil
    import threading

    from duplexumiconsensusreads_torch.serve import ConsensusService, client
    from duplexumiconsensusreads_torch.serve.store import resolve_store

    cache, in_path, config = _serve_workload(4)
    spool = os.path.join(cache, "serve_xhost_spool")
    shutil.rmtree(spool, ignore_errors=True)
    lease_s = 2.0
    store_a = resolve_store(spool, "sharedfs", pin=True, host_id="bench-host-A",
                            epoch_skew=3600.0)
    outs = [os.path.join(cache, f"serve_xhost_out{i}.bam") for i in range(2)]
    for o in outs:
        client.submit(spool, in_path, o, config=config)
    out: dict = {"serve_xhost_hosts": 2, "serve_xhost_lease_s": lease_s}

    victim = ConsensusService(
        spool, chunk_budget=0, poll_s=0.02, lease_s=lease_s, daemon_id="xhost-victim",
        store=store_a, trace_path=os.path.join(spool, "service.xhost-victim.trace.jsonl"),
        device=dev,
    )
    _kill_after_one_chunk(victim, "serve_xhost: host A killed")
    t_dead = _run_until_dead(victim)
    if not t_dead:
        return {**out, "serve_xhost_error": "victim did not die on schedule"}
    running = _running_jobs(spool)
    if not running:
        return {**out, "serve_xhost_error": "victim died holding no lease"}

    store_b = resolve_store(spool, "sharedfs", host_id="bench-host-B", epoch_skew=-3600.0)
    survivor = ConsensusService(
        spool, chunk_budget=0, poll_s=0.02, lease_s=lease_s, daemon_id="xhost-b",
        store=store_b, trace_path=os.path.join(spool, "service.xhost-b.trace.jsonl"),
        device=dev,
    )
    st = threading.Thread(target=survivor.run_until_idle, daemon=True)
    st.start()
    takeover = _takeover_latency(spool, running[0], "xhost-victim", t_dead)
    st.join(timeout=600)
    n_done = _n_done(spool)
    _remove(outs)
    if n_done != len(outs):
        return {**out, "serve_xhost_error": f"fleet finished {n_done}/{len(outs)} jobs"}
    out.update({
        "serve_xhost_takeover_latency_s": (
            round(takeover, 3) if takeover is not None else None
        ),
        "serve_xhost_recovered": survivor.counters["jobs_recovered"],
    })
    return out


def run_serve_defense_bench(dev) -> dict:
    """The defensive-serving sub-leg (the JAX bench's keys), on the same
    workload and ``dev`` (informational, non-gating):

      serve_quarantine_after_crashes  unclean aborts a deterministic
                                      poison job (an injected kill at its
                                      first shard write) survives before
                                      the fleet quarantines it: the
                                      max_crashes bound, no re-run past it
      serve_watchdog_detect_latency_s a slice wedging (lease alive,
                                      durable progress stopped) to the
                                      watchdog's abort-requeue landing in
                                      the journal"""
    import shutil
    import threading

    from duplexumiconsensusreads_torch.runtime import faults
    from duplexumiconsensusreads_torch.serve import ConsensusService, client
    from duplexumiconsensusreads_torch.serve.queue import SpoolQueue

    cache, in_path, config = _serve_workload(4)
    out: dict = {}

    # poison quarantine: crash-loop daemons until the fleet gives up on
    # the job; the count of daemon deaths is the metric
    spool = os.path.join(cache, "serve_defense_spool")
    shutil.rmtree(spool, ignore_errors=True)
    poison_out = os.path.join(cache, "serve_defense_poison.bam")
    jid = client.submit(spool, in_path, poison_out, config=config,
                        chaos="shard.write:1:kill")
    deaths = 0
    for i in range(8):
        svc = ConsensusService(spool, chunk_budget=0, poll_s=0.02,
                               daemon_id=f"defense-{i}", device=dev)
        try:
            svc.run_until_idle()
            break
        except faults.InjectedKill:
            deaths += 1
    q = SpoolQueue(spool)
    q.refresh()
    if q.jobs.get(jid, {}).get("state") != "quarantined":
        out["serve_defense_error"] = (
            f"poison job not quarantined after {deaths} daemon deaths"
        )
    else:
        out["serve_quarantine_after_crashes"] = deaths

    # watchdog detect latency: wedge a slice and time the journal's
    # running -> queued transition
    spool2 = os.path.join(cache, "serve_defense_wd_spool")
    shutil.rmtree(spool2, ignore_errors=True)
    wd_out = os.path.join(cache, "serve_defense_wd.bam")
    jid2 = client.submit(spool2, in_path, wd_out, config=config)
    # the watchdog is armed at the wedge, not at the start: a first chunk
    # slower than the threshold (slice start-up on a loaded host) would
    # otherwise be reclaimed before it commits, every slice, until the
    # job is quarantined and the wedge is never reached
    svc = ConsensusService(spool2, chunk_budget=1, poll_s=0.02, lease_s=3600.0,
                           watchdog_s=0, daemon_id="defense-wd", device=dev)
    wedged = [0.0]
    release = threading.Event()
    orig = svc.worker.run_slice

    def wedging_run_slice(spec, budget, should_yield, drain_event, lease=None):
        def wedge(*_a):
            if not wedged[0]:
                wedged[0] = time.monotonic()
                svc.watchdog_s = 0.5
            release.wait(timeout=120)
            return False

        return orig(spec, 1, wedge, drain_event, lease=lease)

    svc.worker.run_slice = wedging_run_slice
    th = threading.Thread(target=lambda: _swallow(svc.run_until_idle), daemon=True)
    th.start()
    detect = None
    deadline = time.monotonic() + 240
    q2 = SpoolQueue(spool2)
    while time.monotonic() < deadline:
        if wedged[0]:
            q2.refresh()
            if q2.jobs.get(jid2, {}).get("state") == "queued":
                detect = time.monotonic() - wedged[0]
                break
        time.sleep(0.005)
    # un-wedge: the fenced slice unwinds and the next claim (the
    # requeued job) runs clean to completion, so the leg ends idle
    svc.worker.run_slice = orig
    release.set()
    th.join(timeout=240)
    if detect is None:
        out["serve_defense_error"] = out.get(
            "serve_defense_error", "watchdog never fired on the wedge"
        )
    else:
        out["serve_watchdog_detect_latency_s"] = round(detect, 3)
    _remove((poison_out, wd_out))
    return out


def run_serve_shard_bench(n_daemons: int, dev) -> dict:
    """The ``serve_shard`` sub-leg (the JAX bench's keys): ONE job
    through the fleet unsharded (K=1, through the full split/merge
    pipeline) and scattered at K=4 across ``n_daemons`` in-process
    daemons sharing the spool and ``dev``. Informational, non-gating:
    the daemons share one card, so the ratio measures scheduling and
    pipeline overlap, not K-way device parallelism.

      serve_shard_speedup   wall(K=1) / wall(K=4), same input and config
      serve_shard_merge_s   the K=4 merge stage's wall (splice + index)"""
    import shutil
    import threading

    from duplexumiconsensusreads_torch.serve import ConsensusService, client
    from duplexumiconsensusreads_torch.serve.queue import SpoolQueue

    cache, in_path, config = _serve_workload(8)
    out: dict = {"serve_shard_daemons": n_daemons}
    # warm the process first (kernel libraries, allocator), so the K=1
    # leg does not pay what the K=4 leg then gets for free
    warm_spool = os.path.join(cache, "serve_shard_warmup_spool")
    shutil.rmtree(warm_spool, ignore_errors=True)
    warm_out = os.path.join(cache, "serve_shard_warmup.bam")
    client.submit(warm_spool, in_path, warm_out, config=config)
    _swallow(ConsensusService(warm_spool, poll_s=0.02, device=dev).run_until_idle)
    _remove((warm_out,))
    walls: dict[int, float] = {}
    merge_s = None
    for k in (1, 4):
        spool = os.path.join(cache, f"serve_shard_spool_k{k}")
        shutil.rmtree(spool, ignore_errors=True)
        out_bam = os.path.join(cache, f"serve_shard_out_k{k}.bam")
        jid = client.submit(spool, in_path, out_bam, config=config, shards=k)
        svcs = [
            ConsensusService(spool, chunk_budget=0, poll_s=0.02,
                             daemon_id=f"shard-bench-{k}-{i}", device=dev)
            for i in range(n_daemons)
        ]
        t0 = time.monotonic()
        threads = [
            threading.Thread(target=lambda s=s: _swallow(s.run_until_idle), daemon=True)
            for s in svcs
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=1800)
        walls[k] = time.monotonic() - t0
        q = SpoolQueue(spool)
        q.refresh()
        entry = q.jobs.get(jid, {})
        if entry.get("state") != "done":
            return {**out, "serve_shard_error":
                    f"K={k} parent finished {entry.get('state')!r}"}
        if k == 4:
            merge_s = ((q.status(jid).get("result") or {}).get("sharded") or {}).get("merge_s")
        _remove((out_bam,))
    out.update({
        "serve_shard_k1_wall_s": round(walls[1], 2),
        "serve_shard_k4_wall_s": round(walls[4], 2),
        "serve_shard_speedup": round(walls[1] / max(walls[4], 1e-9), 2),
    })
    if merge_s is not None:
        out["serve_shard_merge_s"] = merge_s
    return out


def run_live_follow_bench(dev) -> dict:
    """The ``live_follow`` leg (the JAX bench's keys; informational,
    non-gating): the stream on ``dev`` tailing a BAM a paced writer is
    still appending, with a snapshot per committed chunk.
    ``live_first_snapshot_latency_s`` is the wall from follower start to
    the first published snapshot; ``live_steady_lag_chunks`` the mean
    lag behind the writer over the run's second half, in committed
    chunks. Both are paced by the writer's slab cadence
    (DUT_BENCH_LIVE_SLAB_S), so they observe the serving shape rather
    than gate the pipeline."""
    import threading

    from duplexumiconsensusreads_torch.runtime.stream import stream_call_consensus

    cache = _cache()
    n_reads = int(os.environ.get("DUT_BENCH_LIVE_READS", 120_000))
    src_path, _ = _e2e_input(n_reads)
    with open(src_path, "rb") as f:
        raw = f.read()
    in_path = os.path.join(cache, "live_in.bam")
    out_path = os.path.join(cache, "live_out.bam")
    trace_path = None
    if int(os.environ.get("DUT_BENCH_TRACE", 1)):
        trace_path = os.path.join(cache, "live_trace.jsonl")
    gp, cp = _e2e_params()
    chunk_reads = max(n_reads // 8, 10_000)
    n_slabs = 20
    slab_s = float(os.environ.get("DUT_BENCH_LIVE_SLAB_S", 0.2))
    slab = max(1, (len(raw) + n_slabs - 1) // n_slabs)
    written = {"bytes": 0}

    def writer():
        with open(in_path, "wb") as f:
            for off in range(0, len(raw), slab):
                f.write(raw[off:off + slab])
                f.flush()
                written["bytes"] = off + len(raw[off:off + slab])
                time.sleep(slab_s)

    with open(in_path, "wb"):
        pass  # the follower may open before the first slab lands
    commits: list = []  # (chunks_done, writer_frac, t_since_start)
    first_snap = [0.0]
    t0 = time.monotonic()

    def progress(_k, rep):
        now = time.monotonic() - t0
        if rep.snapshot_seq >= 1 and not first_snap[0]:
            first_snap[0] = now
        commits.append((len(commits) + 1, written["bytes"] / len(raw), now))

    wt = threading.Thread(target=writer)
    wt.start()
    try:
        rep = stream_call_consensus(
            in_path, out_path, gp, cp,
            capacity=int(os.environ.get("DUT_BENCH_CAPACITY", 2048)),
            chunk_reads=chunk_reads, follow=True, live_poll_s=0.05, snapshot_chunks=1,
            progress=progress, trace_path=trace_path, device=dev,
        )
    finally:
        wt.join()
    wall = time.monotonic() - t0
    for p in (out_path, in_path):
        try:
            os.remove(p)
        except OSError:
            pass
    lags = [max(frac * rep.n_chunks - done, 0.0)
            for done, frac, _ in commits[len(commits) // 2:]]
    out = {
        "live_follow_reads": int(rep.n_records),
        "live_follow_wall_s": round(wall, 2),
        "live_follow_chunks": int(rep.n_chunks),
        "live_snapshots_published": int(rep.snapshot_seq),
        "live_first_snapshot_latency_s": round(first_snap[0], 3),
        "live_steady_lag_chunks": round(sum(lags) / len(lags), 3) if lags else 0.0,
        "live_poll_s": round(rep.seconds.get("live_poll", 0.0), 2),
        "live_wait_s": round(rep.seconds.get("live_wait", 0.0), 2),
    }
    if trace_path:
        out["live_trace"] = trace_path
    return out


def run_cpu_e2e(n_target: int) -> dict:
    """The SAME streamed end-to-end pipeline on the host CPU
    (``device="cpu"``): the wall-clock denominator. Runs in a subprocess
    on the cached input of the identical workload, best of
    DUT_BENCH_CPU_E2E_REPS runs (the fastest CPU is the honest
    denominator on a shared host); the consensus math is the same
    pipeline with the kernels' plain versions."""
    import subprocess

    from duplexumiconsensusreads_torch.runtime.executor import default_ssc_method

    cache = _cache()
    in_path, _ = _e2e_input(n_target)
    capacity = int(os.environ.get("DUT_BENCH_CAPACITY", 2048))
    out_path = os.path.join(cache, "e2e_cpu_out.bam")
    # the child re-imports _e2e_params, so both runs stream the same
    # input with the same params by construction
    child = f"""
import json, time
from duplexumiconsensusreads_torch.benchmark import (
    E2E_CHUNK_READS, E2E_MAX_INFLIGHT, _e2e_params,
)
from duplexumiconsensusreads_torch.runtime.stream import stream_call_consensus
gp, cp = _e2e_params()
t0 = time.monotonic()
rep = stream_call_consensus(
    {in_path!r}, {out_path!r}, gp, cp,
    capacity={capacity},
    chunk_reads=E2E_CHUNK_READS, max_inflight=E2E_MAX_INFLIGHT,
    device="cpu",
)
wall = time.monotonic() - t0
print(json.dumps({{"reads": rep.n_records, "wall": wall,
                   "consensus": rep.n_consensus,
                   "phases": rep.seconds}}))
"""
    # the child imports this package from where this file lives
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (root, env.get("PYTHONPATH")) if p)
    reps = max(1, int(os.environ.get("DUT_BENCH_CPU_E2E_REPS", 2)))
    best = None
    walls = []
    try:
        for _ in range(reps):
            proc = subprocess.run(
                [sys.executable, "-c", child], capture_output=True, text=True, env=env,
            )
            if proc.returncode != 0:
                sys.stderr.write(proc.stderr[-2000:])
                return {"cpu_e2e_error": f"exit {proc.returncode}"}
            r = json.loads(proc.stdout.strip().splitlines()[-1])
            walls.append(round(r["wall"], 2))
            if best is None or r["wall"] < best["wall"]:
                best = r
    finally:
        try:
            os.remove(out_path)
        except OSError:
            pass
    return {
        "cpu_e2e_reads": best["reads"],
        "cpu_e2e_wall_s": round(best["wall"], 2),
        "cpu_e2e_walls": walls,
        "cpu_e2e_reads_per_sec": round(best["reads"] / best["wall"], 1),
        # the stream's dispatch on the CPU: the CPU's fastest reduction
        "cpu_e2e_ssc_method": default_ssc_method("cpu"),
        "cpu_e2e_phases": {k: v for k, v in best["phases"].items() if k != "total"},
    }


def compute_ssc_method(dev) -> str:
    """The compute leg's reduction: DUT_SSC_METHOD, in the JAX package's
    names or the port's (mapped as interop maps a JAX spec's method), or
    the device's default."""
    from duplexumiconsensusreads_torch.interop import _METHOD_NAMES
    from duplexumiconsensusreads_torch.runtime.executor import default_ssc_method

    name = os.environ.get("DUT_SSC_METHOD")
    if name is None:
        return default_ssc_method(dev)
    if name not in _METHOD_NAMES:
        raise SystemExit(f"DUT_SSC_METHOD: unknown method {name!r}")
    return _METHOD_NAMES[name]


def consensus_error_rate(class_outs, truth) -> tuple[int, int]:
    """(wrong, called) bases of the consensus against the simulator's
    truth: each consensus molecule maps to its true molecule through a
    member read. ``class_outs`` holds (numpy outputs, class buckets)."""
    n_err = n_base = 0
    for out_np, cbuckets in class_outs:
        for bi, bk in enumerate(cbuckets):
            mol = out_np["molecule_id"][bi]
            cv = out_np["cons_valid"][bi]
            ridx = bk.read_index
            sel = np.nonzero((ridx >= 0) & bk.valid & (mol >= 0))[0]
            if not len(sel):
                continue
            ms = mol[sel]
            order = np.argsort(ms, kind="stable")
            first = np.nonzero(np.r_[True, ms[order][1:] != ms[order][:-1]])[0]
            rep_mol = ms[order][first]  # molecule rows present in bucket
            rep_read = ridx[sel[order[first]]]  # one member read each
            true_rows = truth.mol_seq[truth.read_mol[rep_read]]
            called = out_np["cons_base"][bi][rep_mol]
            real = (called < 4) & cv[rep_mol][:, None]
            n_err += int((called[real] != true_rows[real]).sum())
            n_base += int(real.sum())
    return n_err, n_base


def main(device=None) -> None:
    """The whole bench on ``device`` (the card unless "cpu" is asked
    for; no card raises). Prints the journal on stderr, then the full
    result JSON and the compact line on stdout; raises SystemExit(1)
    after them when the regression gate fails."""
    import torch

    from duplexumiconsensusreads_torch.bucketing import build_buckets
    from duplexumiconsensusreads_torch.ops import ConsensusCaller, run_bucket
    from duplexumiconsensusreads_torch.ops.pipeline import analytic_flops
    from duplexumiconsensusreads_torch.oracle import group_reads
    from duplexumiconsensusreads_torch.parallel.mesh import device_pool
    from duplexumiconsensusreads_torch.parallel.sharded import (
        gather_outputs,
        presharded_pipeline,
    )
    from duplexumiconsensusreads_torch.runtime.executor import (
        DEFAULT_SSC_METHOD_CPU,
        resolve_device,
    )
    from duplexumiconsensusreads_torch.telemetry.device import device_peak_flops, round_mfu

    dev = resolve_device(device)
    on_cuda = dev.type == "cuda"
    device_name = torch.cuda.get_device_name(dev) if on_cuda else "cpu"
    # the JAX bench enables XLA's persistent compile cache here; the
    # port compiles only its _build/ libraries, each built once per
    # source digest at first use, so there is no cache to point

    n_target = int(os.environ.get("DUT_BENCH_READS", 600_000))
    capacity = int(os.environ.get("DUT_BENCH_CAPACITY", 2048))
    cpu_sample = int(os.environ.get("DUT_BENCH_CPU_SAMPLE", 3000))

    t0 = time.monotonic()
    gp, cp, batch, truth, sim_cfg = bench_batch(n_target)
    n_reads = int(np.asarray(batch.valid).sum())
    buckets = build_buckets(batch, capacity=capacity, grouping=gp)
    sim_s = time.monotonic() - t0

    ssc_method = compute_ssc_method(dev)
    mesh, streams = bench_mesh(dev)
    classes = mesh_classes(buckets, gp, cp, ssc_method, mesh, streams)

    def run_all():
        return [presharded_pipeline(args, cspec, mesh, streams=streams)
                for _, cspec, args in classes]

    with torch.no_grad():
        # the first call loads the kernel library and grows the
        # allocator: timed apart, as the JAX bench times its compile
        t0 = time.monotonic()
        run_all()
        _sync(mesh)
        compile_s = time.monotonic() - t0
        dev_s = time_step(run_all, mesh, int(os.environ.get("DUT_BENCH_REPS", 10)))
        # the pipeline is deterministic: one more step gives the
        # outputs the error rate reads
        outs = run_all()
    dev_rps = n_reads / dev_s

    # analytic executed-FLOP accounting -> TFLOP/s and MFU: per-class
    # geometry x bucket count over the measured step time, against the
    # device table's peak for this device (DUT_PEAK_TFLOPS overrides;
    # the CPU scores against the table's default entry)
    l_ = batch.read_len
    b_ = batch.umi_len
    step_flops = sum(
        analytic_flops(cspec, cbuckets[0].capacity, l_, b_)
        * args[0]["pos"].shape[0] * mesh.n_data
        for cbuckets, cspec, args in classes
    )
    peak, peak_entry = device_peak_flops(device_name)
    tflops = step_flops / dev_s / 1e12
    mfu = step_flops / dev_s / peak

    # consensus error rate vs simulation truth (the "matched error
    # rate" side of the metric)
    class_outs = [
        (gather_outputs(o, mesh, streams), cbuckets)
        for o, (cbuckets, _, _) in zip(outs, classes)
    ]
    del outs
    n_err, n_base = consensus_error_rate(class_outs, truth)
    del class_outs
    err_rate = n_err / max(n_base, 1)

    # CPU-oracle baseline on a subsample, scaled per-read
    sub_idx = np.nonzero(np.asarray(batch.valid))[0][:cpu_sample]
    sub = batch.take(sub_idx)
    t0 = time.monotonic()
    fams = group_reads(sub, gp)
    ConsensusCaller(cp, backend="cpu")(sub, fams)
    cpu_s = time.monotonic() - t0
    cpu_rps = len(sub_idx) / cpu_s

    # Vectorized CPU baseline: the SAME fused pipeline on the host CPU
    # (device="cpu", the kernels' plain versions) with the CPU's own
    # fastest reduction — a baseline hobbled with the card's method
    # would flatter the card
    target = int(os.environ.get("DUT_BENCH_VEC_SAMPLE", 30_000))
    sample, got = [], 0
    for cbuckets, cspec, _ in classes:
        cpu_spec = dataclasses.replace(cspec, ssc_method=DEFAULT_SSC_METHOD_CPU)
        for bk in cbuckets:
            sample.append((bk, cpu_spec))
            got += int(bk.valid.sum())
            if got >= target:
                break
        if got >= target:
            break
    with torch.no_grad():
        [run_bucket(bk, cs, device="cpu") for bk, cs in sample]  # warm-up
        # best of N timed passes: the shared host's scheduling noise
        # hits the denominator too, and the fastest CPU pass is the
        # honest one
        vec_reps = max(1, int(os.environ.get("DUT_BENCH_VEC_REPS", 3)))
        vec_cpu_s = float("inf")
        for _ in range(vec_reps):
            t0 = time.monotonic()
            [run_bucket(bk, cs, device="cpu") for bk, cs in sample]
            vec_cpu_s = min(vec_cpu_s, time.monotonic() - t0)
    vec_cpu_rps = got / max(vec_cpu_s, 1e-9)
    del classes

    result = {
        "metric": "reads_per_sec_duplex_consensus",
        "value": round(dev_rps, 1),
        "unit": "reads/s",
        "vs_baseline": round(dev_rps / cpu_rps, 2),
        "tflops": round(tflops, 4),
        # four significant figures: fixed decimals would flush a small
        # MFU to 0.0
        "mfu": round_mfu(mfu),
        # which peak-table row (or env override) scored the MFU
        "peak_entry": peak_entry,
        "vs_vectorized_cpu": round(dev_rps / vec_cpu_rps, 2),
        "vec_cpu_ssc_method": DEFAULT_SSC_METHOD_CPU,
        "ssc_method": ssc_method,
        "device": device_name,
        "device_count": torch.cuda.device_count() if on_cuda else 0,
        "consensus_error_rate": err_rate,
    }

    # ---- per-config compute matrix
    if int(os.environ.get("DUT_BENCH_PER_CONFIG", 1)):
        result["per_config"] = run_per_config(dev)

    # ---- bucket_tuner leg (host only; DUT_BENCH_TUNER=0 disables)
    if int(os.environ.get("DUT_BENCH_TUNER", 1)):
        result.update(run_bucket_tuner_bench())

    # ---- end-to-end legs: wire probe, e2e, wire probe again, the A/B
    # legs, then the CPU denominator strictly after all device work
    n_e2e = int(os.environ.get("DUT_BENCH_E2E_READS", 10_000_000))
    if n_e2e > 0:
        probes = []
        if on_cuda:
            probes.append(wire_probe(dev))
            result["wire_before_e2e"] = probes[0]
        e2e = run_e2e(n_e2e, dev)
        result.update(e2e)
        result["e2e_vs_compute"] = round(e2e["e2e_reads_per_sec"] / dev_rps, 3)
        if on_cuda:
            probes.append(wire_probe(dev))
            result["wire_after_e2e"] = probes[1]
            # arithmetic wall floor: measured bytes over measured wire,
            # bracketed by the probes on either side of the run
            floors = [
                e2e["e2e_h2d_mb"] / p["wire_h2d_mb_s"]
                + e2e["e2e_d2h_mb"] / p["wire_d2h_mb_s"]
                for p in probes
            ]
            result["e2e_wire_floor_s"] = [round(min(floors), 3), round(max(floors), 3)]
            result["e2e_wire_floor_frac"] = [
                round(min(floors) / e2e["e2e_wall_s"], 4),
                round(max(floors) / e2e["e2e_wall_s"], 4),
            ]
        else:
            result["wire_probe_skipped"] = "no host-device wire: the run is on the CPU"
        # same-run packed-vs-unpacked A/B: both legs here, same size,
        # adjacent in time; the legs SHRINK to whole chunks to fit the
        # budget instead of skipping (DUT_BENCH_E2E_AB=0 disables)
        n_ab = int(os.environ.get("DUT_BENCH_E2E_AB", 2_000_000))
        ab_budget = float(os.environ.get("DUT_BENCH_AB_BUDGET_S", 480))
        if n_ab > 0:
            exp_s = 2.0 * n_ab / max(e2e["e2e_reads_per_sec"], 1.0)
            if ab_budget > 0 and exp_s > ab_budget:
                # whole chunks: the leg size feeds the input cache key
                n_ab = min(
                    n_ab,
                    max(int(n_ab * ab_budget / exp_s) // E2E_CHUNK_READS, 1)
                    * E2E_CHUNK_READS,
                )
                result["e2e_ab_shrunk_to"] = n_ab
            packed_leg = run_e2e(n_ab, dev, packed="auto", prefix="e2e_ab_packed")
            result.update(packed_leg)
            unpacked = run_e2e(
                n_ab, dev, packed="off", d2h_packed="off", prefix="e2e_unpacked"
            )
            result.update(unpacked)
            result["e2e_packed_speedup"] = round(
                packed_leg["e2e_ab_packed_reads_per_sec"]
                / unpacked["e2e_unpacked_reads_per_sec"],
                3,
            )
            # d2h A/B: same H2D rung, packed vs unpacked return path
            d2h_off = run_e2e(
                n_ab, dev, packed="auto", d2h_packed="off", prefix="e2e_d2h_unpacked",
            )
            result.update(d2h_off)
            result["e2e_d2h_packed_speedup"] = round(
                packed_leg["e2e_ab_packed_reads_per_sec"]
                / d2h_off["e2e_d2h_unpacked_reads_per_sec"],
                3,
            )
            # ingest-overlap A/B: the background producer off; the
            # ratio is off-wall / on-wall (DUT_BENCH_INGEST_AB=0
            # disables)
            if int(os.environ.get("DUT_BENCH_INGEST_AB", 1)):
                ov_off = run_e2e(n_ab, dev, ingest_overlap="off", prefix="e2e_ov_off")
                result.update(ov_off)
                result["e2e_ingest_overlap"] = round(
                    ov_off["e2e_ov_off_wall_s"]
                    / max(packed_leg["e2e_ab_packed_wall_s"], 1e-9),
                    3,
                )
            # mesh-scaling A/B (DUT_BENCH_MESH=K, needs K devices in the
            # pool): the same leg at K devices vs 1, same warm caches.
            # With K lanes on CPU the ratio is informational (lanes
            # share the host's cores); across K cards it is the K-way
            # scaling headline
            n_mesh = int(os.environ.get("DUT_BENCH_MESH", 0))
            if n_mesh > 1:
                n_pool = len(device_pool(dev))
                if n_pool >= n_mesh:
                    mesh_leg = run_e2e(n_ab, dev, prefix="e2e_meshk", n_devices=n_mesh)
                    result.update(mesh_leg)
                    mesh_one = run_e2e(n_ab, dev, prefix="e2e_mesh1", n_devices=1)
                    result.update(mesh_one)
                    result["e2e_mesh_devices"] = n_mesh
                    result["e2e_mesh_scaling"] = round(
                        mesh_one["e2e_mesh1_wall_s"]
                        / max(mesh_leg["e2e_meshk_wall_s"], 1e-9),
                        3,
                    )
                else:
                    result["e2e_mesh_error"] = (
                        f"DUT_BENCH_MESH={n_mesh} but only {n_pool} devices visible"
                    )
        # serve_n_jobs: jobs through the in-process daemon vs a cold
        # one-shot process (DUT_BENCH_SERVE_JOBS=0 disables)
        n_serve = int(os.environ.get("DUT_BENCH_SERVE_JOBS", 3))
        if n_serve > 0:
            result.update(run_serve_bench(n_serve, dev))
        # serve_fleet: jobs through N in-process daemons on ONE spool
        # with daemon 0 killed mid-job, then the defense, scatter-gather
        # and cross-host sub-legs on the same fleet workload
        # (DUT_BENCH_SERVE_DAEMONS < 2 disables them)
        n_fleet = int(os.environ.get("DUT_BENCH_SERVE_DAEMONS", 2))
        if n_serve > 0 and n_fleet >= 2:
            result.update(run_serve_fleet_bench(n_fleet, dev))
            result.update(run_serve_defense_bench(dev))
            result.update(run_serve_shard_bench(n_fleet, dev))
            result.update(run_serve_xhost_bench(dev))
        # live_follow: the follower tailing a paced growing BAM
        # (DUT_BENCH_LIVE_READS=0 disables)
        if int(os.environ.get("DUT_BENCH_LIVE_READS", 120_000)) > 0:
            result.update(run_live_follow_bench(dev))
        # the same stream on the host CPU: the wall-clock denominator
        # (DUT_BENCH_CPU_E2E_READS=0 disables), after every device leg
        n_cpu_e2e = int(os.environ.get("DUT_BENCH_CPU_E2E_READS", 1_000_000))
        if n_cpu_e2e > 0:
            cpu_e2e = run_cpu_e2e(n_cpu_e2e)
            result.update(cpu_e2e)
            if "cpu_e2e_reads_per_sec" in cpu_e2e:
                result["e2e_vs_cpu_e2e"] = round(
                    e2e["e2e_reads_per_sec"] / cpu_e2e["cpu_e2e_reads_per_sec"], 2
                )
    # human journal FIRST (stderr, flushed), then the full JSON and the
    # COMPACT canonical line LAST on stdout
    print(
        f"# reads={n_reads} buckets={len(buckets)} device={device_name} "
        f"bucket_capacity={capacity} step={dev_s:.4f}s first_call={compile_s:.1f}s "
        f"cpu_oracle={cpu_rps:.0f} reads/s (n={len(sub_idx)}) "
        f"vec_cpu={vec_cpu_rps:.0f} reads/s (n={got}, fused pipeline on the "
        f"host CPU, {DEFAULT_SSC_METHOD_CPU}) "
        f"tflops={tflops:.4f} mfu={round_mfu(mfu)} "
        f"(peak={peak / 1e12:.1f}T [{peak_entry}]) sim={sim_s:.1f}s "
        f"consensus_error_rate={err_rate:.2e} ({n_err}/{n_base} bases, "
        f"raw base_error={sim_cfg.base_error:g}) ssc_method={ssc_method}",
        file=sys.stderr,
        flush=True,
    )
    full_path = os.path.join(_cache(), "bench_full.json")
    try:
        os.makedirs(_cache(), exist_ok=True)
        with open(full_path, "w") as f:
            json.dump(result, f)
    except OSError:
        full_path = None
    gate_failed = False
    compact = compact_result(result, full_path)
    if int(os.environ.get("DUT_BENCH_GATE", 1)):
        gate_ok, gate_problems = run_bench_gate(result)
        if gate_problems:
            # bounded: the compact line must stay inside the window
            compact["gate_regressions"] = [p[:160] for p in gate_problems[:3]]
        if not gate_ok:
            print(
                "# BENCH GATE FAILED: canonical metrics regressed vs the "
                "recorded trajectory — " + "; ".join(gate_problems),
                file=sys.stderr,
                flush=True,
            )
            gate_failed = True
    print(json.dumps(result), flush=True)
    print(json.dumps(compact), flush=True)
    if gate_failed:
        # the regression fails the run VISIBLY, after the result lines
        raise SystemExit(1)
