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
  per_config  configs 1-5 at their plans on the one device
  tuner       the bucket auto-tuner's measured fill (host only)
  e2e         the wire probe (pinned H2D/D2H MB/s), a cached
              simulated BAM streamed through ``stream_call_consensus``
              (ingest, bucketing, device compute, scatter, shard
              write, finalise) with its capture read back by the
              port's analysers, the probe again, then the packed /
              d2h / ingest-overlap A/B legs and the same stream on the
              CPU in a subprocess (the end-to-end denominator)

The mesh, serve and live legs need modules the port does not have yet
(several devices, ``serve/``, ``live/``): they are not run, and the
full JSON carries one ``*_skipped`` string per leg naming what is
missing.

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
DUT_BENCH_TRACE (1), DUT_BENCH_CACHE (.bench_cache), DUT_BENCH_GATE (1)
and DUT_BENCH_GATE_THRESHOLD (0.5). The JAX bench's mesh, serve and
live knobs are read by nothing here.

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

# The JAX bench's legs the port cannot run yet, each with what it needs
# (ROADMAP queue 1): reported, never stubbed
SKIPPED_LEGS = {
    "e2e_mesh_skipped": "not ported: dispatch across several devices "
    "(ROADMAP queue 1 item 5)",
    "serve_n_jobs_skipped": "not ported: the serving layer serve/ "
    "(ROADMAP queue 1 item 10b)",
    "serve_fleet_skipped": "not ported: the serving layer serve/ "
    "(ROADMAP queue 1 item 10b)",
    "serve_defense_skipped": "not ported: the serving layer serve/ "
    "(ROADMAP queue 1 item 10b)",
    "serve_shard_skipped": "not ported: serve/shard/ "
    "(ROADMAP queue 1 item 10b)",
    "serve_xhost_skipped": "not ported: serve/store.py "
    "(ROADMAP queue 1 item 10b)",
    "live_follow_skipped": "not ported: follow-mode ingest live/ "
    "(ROADMAP queue 1 item 10a)",
}


def _cache() -> str:
    return os.environ.get("DUT_BENCH_CACHE", ".bench_cache")


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


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
    make them, each stacked onto ``dev`` once (one device, no mesh: no
    padding buckets), so a timed loop measures compute, not the H2D of
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
    t0 = time.monotonic()
    rep = stream_call_consensus(
        in_path,
        out_path,
        gp,
        cp,
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
    from duplexumiconsensusreads_torch.ops.pipeline import fused_pipeline
    from duplexumiconsensusreads_torch.simulate import SimConfig, simulate_batch

    n_target = int(os.environ.get("DUT_BENCH_CONFIG_READS", 200_000))
    reps = int(os.environ.get("DUT_BENCH_CONFIG_REPS", 6))
    out = {}
    for name, (sim_kw, gp, cp, capacity) in _config_plans().items():
        per_mol = sim_kw["mean_family_size"] * (2 if sim_kw["duplex"] else 1)
        batch, _ = simulate_batch(
            SimConfig(n_molecules=max(64, n_target // per_mol), **sim_kw)
        )
        n_reads = int(np.asarray(batch.valid).sum())
        buckets = build_buckets(batch, capacity=capacity, grouping=gp)
        classes = device_classes(buckets, gp, cp, None, dev)

        def run_all():
            return [fused_pipeline(*args, cspec) for _, cspec, args in classes]

        with torch.no_grad():
            dt = min(time_step(run_all, dev, reps) for _ in range(2))
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
    from duplexumiconsensusreads_torch.ops.pipeline import analytic_flops, fused_pipeline
    from duplexumiconsensusreads_torch.oracle import group_reads
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
    classes = device_classes(buckets, gp, cp, ssc_method, dev)

    def run_all():
        return [fused_pipeline(*args, cspec) for _, cspec, args in classes]

    with torch.no_grad():
        # the first call loads the kernel library and grows the
        # allocator: timed apart, as the JAX bench times its compile
        t0 = time.monotonic()
        run_all()
        _sync(dev)
        compile_s = time.monotonic() - t0
        dev_s = time_step(run_all, dev, int(os.environ.get("DUT_BENCH_REPS", 10)))
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
        analytic_flops(cspec, cbuckets[0].capacity, l_, b_) * args[0].shape[0]
        for cbuckets, cspec, args in classes
    )
    peak, peak_entry = device_peak_flops(device_name)
    tflops = step_flops / dev_s / 1e12
    mfu = step_flops / dev_s / peak

    # consensus error rate vs simulation truth (the "matched error
    # rate" side of the metric)
    class_outs = [
        ({k: v.cpu().numpy() for k, v in o.items()}, cbuckets)
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
        **SKIPPED_LEGS,
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
