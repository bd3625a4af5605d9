#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's paths on the card — the config5 whole-file call
(adjacency grouping, paired duplex, per-cycle error model) through
``call_consensus_file`` on a simulated ~600k-read BAM, one dispatch of
the bench's size; the same call with per-base tags and a BAI; the
config5 streaming call through ``stream_call_consensus`` on the bench's
~2M-read e2e workload in 500k-read chunks, also under the bucket
ladder, with its captures read back by the port's analysers and tools;
the CLI workflow (simulate, call, filter, validate, group) on the
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
          device span of each stage function it calls
  kernel  each kernel vs its plain version on random inputs and on the
          main path's real inputs (those of the stages rerun, whose ids
          must equal the e2e run's), and at the per-base shape (the
          per_base call's full ssc pass, rerun); times of the kernel,
          the plain version and one library call, and the byte bound
  parity  >= 8 real buckets through the fused pipeline with the kernel
          and with the plain reduction: integer outputs identical,
          bases identical except at ties, quals within 1
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
          package too). Then, under the model-free duplex config, ladder
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
          chunk and the CPU e2e denominator at one chunk, one rep; then
          ``tools.profile_components`` and ``tools.profile_phases`` at
          BENCH_PROF_READS. Its compact and full result lines, checked:
          value > 0, peak entry h100-sxm-f32, five per_config rows, the
          e2e, A/B and tuner keys, the wire probe's MB/s, every
          ``*_skipped`` string, no ``*_error`` key, a consensus error
          rate below a tenth of the simulator's base error
  kernel_bench  the bench phase's largest segment_gemm launch at each
          (rows, columns, f_max): the kernel against its plain version
          (tolerance 0), and the kernel, plain, index_add_ and bound ms

Then the nvidia-smi line, the ``kernels`` JSON line (segment_gemm's
launches per path: whole_file, stream, per_base, workflow, operators,
ladder, race, bench; a ``rung_shapes`` sub-row with the kernel, plain,
library and bound ms at each explicit ladder rung's largest launch,
and a ``bench_shapes`` sub-row with the same at the bench phase's
largest launch of each (rows, columns, f_max) it gave the kernel),
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
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
F32_FLOPS = 67e12  # H100 SXM f32 rate outside the tensor cores (data sheet)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}, sort_keys=True), flush=True)


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


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events,
    after one warm-up call)."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class Capture:
    """Wraps a function in a module namespace and keeps references to
    the arguments of its call with the largest first tensor (the main
    path's biggest dispatch class): all of them, or only those at the
    indices ``keep``. Each call's device span (CUDA events around it)
    is kept too."""

    def __init__(self, module, name: str, keep: tuple | None = None):
        self.module, self.name, self.keep = module, name, keep
        self.inner = getattr(module, name)
        self.args = None
        self.size = -1
        self.shapes = []
        self.events = []

    def __enter__(self):
        import torch

        def wrapped(*args, **kwargs):
            first = args[0]
            self.shapes.append(tuple(first.shape))
            if first.numel() > self.size:
                self.size = first.numel()
                keep = range(len(args)) if self.keep is None else self.keep
                self.args = ([args[i] if i in keep else None for i in range(len(args))], kwargs)
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


def compare_records(a, b, qual_tol: int, duplex_ties: bool = False,
                    per_base: bool = False) -> dict:
    """Record-by-record agreement of two consensus BAM record sets:
    everything identical but the quals, which agree within
    ``qual_tol``. With ``duplex_ties``, the parity bar's evidence ties
    are allowed too: a strand consensus that ties between two bases
    (strand qual <= TIE_QUAL) may call either, which in the duplex merge
    either turns the cycle into N at NO_CALL_QUAL (2) on one side or
    moves the duplex qual by at most 2 * TIE_QUAL + qual_tol with the
    same base; such cycles are counted and must stay under 1 in 10,000.
    With ``per_base``, every record carries cd/ce: cd (an integer depth)
    must be identical, ce (reads disagreeing with the call) may differ
    only at those tie cycles, and its differing cycles are counted."""
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
    n_tie = 0
    if duplex_ties:
        n_call = (sa == 4) | (sb == 4)
        tie = ((sa != sb) & n_call & (qa == 2) & (qb == 2)) | (
            (sa == sb) & (dq > qual_tol) & (dq <= 2 * TIE_QUAL + qual_tol))
        n_tie = int(tie.sum())
        if n_tie * 10_000 > sa.size:
            raise AssertionError(f"{n_tie} tie cycles of {sa.size}: more than 1 in 10,000")
        dq = np.where(tie, 0, dq)
        sb = np.where(tie, sa, sb)
    if not np.array_equal(sa, sb):
        raise AssertionError("consensus records differ in seq")
    if dq.size and dq.max() > qual_tol:
        raise AssertionError(f"quals differ by {dq.max()} > {qual_tol}")
    out = {"n_records": len(a), "max_qual_diff": int(dq.max(initial=0)),
           "tie_cycles": n_tie, "cycles": int(sa.size)}
    if per_base:
        ce_ties = 0
        tie_rows = tie if duplex_ties else np.zeros(sa.shape, bool)
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


def main() -> int:
    import torch

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
    from duplexumiconsensusreads_torch.kernels import build, consensus
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

        sg.segment_gemm.launches = 0
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
        launches["whole_file"] = sg.segment_gemm.launches
        peak_mem = torch.cuda.max_memory_allocated()
        if launches["whole_file"] == 0:
            raise AssertionError("the main path launched segment_gemm no time")
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
            max_memory_allocated=peak_mem, launches={"segment_gemm": launches["whole_file"]},
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
             consensus: ("_evidence_columns", "_reduce")}
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
    del caps, whole, cap_k

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
        x = big if name == "real_main_path" else torch.randn(nb, r, c, device=dev, generator=rng)
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
        "launches": launches["whole_file"],
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

    del out_k, out_p, sub, full, args, kw, cap_p
    torch.cuda.empty_cache()
    # the bench's input cache: the stream phase simulates its input
    # there, and the bench phase's e2e leg reuses it
    bench_cache = tempfile.TemporaryDirectory(prefix="chip_smoke_bench_")
    launches["stream"], launches["ladder"], rung_calls = stream_phases(gp, smi, bench_cache.name)
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
    launches["race"] = race_phase(smi)
    launches["bench"], bench_calls = bench_phase(bench_cache.name, smi)
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
    seg_row["launches"] = {k: launches[k] for k in ("whole_file", "stream", "per_base",
                                                    "workflow", "operators", "ladder", "race",
                                                    "bench")}

    print(smi, flush=True)
    print(json.dumps({"kernels": [seg_row]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


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
    from duplexumiconsensusreads_torch.kernels import segment_gemm as sg
    from duplexumiconsensusreads_torch.ops import pipeline
    from duplexumiconsensusreads_torch.runtime.executor import call_consensus_file

    out = os.path.join(td, "per_base.bam")
    sg.segment_gemm.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    with Capture(consensus, "segment_gemm", keep=(1,)) as cap_k, \
            Capture(pipeline, "fused_pipeline") as cap_p:
        rep = call_consensus_file(in_bam, out, gp, cp, capacity=CAPACITY, device="cuda",
                                  per_base_tags=True, write_index=True)
    wall = time.monotonic() - t0
    launches = sg.segment_gemm.launches
    peak_mem = torch.cuda.max_memory_allocated()
    widths = sorted({s[-1] for s in cap_k.shapes})
    header, recs = read_bam(out)
    l_max = int(np.asarray(recs.lengths).max())
    c_full = 9 * l_max + 1
    if launches == 0 or c_full not in widths:
        raise AssertionError(f"per-base path: {launches} launches at widths {widths}, "
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
         launches={"segment_gemm": launches}, segment_gemm_widths=widths,
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
    sg.segment_gemm.launches = 0
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
    launches = sg.segment_gemm.launches
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
         launches={"segment_gemm": launches}, validate=val, group=grp,
         base_error=cfg.base_error, small_input=small,
         phase_seconds=round(time.monotonic() - t_phase, 3))
    return launches


def operators_phase() -> int:
    """UmiGrouper + ConsensusCaller with the cuda backend against the cpu
    (oracle) backend on a small duplex batch with the cycle model.
    Returns segment_gemm's launches in the cuda run."""
    import numpy as np
    import torch

    from duplexumiconsensusreads_torch.kernels import segment_gemm as sg
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
    sg.segment_gemm.launches = 0
    t0 = time.monotonic()
    fams = UmiGrouper(gp, backend="cuda")(batch)
    cons = ConsensusCaller(cp, backend="cuda")(batch, fams)
    cuda_s = time.monotonic() - t0
    launches = sg.segment_gemm.launches
    t0 = time.monotonic()
    ofams = UmiGrouper(gp, backend="cpu")(batch)
    ocons = ConsensusCaller(cp, backend="cpu")(batch, ofams)
    cpu_s = time.monotonic() - t0
    for f in ("family_id", "molecule_id", "pair_id", "n_families", "n_molecules"):
        if not np.array_equal(np.asarray(getattr(fams, f)), np.asarray(getattr(ofams, f))):
            raise AssertionError(f"operators: UmiGrouper {f} differs between backends")
    if launches == 0:
        raise AssertionError("the cuda ConsensusCaller launched segment_gemm no time")
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
         launches={"segment_gemm": launches}, cuda_seconds=round(cuda_s, 3),
         cpu_backend_seconds=round(cpu_s, 3), phase_seconds=round(time.monotonic() - t_phase, 3))
    return launches


def stream_phases(gp, smi: str, bench_cache: str):
    """The streaming path: the "stream", "stream_small_reference",
    "stream_resume", "ladder" and "capture" phases, on the bench's e2e
    input simulated into ``bench_cache``. Returns segment_gemm's
    launches on the full-width streaming run and on the ladder runs,
    and the ladder run's largest launch at each explicit rung."""
    import numpy as np
    import torch

    from duplexumiconsensusreads_torch import benchmark
    from duplexumiconsensusreads_torch.io import native_reader, read_bam, simulated_bam
    from duplexumiconsensusreads_torch.io.bai import build_bai
    from duplexumiconsensusreads_torch.kernels import segment_gemm as sg
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
        sg.segment_gemm.launches = 0
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
        launches = sg.segment_gemm.launches
        peak_mem = torch.cuda.max_memory_allocated()
        if launches == 0:
            raise AssertionError("the streaming path launched segment_gemm no time")
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
            max_memory_allocated=peak_mem, launches={"segment_gemm": launches},
            fused_pipeline_calls=len(spans),
            fused_pipeline_span_ms=[round(b - a, 3) for a, b in spans],
            fused_pipeline_span_sum_ms=sum(b - a for a, b in spans),
            fused_pipeline_union_ms=union_ms,
            pipeline_union_share_of_wall=union_ms / 1e3 / wall,
            native=True, native_chunk_parses=len(t_read.seen), deflate="native",
            shard_codecs=codecs, trace_sum_check=check, nvidia_smi=smi,
        )
        del cap, recs, out_recs

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

        ladder_launches, rung_calls, captures = ladder_phase(
            in_bam, out_bam, gp, cp, settings, td, smi)
        capture_phase({"stream": (trace, out_bam), **captures}, td, smi)
    return launches, ladder_launches, rung_calls


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


def ladder_phase(in_bam: str, out_bam: str, gp, cp, settings: dict, td: str, smi: str):
    """The stream phase's input and settings with bucket_ladder "auto"
    and LADDER.

    The main path (config5): verdicts, fills, walls and launch shapes,
    and the records against the ladder-off output of the stream phase.
    config5's quals move with the ladder, in the JAX package too: its
    cycle error model is fit per bucket, and a ladder regroups the
    buckets (ROADMAP Faults found); those cycles are counted, and every
    other field must be identical. Byte identity is held where the
    output does not depend on the bucket composition: the same input
    under the model-free duplex config, ladder off, auto and LADDER,
    then a kill under auto and a resume under LADDER. Returns the
    launches of the two config5 ladder runs, the explicit run's largest
    launch per rung, and {name: (trace, output)} of their captures."""
    import numpy as np
    import torch

    from duplexumiconsensusreads_torch.io import read_bam
    from duplexumiconsensusreads_torch.kernels import consensus
    from duplexumiconsensusreads_torch.kernels import segment_gemm as sg
    from duplexumiconsensusreads_torch.runtime import faults
    from duplexumiconsensusreads_torch.runtime.stream import stream_call_consensus

    t_phase = time.monotonic()
    off = read_bam(out_bam)[1]
    runs, captures = {}, {}
    torch.cuda.synchronize()
    sg.segment_gemm.launches = 0
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
    launches = sg.segment_gemm.launches
    if launches == 0:
        raise AssertionError("the ladder runs launched segment_gemm no time")
    del off

    # byte identity where the output cannot depend on the buckets' make-up
    cp_free = dataclasses.replace(cp, error_model=None)
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
         launches={"segment_gemm": launches},
         byte_identity={"config": "config5 with error_model=None", "runs": ident,
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
    from duplexumiconsensusreads_torch.kernels import segment_gemm as sg
    from duplexumiconsensusreads_torch.ops.pipeline import fused_pipeline
    from duplexumiconsensusreads_torch.runtime.executor import partition_buckets, resolve_device
    from duplexumiconsensusreads_torch.tuning import race_ssc_methods
    from duplexumiconsensusreads_torch.tuning.tuner import race_workload

    t_phase = time.monotonic()
    dev = resolve_device("cuda")
    torch.cuda.synchronize()
    sg.segment_gemm.launches = 0
    race = race_ssc_methods(blockseg_ts=(64, 128, 256))
    launches = sg.segment_gemm.launches
    race_s = time.monotonic() - t_phase
    if launches == 0 or race["backend"] != dev.type:
        raise AssertionError(f"race: {launches} segment_gemm launches on {race['backend']}")

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
         race_seconds=round(race_s, 3), launches={"segment_gemm": launches},
         parity_vs_segment_gemm=parity, blockseg_run_to_run_identical=True,
         classes=len(ref), phase_seconds=round(time.monotonic() - t_phase, 3), nvidia_smi=smi)
    return launches


def bench_phase(bench_cache: str, smi: str):
    """The bench through ``benchmark.main(device="cuda")`` (what the
    CLI's ``bench`` runs) with its env knobs cut to fit the smoke's
    time, then the profile tools once each; every result checked.
    Returns segment_gemm's launches over the phase, and the largest
    launch at each (R, C, f_max) the phase gave the kernel."""
    import io

    import torch

    from duplexumiconsensusreads_torch import benchmark
    from duplexumiconsensusreads_torch.kernels import consensus
    from duplexumiconsensusreads_torch.kernels import segment_gemm as sg
    from duplexumiconsensusreads_torch.tools import profile_components, profile_phases

    knobs = dict(
        DUT_BENCH_CACHE=bench_cache,
        # the stream phase's input: the bench finds it in its cache
        DUT_BENCH_E2E_READS=str(STREAM_READS),
        # the A/B legs and the CPU denominator at one chunk, one rep
        DUT_BENCH_E2E_AB=str(STREAM_CHUNK_READS),
        DUT_BENCH_CPU_E2E_READS=str(STREAM_CHUNK_READS),
        DUT_BENCH_CPU_E2E_REPS="1",
        DUT_BENCH_GATE="0",
        DUT_PROF_READS=str(BENCH_PROF_READS),
    )
    torch.cuda.synchronize()
    sg.segment_gemm.launches = 0
    t0 = time.monotonic()
    with environ(**knobs), \
            RungKeeper(consensus, key=lambda big, f_max: (*big.shape[1:], f_max)) as keep:
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
    launches = sg.segment_gemm.launches
    if len(lines[-1]) >= 1400:
        raise AssertionError(f"the bench's compact line is {len(lines[-1])} bytes")
    compact, full = json.loads(lines[-1]), json.loads(lines[-2])
    problems = [k for k in full if k.endswith("_error")]
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
            "cpu_e2e_reads_per_sec", "e2e_vs_cpu_e2e")
    problems += [f"no {k}" for k in want if k not in full]
    for probe in ("wire_before_e2e", "wire_after_e2e"):
        p = full.get(probe, {})
        if not (p.get("wire_h2d_mb_s", 0) > 0 and p.get("wire_d2h_mb_s", 0) > 0):
            problems.append(f"{probe} {p}")
    if {k: full.get(k) for k in benchmark.SKIPPED_LEGS} != benchmark.SKIPPED_LEGS:
        problems.append("the *_skipped strings")
    if full.get("e2e_reads", 0) < 0.9 * STREAM_READS or full.get("e2e_consensus", 0) == 0:
        problems.append(f"e2e streamed {full.get('e2e_reads')} reads")
    if not full["consensus_error_rate"] < 1e-3:
        problems.append(f"consensus error rate {full['consensus_error_rate']}")
    for name, res in tools.items():
        if res["device"] != "cuda" or not all(r["step_s"] > 0 for r in res["rows"].values()):
            problems.append(f"{name} {res}")
    if launches == 0:
        problems.append("the bench launched segment_gemm no time")
    if problems:
        raise AssertionError(f"bench: {problems}")
    emit("bench", compact=compact, full=full, profile_components=tools["profile_components"],
         profile_phases=tools["profile_phases"], launches={"segment_gemm": launches},
         segment_gemm_shapes=sorted(list(sh) for sh in keep.shapes),
         bench_seconds=round(bench_s, 3), tools_seconds=round(tools_s, 3), knobs=knobs,
         nvidia_smi=smi)
    torch.cuda.synchronize()
    return launches, keep.calls


if __name__ == "__main__":
    sys.exit(main())
