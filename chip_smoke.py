#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path — the config5 whole-file call (adjacency
grouping, paired duplex, per-cycle error model) through
``call_consensus_file`` on a simulated ~600k-read BAM, one dispatch of
the bench's size — and holds every hand-written kernel of that path
against its plain PyTorch version on the card. Phases, each printed as
one JSON line:

  env     the card (nvidia-smi name + power limit), torch and CUDA
  build   nvcc of every csrc/ source, all started together
  e2e     simulate -> call_consensus_file(device="cuda"); per-stage
          seconds, peak device memory, kernel launch counts (each must
          be > 0), device spans of the pipeline calls, and a small
          input called on the card and on the CPU (plain versions)
          that must agree record by record
  stages  the largest class's fused pipeline once more, warm, with the
          device span of each stage function it calls
  kernel  each kernel vs its plain version on random inputs and on the
          main path's real inputs (those of the stages rerun, whose ids
          must equal the e2e run's); times of the kernel, the plain
          version and one library call, and the byte bound
  parity  >= 8 real buckets through the fused pipeline with the kernel
          and with the plain reduction: integer outputs identical,
          bases identical except at ties, quals within 1

Then the nvidia-smi line, the ``kernels`` JSON line, and last
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
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
F32_FLOPS = 67e12  # H100 SXM f32 rate outside the tensor cores (data sheet)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}, sort_keys=True), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


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


def compare_records(a, b, qual_tol: int) -> dict:
    """Record-by-record agreement of two consensus BAM record sets."""
    import numpy as np

    if len(a) != len(b):
        raise AssertionError(f"record counts differ: {len(a)} vs {len(b)}")
    for f in ("names", "flags", "ref_id", "pos", "lengths", "seq"):
        if not np.array_equal(np.asarray(getattr(a, f)), np.asarray(getattr(b, f))):
            raise AssertionError(f"consensus records differ in {f}")
    if list(a.aux_raw) != list(b.aux_raw):
        raise AssertionError("consensus records differ in their aux tags")
    dq = np.abs(np.asarray(a.qual).astype(int) - np.asarray(b.qual).astype(int))
    if dq.size and dq.max() > qual_tol:
        raise AssertionError(f"quals differ by {dq.max()} > {qual_tol}")
    return {"n_records": len(a), "max_qual_diff": int(dq.max(initial=0))}


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

    from duplexumiconsensusreads_torch.cli.main import params_for
    from duplexumiconsensusreads_torch.io import read_bam, simulated_bam
    from duplexumiconsensusreads_torch.kernels import build, consensus
    from duplexumiconsensusreads_torch.kernels import segment_gemm as sg
    from duplexumiconsensusreads_torch.ops import pipeline
    from duplexumiconsensusreads_torch.runtime.executor import call_consensus_file
    from duplexumiconsensusreads_torch.simulate import SimConfig

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
        python=sys.version.split()[0],
    )

    t0 = time.monotonic()
    secs = build.build_all()
    emit("build", sources=list(build.SOURCES), seconds=round(time.monotonic() - t0, 3),
         per_source=secs)

    gp, cp, _ = params_for("config5")
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
                Capture(pipeline, "fused_pipeline") as cap_p:
            rep = call_consensus_file(
                in_bam, os.path.join(td, "out.bam"), gp, cp,
                capacity=CAPACITY, device="cuda",
            )
        wall = time.monotonic() - t0
        launches = {"segment_gemm": sg.segment_gemm.launches}
        peak_mem = torch.cuda.max_memory_allocated()
        if launches["segment_gemm"] == 0:
            raise AssertionError("the main path launched segment_gemm no time")
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
            bytes_h2d=rep.bytes_h2d, bytes_d2h=rep.bytes_d2h,
            max_memory_allocated=peak_mem, launches=launches,
            segment_gemm_calls=[list(s) for s in cap_k.shapes],
            segment_gemm_span_ms=cap_k.span_ms(),
            # device spans of the per-class fused_pipeline calls (copies
            # in and out excluded): the share of the wall the card spent
            # inside the pipeline, idle gaps within it included
            fused_pipeline_span_ms=pipe_ms,
            pipeline_span_share_of_wall=sum(pipe_ms) / 1e3 / wall,
        )

        # the same call on a small input, on the card and on the CPU
        # (plain versions everywhere): records agree, quals within one
        # per strand (CPU and CUDA transcendentals differ by ULPs, and a
        # duplex qual is the sum of two strand quals)
        small_bam = os.path.join(td, "small.bam")
        simulated_bam(dataclasses.replace(cfg, n_molecules=400, n_positions=10, seed=3),
                      path=small_bam, sort=True)
        outs = {}
        for d in ("cuda", "cpu"):
            call_consensus_file(small_bam, os.path.join(td, f"small_{d}.bam"), gp, cp,
                                capacity=256, device=d)
            outs[d] = read_bam(os.path.join(td, f"small_{d}.bam"))[1]
        emit("e2e_small_reference", **compare_records(outs["cuda"], outs["cpu"], qual_tol=2))

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
        got = sg.segment_gemm(x, ids, f_max)
        ref = sg.segment_gemm_plain(x, ids, f_max)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        rel = ((got - ref).abs() / ref.abs().clamp(min=1e-30)).max().item()
        # same f32 adds in the same ascending row order: bit-identical
        if not torch.equal(got, ref):
            raise AssertionError(f"segment_gemm {name}: max abs err {err} (tolerance 0)")
        kernel_rows.append({"case": name, "shape": [nb, r, c], "f_max": f_max,
                            "max_abs_err": err, "max_rel_err": rel, "tolerance": 0.0})
        del x, got, ref

    # the bound counts what this run's ids need: the live rows of big
    # once, every id once, every output element once
    live = ((fid >= 0) & (fid < f_max)).sum().item()
    need_bytes = live * c * 4 + fid.numel() * 4 + nb * f_max * c * 4
    bytes_ms = need_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = live * c / F32_FLOPS * 1e3
    k_ms = cuda_ms(lambda: sg.segment_gemm(big, fid, f_max), reps=20)
    plain_ms = cuda_ms(lambda: sg.segment_gemm_plain(big, fid, f_max), reps=2)
    base = torch.arange(nb, device=dev)[:, None] * (f_max + 1)
    offs = torch.where((fid >= 0) & (fid < f_max), fid.long() + base, base + f_max).reshape(-1)
    flat = big.reshape(-1, c)
    acc = torch.zeros(nb * (f_max + 1), c, device=dev)
    lib_ms = cuda_ms(lambda: acc.zero_().index_add_(0, offs, flat), reps=10)
    seg_row = {
        "name": "segment_gemm", "route": "cuda",
        "source": "duplexumiconsensusreads_torch/csrc/segment_gemm.cu",
        "replaces": "duplexumiconsensusreads_tpu/kernels/pallas_ssc.py:67",
        "launches": launches["segment_gemm"],
        "max_abs_err": max(row["max_abs_err"] for row in kernel_rows),
        "ms": k_ms, "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": lib_ms,
    }
    emit("kernel", name="segment_gemm", cases=kernel_rows, shape=[nb, r, c], f_max=f_max,
         live_rows=live, bytes_needed=need_bytes, bytes_bound_ms=bytes_ms, ops_bound_ms=ops_ms,
         kernel_ms=k_ms, plain_ms=plain_ms, library_ms=lib_ms, library_call="index_add_",
         bound_fraction=max(bytes_ms, ops_ms) / k_ms, nvidia_smi=smi)
    del big, fid, acc, flat, offs

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

    print(smi, flush=True)
    print(json.dumps({"kernels": [seg_row]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
