"""Command line: ``python -m duplexumiconsensusreads_torch <subcommand>``.

  call      BAM/npz in -> consensus BAM out: ``--backend cuda`` (the
            default; the bucketed device pipeline on ``--device``, the
            GPU unless ``--device cpu``) or ``--backend cpu`` (the NumPy
            oracle); the whole-file executor, or with ``--chunk-reads N``
            the streaming one
  simulate  write a truth-aware synthetic BAM (+ truth npz)
  filter    post-filter a consensus BAM (FilterConsensusReads analogue)
  validate  consensus error rate of a consensus BAM against the truth
  stats     input family-size metrics (GroupReadsByUmi-metrics analogue)
  group     annotate reads with MI molecule ids (GroupReadsByUmi)
  index     the linear .dlix, or the standard .bai / .csi
  view      records overlapping a region, through the .bai/.csi
  bench     the reads/s benchmark (benchmark.py), on the card unless
            ``--device cpu``

The JAX package's CLI on one host, flag for flag. ``call`` resolves
every parameter as the JAX CLI does — explicit flag > ``--config-file``
(TOML/JSON, keys from runtime/knobs.py) > ``--config`` preset > default
— and refuses what it refuses in its words. ``call --submit/--status/
--wait`` are the serving client (serve/client.py; the daemon is
``python -m duplexumiconsensusreads_torch.serve.daemon``): they touch
neither the executor stack nor CUDA, exit 0 / 1 (failed, rejected,
shed, expired, quarantined, unknown) / 3 (a ``--wait`` timeout) as the
JAX CLI does, and a job carries no device: ``--submit --device`` is
refused in favour of the daemon's ``--device``. ``call --n-hosts N
--host-id I [--index P]`` runs this host's key range of the streaming
call (parallel/distributed.py), coordinated through a torch.distributed
TCPStore when torchrun's MASTER_ADDR/MASTER_PORT/WORLD_SIZE/RANK are
set. ``--devices N`` (the whole-file and streaming mesh size),
``--mesh N|auto`` (the streaming mesh) and ``--cycle-shards K`` take
the JAX CLI's semantics over parallel/mesh.py's pool: the visible
cards, or with ``--device cpu`` logical lanes of the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys

from duplexumiconsensusreads_torch.runtime import knobs

CONFIG_PRESETS = {
    # 1. single-strand consensus, exact grouping (small amplicon)
    "config1": dict(grouping="exact", mode="ss", error_model="none"),
    # 2. directional adjacency grouping, Hamming<=1 (hybrid-capture panel)
    "config2": dict(grouping="adjacency", mode="ss", error_model="none"),
    # 3. duplex consensus, top+bottom merge (ctDNA panel)
    "config3": dict(grouping="adjacency", mode="duplex", error_model="none"),
    # 4. whole-exome duplex, family-size-bucketed shards across the mesh
    "config4": dict(grouping="adjacency", mode="duplex", error_model="none", capacity=4096),
    # 5. per-cycle error-model / quality-recalibrated duplex
    "config5": dict(grouping="adjacency", mode="duplex", error_model="cycle"),
}

# the job states --status/--wait exit 1 on (the JAX CLI's)
_BAD_STATES = ("failed", "rejected", "expired", "quarantined", "unknown")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m duplexumiconsensusreads_torch",
        description="duplex UMI consensus calling on PyTorch / CUDA",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    # every flag whose value a config file may also set defaults to None
    # (unset), so the precedence rule can tell an explicit flag from the
    # default; each default lives in _cmd_call's opt() calls
    c = sub.add_parser("call", help="group UMIs and call consensus reads")
    c.add_argument("input", nargs="?", default=None,
                   help="input BAM (or ReadBatch .npz); optional only with --status/--wait")
    c.add_argument("-o", "--output", default=None,
                   help="output consensus BAM (required except with --status/--wait)")
    sv = c.add_argument_group("serving client (serve/client.py; the spool is the protocol)")
    sv.add_argument("--submit", action="store_true",
                    help="do not run: durably spool this call as a job for a "
                    "serve.daemon on --spool (prints the job id on stdout). Streaming "
                    "params only; the daemon owns the device")
    sv.add_argument("--spool", default=None, metavar="DIR",
                    help="service spool directory for --submit/--status/--wait "
                    "(default: $DUT_SPOOL)")
    sv.add_argument("--priority", type=int, default=1,
                    help="--submit priority class (lower = more urgent; FIFO within "
                    "a class; default 1)")
    sv.add_argument("--status", default=None, metavar="JOB_ID",
                    help="print a submitted job's state as JSON and exit (exit 1 for "
                    "failed/rejected/expired/quarantined/unknown)")
    sv.add_argument("--wait", default=None, metavar="JOB_ID",
                    help="poll until the job reaches a terminal state, then print its "
                    "status JSON (see --wait-timeout)")
    sv.add_argument("--wait-timeout", type=float, default=0.0, metavar="SECONDS",
                    help="--wait gives up after this long (0 = wait forever): exit 3, "
                    "the job's last journaled state on stderr")
    sv.add_argument("--json", action="store_true",
                    help="with --status/--wait: one normalized status document on "
                    "stdout and nothing on stderr; exit codes unchanged")
    sv.add_argument("--deadline", type=float, default=None, metavar="SECONDS",
                    help="--submit wall budget from admission (default: the daemon's "
                    "--deadline)")
    sv.add_argument("--shards", type=int, default=None, metavar="K",
                    help="--submit scatter-gather: K range sub-jobs merged into one "
                    "BAM byte-identical to the unsharded run")
    sv.add_argument("--shard-bytes", type=int, default=None, metavar="BYTES",
                    help="--submit scatter-gather by compressed input size (exclusive "
                    "with --shards)")
    c.add_argument("--config", choices=sorted(CONFIG_PRESETS), help="benchmark preset")
    c.add_argument("--config-file",
                   help="TOML or JSON file of call settings (the knob names, "
                   "underscored); precedence: explicit flag > file > --config "
                   "preset > default")
    c.add_argument("--backend", choices=["cuda", "cpu", "tpu"], default=None,
                   help="cuda (default): the device pipeline on --device; cpu: the "
                   "NumPy oracle (whole file only)")
    c.add_argument("--device", choices=["cuda", "cpu"], default=None,
                   help="where --backend cuda runs (default cuda; cpu runs every "
                   "kernel's plain version)")
    c.add_argument("--grouping", choices=["exact", "adjacency", "cluster"], default=None)
    c.add_argument("--mode", choices=["ss", "duplex"], default=None)
    c.add_argument("--error-model", choices=["none", "cycle"], default=None)
    c.add_argument("--max-hamming", type=int, default=None)
    c.add_argument("--count-ratio", type=int, default=None,
                   help="directional adjacency edge condition "
                   "count(a) >= ratio*count(b)-1 (UMI-tools default 2)")
    c.add_argument("--min-reads", type=int, default=None)
    c.add_argument("--min-duplex-reads", type=int, default=None)
    c.add_argument("--max-qual", type=int, default=None)
    c.add_argument("--max-input-qual", type=int, default=None)
    c.add_argument("--min-input-qual", type=int, default=None,
                   help="mask input bases below this quality (masked bases add no "
                   "evidence or depth)")
    c.add_argument("--mate-aware", choices=["auto", "on", "off"], default=None,
                   help="split families by fragment end and emit consensus R1+R2 "
                   "pairs (auto: when the input mixes mates)")
    c.add_argument("--per-base-tags", action="store_true", default=None,
                   help="emit per-base depth (cd:B,I) and disagreeing-read-count "
                   "(ce:B,I) arrays on every consensus record")
    c.add_argument("--max-reads", type=int, default=None,
                   help="cap each exact sub-family at this many reads (0 = off)")
    c.add_argument("--capacity", type=int, default=None, help="bucket read capacity")
    c.add_argument("--read-group-id", default=None, help="consensus @RG id (default A)")
    c.add_argument("--write-index", action="store_true", default=None,
                   help="also write the standard .bai (.csi past 2^29) beside the output")
    c.add_argument("--report", help="RunReport JSON path ('-' = stdout)")
    c.add_argument("--profile", help="write a torch.profiler trace to this dir")
    w = c.add_argument_group("whole-file only")
    w.add_argument("--ref-projected", action="store_true", default=None,
                   help="project reads onto per-position reference columns")
    w.add_argument("--umi-whitelist", default=None,
                   help="expected-UMI list (one ACGT string per line): UMIs snap to "
                   "their unique nearest entry within --umi-max-mismatches")
    w.add_argument("--umi-max-mismatches", type=int, default=None,
                   help="whitelist correction distance bound (default 1)")
    s = c.add_argument_group("streaming (with --chunk-reads N > 0)")
    s.add_argument("--chunk-reads", type=int, default=None,
                   help="stream the input in chunks of this many records "
                   "(0 = whole file in memory); needs coordinate-sorted input")
    s.add_argument("--checkpoint", default=None, help="chunk-progress manifest path")
    s.add_argument("--resume", action="store_true", help="skip chunks already in the manifest")
    s.add_argument("--max-inflight", type=int, default=None,
                   help="chunks in flight ahead of the ordered commit (default 4)")
    s.add_argument("--drain-workers", type=int, default=None,
                   help="drain worker threads (default 2)")
    s.add_argument("--packed", choices=["auto", "byte", "off"], default=None,
                   help="wire packing: auto = best lossless H2D rung per class, "
                   "byte caps at the byte rung; off also unpacks the return path")
    s.add_argument("--prefetch-depth", type=int, default=None,
                   help="chunks dispatched ahead of the drain (default 2)")
    s.add_argument("--ingest-overlap", choices=["auto", "on", "off"], default=None,
                   help="BGZF read + decode + bucketing on a background thread")
    s.add_argument("--bucket-ladder", default=None, metavar="{auto,off,R1,R2,..}",
                   help="mixed-capacity bucket ladder: 'auto' profiles the first "
                   "chunk's family sizes and picks 1-3 pow2 bucket capacities by "
                   "the tuner's cost model (tuning/); an ascending pow2 list like "
                   "'256,2048' pins the rungs (the top rung replaces --capacity); "
                   "'off' (default) keeps the single --capacity. A shape choice: "
                   "single-end input without an error model gives the same bytes at "
                   "every setting")
    s.add_argument("--trace", default=None, metavar="TRACE_JSONL",
                   help="per-chunk span/event capture (JSONL)")
    s.add_argument("--heartbeat", type=float, default=0.0, metavar="SECONDS",
                   help="liveness line to stderr every N seconds")
    s.add_argument("--chaos", default=None, metavar="SCHEDULE",
                   help="deterministic fault injection (runtime/faults.py): "
                   "site:nth:kind entries, or seed:<seed>:<n>")
    s.add_argument("--follow", action="store_true", default=None,
                   help="follow-mode ingest (live/): tail a GROWING input (a regular "
                   "file another process appends to, or a FIFO), admitting only "
                   "complete-BGZF-block byte runs, and finalise when it finishes "
                   "(see --finalize-on); byte-identical to the batch run")
    s.add_argument("--finalize-on", default=None, metavar="{eof,idle:N,marker}",
                   help="follow termination rule: 'eof' (the 28-byte BGZF EOF block; "
                   "default), 'idle:N' (no growth for N seconds), 'marker' "
                   "(<input>.done exists)")
    s.add_argument("--live-poll-s", type=float, default=None,
                   help="follow poll cadence in seconds (default 0.25)")
    s.add_argument("--snapshot-chunks", type=int, default=None,
                   help="publish an indexed partial snapshot (OUT.snapshot.bam, a "
                   "valid BAM prefix) every N committed chunks; 0 = off (default)")
    c.add_argument("--n-hosts", type=int, default=0,
                   help="multi-host partitioning: total hosts (with --host-id; "
                   "requires a linear index, built on demand)")
    c.add_argument("--host-id", type=int, default=None, help="this host's id")
    c.add_argument("--index", help="linear index path (default: input + .dlix)")
    c.add_argument("--devices", type=int, default=None,
                   help="mesh size (default: one lane; the JAX package takes all)")
    c.add_argument(
        "--mesh", default=None, metavar="{auto,1,2,4,8,..}",
        help="streaming mesh size: shard each chunk's bucket batch across this "
        "many devices ('auto' = the --devices mesh, one lane by default). "
        "Output bytes are identical "
        "at ANY device count — chunk order is the commit order and mesh-pad "
        "buckets emit nothing — so this is a pure throughput knob, A/B-tested "
        "like --drain-workers. Carried by --submit jobs (the daemon resolves "
        "'auto' against its own device pool); requires --chunk-reads. With "
        "--device cpu the devices are logical lanes of the CPU",
    )
    c.add_argument(
        "--cycle-shards", type=int, default=None,
        help="shard the read-length axis this many ways (long reads); "
        "devices must be divisible by it",
    )

    sm = sub.add_parser("simulate", help="write a truth-aware synthetic BAM")
    sm.add_argument("-o", "--output", required=True, help="output BAM path")
    sm.add_argument("--truth", help="also write ground-truth npz here")
    sm.add_argument("--molecules", type=int, default=1000)
    sm.add_argument("--read-len", type=int, default=150)
    sm.add_argument("--umi-len", type=int, default=6)
    sm.add_argument("--positions", type=int, default=32)
    sm.add_argument("--family-size", type=int, default=4)
    sm.add_argument("--max-family-size", type=int, default=16)
    sm.add_argument("--base-error", type=float, default=0.01)
    sm.add_argument("--cycle-error-slope", type=float, default=0.0)
    sm.add_argument("--umi-error", type=float, default=0.0)
    sm.add_argument("--indel-error", type=float, default=0.0,
                    help="per-read 1bp indel prob (exercises the modal-CIGAR filter)")
    sm.add_argument("--single-strand", action="store_true", help="no duplex pairing")
    sm.add_argument("--sorted", action="store_true",
                    help="emit records in coordinate order (streaming input contract)")
    sm.add_argument("--paired-end", action="store_true",
                    help="emit paired-end style flags (F1R2/F2R1) with mate pointers")
    sm.add_argument("--paired-reads", action="store_true",
                    help="simulate true R1+R2 mate pairs (each fragment end has its "
                    "own ground-truth sequence)")
    sm.add_argument("--seed", type=int, default=0)

    f = sub.add_parser("filter", help="post-filter a consensus BAM (FilterConsensusReads "
                       "analogue): depth/quality thresholds + low-quality base masking")
    f.add_argument("input", help="consensus BAM from `call`")
    f.add_argument("-o", "--output", required=True, help="filtered BAM")
    f.add_argument("--min-depth", type=int, default=0,
                   help="drop consensus with max depth (cD) below this")
    f.add_argument("--min-min-depth", type=int, default=0,
                   help="drop consensus with min positive depth (cM) below this")
    f.add_argument("--min-mean-qual", type=float, default=0.0,
                   help="drop consensus whose mean base quality is below this")
    f.add_argument("--mask-qual", type=int, default=0,
                   help="mask bases below this quality to N (qual 2)")
    f.add_argument("--min-base-depth", type=int, default=0,
                   help="mask bases whose per-base depth (cd, from call "
                   "--per-base-tags) is below this")
    f.add_argument("--max-n-frac", type=float, default=1.0,
                   help="drop consensus with more than this fraction of N bases "
                   "(after masking)")
    f.add_argument("--max-base-error-rate", type=float, default=1.0,
                   help="mask bases whose disagreeing-read fraction (ce/cd) exceeds this")
    f.add_argument("--max-read-error-rate", type=float, default=1.0,
                   help="drop consensus whose whole-read ce/cd fraction exceeds this")
    f.add_argument("--chunk-records", type=int, default=200_000)

    x = sub.add_parser("index", help="index a coordinate-sorted BAM")
    x.add_argument("input", help="coordinate-sorted BAM")
    x.add_argument("-o", "--output", help="index path (default: input + .dlix/.bai/.csi)")
    x.add_argument("--every", type=int, default=100_000,
                   help="linear index: sampling stride in records")
    x.add_argument("--bai", action="store_true",
                   help="write the standard .bai binning index (SAM spec 5.2)")
    x.add_argument("--csi", action="store_true",
                   help="write the standard .csi index (needed past BAI's 2^29 limit)")

    vw = sub.add_parser("view", help="records overlapping a region, through the .bai/.csi "
                        "(built on demand)")
    vw.add_argument("input", help="coordinate-sorted BAM")
    vw.add_argument("region", help="REF[:BEG-END] (1-based inclusive); REF alone takes "
                    "the whole reference")
    vw.add_argument("-o", "--output", help="write matching records as BAM "
                    "(default: print a count summary)")
    vw.add_argument("--json", action="store_true", help="print the summary as JSON")

    st = sub.add_parser("stats", help="input metrics: family-size histogram, strand "
                        "balance, position-group stats")
    st.add_argument("input", help="input BAM (or ReadBatch .npz)")
    st.add_argument("--grouping", choices=["exact", "adjacency", "cluster"],
                    default="adjacency")
    st.add_argument("--duplex", action="store_true", help="paired UMI mode")
    st.add_argument("--json", action="store_true")

    v = sub.add_parser("validate", help="consensus error rate vs simulation truth")
    v.add_argument("consensus", help="consensus BAM from `call`")
    v.add_argument("--truth", required=True, help="truth npz from `simulate --truth`")
    v.add_argument("--json", action="store_true", help="print JSON instead of text")
    v.add_argument("--pos-window", type=int, default=0,
                   help="match records to same-UMI truth molecules within this many "
                   "bp when the exact-POS lookup misses (ref-projected output)")

    b = sub.add_parser("bench", help="run the reads/sec benchmark")
    b.add_argument("--reads", type=int, default=None)
    b.add_argument("--capacity", type=int, default=None)
    b.add_argument("--device", choices=["cuda", "cpu"], default=None,
                   help="where the bench runs (default cuda; cpu runs every kernel's "
                   "plain version)")

    g = sub.add_parser("group", help="annotate reads with MI molecule ids without calling "
                       "consensus (the UmiGrouper operator; GroupReadsByUmi)")
    g.add_argument("input", help="input BAM")
    g.add_argument("-o", "--output", required=True, help="annotated BAM")
    g.add_argument("--grouping", choices=["exact", "adjacency", "cluster"],
                   default="adjacency")
    g.add_argument("--max-hamming", type=int, default=1)
    g.add_argument("--count-ratio", type=int, default=2,
                   help="directional edge condition count(a) >= ratio*count(b)-1")
    g.add_argument("--mate-aware", choices=["auto", "on", "off"], default="auto",
                   help="the same mate handling as call: MI carries the source "
                   "molecule (a template's R1 and R2 share it)")
    g.add_argument("--backend", choices=["cuda", "cpu"], default="cuda",
                   help="cuda: batched group_kernel launches on --device; cpu: the oracle")
    g.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    g.add_argument("--duplex", action="store_true",
                   help="duplex inputs: MI values carry the /A or /B strand suffix")
    g.add_argument("--capacity", type=int, default=2048,
                   help="bucket read capacity for the device grouping path")
    g.add_argument("--umi-whitelist", default=None,
                   help="expected-UMI list (same semantics as call --umi-whitelist)")
    g.add_argument("--umi-max-mismatches", type=int, default=1,
                   help="whitelist correction distance bound")
    g.add_argument("--json", action="store_true", help="print summary as JSON")
    return p


def params_for(config: str):
    """(GroupingParams, ConsensusParams, capacity) of a preset, with the
    JAX CLI's defaults for everything the preset leaves open."""
    from duplexumiconsensusreads_torch.types import ConsensusParams, GroupingParams

    pre = CONFIG_PRESETS[config]
    duplex = pre["mode"] == "duplex"
    gp = GroupingParams(strategy=pre["grouping"], paired=duplex)
    cp = ConsensusParams(
        mode="duplex" if duplex else "single_strand",
        error_model=None if pre["error_model"] == "none" else pre["error_model"],
    )
    return gp, cp, pre.get("capacity", 2048)


def _load_config_file(path: str) -> dict:
    """TOML (.toml) or JSON call settings; keys are the knob names of
    runtime/knobs.py. Unknown keys are rejected: a typo must not fall
    back to a default."""
    if path.endswith(".toml"):
        import tomllib

        with open(path, "rb") as f:
            conf = tomllib.load(f)
    else:
        with open(path) as f:
            conf = json.load(f)
    allowed = set(knobs.config_file_keys())
    unknown = set(conf) - allowed
    if unknown:
        raise SystemExit(
            f"unknown config-file keys: {sorted(unknown)} "
            f"(allowed: {sorted(allowed)})"
        )
    return conf


def _refuse_streaming_only(args, resolved: dict) -> None:
    """The whole-file path's refuse-don't-drop gate, driven by the
    ``streaming_only`` surface of runtime/knobs.py: a knob is refused by
    its RESOLVED value, so a config-file key is refused exactly like the
    flag. Grouped knobs share one message naming all their flags;
    ``refuse_alone`` knobs each carry their own note."""
    grouped_flags = []
    grouped_hit = False
    for name in knobs.streaming_only_keys():
        k = knobs.KNOBS[name]
        if k.refuse_alone:
            continue
        grouped_flags.append(k.flag)
        if getattr(args, name) is not None or resolved[name] != k.default:
            grouped_hit = True
    if grouped_hit:
        raise SystemExit(
            "/".join(grouped_flags) + " require the streaming executor (--chunk-reads N)"
        )
    for name in knobs.streaming_only_keys():
        k = knobs.KNOBS[name]
        if not k.refuse_alone:
            continue
        if getattr(args, name) is not None or resolved[name] != k.default:
            raise SystemExit(
                f"{k.flag} requires the streaming executor "
                f"(--chunk-reads N){k.refuse_note}"
            )


def _load_whitelist_or_exit(path: str):
    """Every whitelist problem is a clean CLI error, never a traceback."""
    from duplexumiconsensusreads_torch.io.convert import load_umi_whitelist

    try:
        return load_umi_whitelist(path)
    except (OSError, ValueError) as e:
        raise SystemExit(f"--umi-whitelist: {e}")


def main(argv=None) -> int:
    args, unknown = build_parser().parse_known_args(argv)
    if unknown:
        raise SystemExit(f"not supported by the torch port: {' '.join(unknown)}")
    return {
        "call": _cmd_call, "simulate": _cmd_simulate, "validate": _cmd_validate,
        "index": _cmd_index, "filter": _cmd_filter, "stats": _cmd_stats,
        "bench": _cmd_bench, "group": _cmd_group, "view": _cmd_view,
    }[args.cmd](args)


def _spool_or_exit(args) -> str:
    import os

    spool = args.spool or os.environ.get("DUT_SPOOL")
    if not spool:
        raise SystemExit(
            "--submit/--status/--wait need a service spool directory: "
            "pass --spool DIR or set DUT_SPOOL"
        )
    return spool


def _client_verb(args) -> int:
    """``--status`` / ``--wait``: read the spool's journal and answer
    with the JAX CLI's output and exit codes. No input is read and no
    device is touched."""
    if args.status is not None and args.wait is not None:
        raise SystemExit("--status and --wait are mutually exclusive")
    from duplexumiconsensusreads_torch.serve import client

    spool = _spool_or_exit(args)
    if args.status is not None:
        st = client.status(spool, args.status)
    else:
        st = client.wait(spool, args.wait, timeout_s=args.wait_timeout)
    state = st.get("state")
    if args.json:
        # the machine contract: one normalized document on stdout,
        # nothing on stderr
        print(json.dumps(client.status_document(st), sort_keys=True))
        if st.get("timed_out"):
            return 3
        return 1 if state in _BAD_STATES else 0
    print(json.dumps(st, sort_keys=True))
    if "snapshot_seq" in st:
        # follow-mode jobs: the journal carries the per-chunk live counters
        print(f"[duplexumi] live: snapshot_seq={st['snapshot_seq']} "
              f"reads_emitted={st.get('reads_emitted', 0)}", file=sys.stderr)
    if state in ("rejected", "expired", "quarantined") and st.get("error"):
        kind = (
            "shed by admission control" if st.get("shed")
            else state if state in ("expired", "quarantined")
            else "rejected"
        )
        print(f"[duplexumi] job {st.get('job_id')} {kind}: {st['error']}", file=sys.stderr)
    if st.get("timed_out"):
        # distinct exit code: the job is not dead, the wait budget ran out
        detail = st.get("error") or (f"slices={st.get('slices')}" if "slices" in st else "")
        print(
            f"[duplexumi] --wait timed out after {args.wait_timeout}s; "
            f"job {st.get('job_id')} last journaled state: {state or 'unknown'}"
            + (f" ({detail})" if detail else ""),
            file=sys.stderr,
        )
        return 3
    return 1 if state in _BAD_STATES else 0


def _cmd_call(args) -> int:
    if args.status is not None or args.wait is not None:
        return _client_verb(args)
    if args.json:
        raise SystemExit("--json applies to --status/--wait")
    if args.input is None or args.output is None:
        raise SystemExit("call needs INPUT and -o OUTPUT (unless --status/--wait)")
    from duplexumiconsensusreads_torch.types import ConsensusParams, GroupingParams

    fileconf = _load_config_file(args.config_file) if args.config_file else {}
    preset = dict(CONFIG_PRESETS.get(args.config or fileconf.get("config"), {}))

    def opt(name, default):
        """Precedence: explicit flag (None = unset, so falsy values like
        --min-input-qual 0 are still explicit) > config file > preset >
        default. Value validity is checked separately."""
        v = getattr(args, name)
        if v is not None:
            return v
        if name in fileconf:
            return fileconf[name]
        if name in preset:
            return preset[name]
        return default

    grouping = opt("grouping", "exact")
    mode = opt("mode", "ss")
    error_model = opt("error_model", "none")
    capacity = opt("capacity", 2048)
    backend = opt("backend", "cuda")
    chunk_reads = opt("chunk_reads", 0)
    cycle_shards = opt("cycle_shards", 1)
    devices = opt("devices", None)
    max_inflight = opt("max_inflight", 4)
    drain_workers = opt("drain_workers", 2)
    if drain_workers < 1:
        raise SystemExit(f"--drain-workers must be >= 1 (got {drain_workers})")
    packed = opt("packed", "auto")
    prefetch_depth = opt("prefetch_depth", 2)
    bucket_ladder = opt("bucket_ladder", "off")
    mesh = opt("mesh", "auto")
    if mesh != "auto":
        # config-file values arrive as ints or strings; both normalise
        try:
            mesh = int(mesh)
        except (TypeError, ValueError):
            raise SystemExit(f"--mesh must be 'auto' or an int >= 1 (got {mesh!r})")
        if mesh < 1:
            raise SystemExit(f"--mesh must be >= 1 (got {mesh})")
        if devices is not None and devices != mesh:
            raise SystemExit(f"--mesh {mesh} conflicts with --devices {devices}")
    from duplexumiconsensusreads_torch.tuning import normalize_bucket_ladder

    try:
        ladder_norm = normalize_bucket_ladder(bucket_ladder)
    except ValueError as e:
        raise SystemExit(f"--bucket-ladder: {e}")
    if packed not in ("auto", "byte", "off"):
        raise SystemExit(
            f"invalid packed value {packed!r} (allowed: ['auto', 'byte', 'off'])"
        )
    if prefetch_depth < 1:
        raise SystemExit(f"--prefetch-depth must be >= 1 (got {prefetch_depth})")
    ingest_overlap = opt("ingest_overlap", "auto")
    if ingest_overlap not in ("auto", "on", "off"):
        raise SystemExit(
            f"invalid ingest_overlap value {ingest_overlap!r} "
            f"(allowed: ['auto', 'on', 'off'])"
        )
    follow = bool(opt("follow", False))
    finalize_on = str(opt("finalize_on", "eof"))
    # the structured domain is hand-validated: config-file values
    # bypass argparse and must fail here, before the run
    from duplexumiconsensusreads_torch.live import parse_finalize_on

    try:
        parse_finalize_on(finalize_on)
    except ValueError as e:
        raise SystemExit(f"--finalize-on: {e}")
    live_poll_s = float(opt("live_poll_s", 0.25))
    if live_poll_s <= 0:
        raise SystemExit(f"--live-poll-s must be > 0 (got {live_poll_s})")
    snapshot_chunks = int(opt("snapshot_chunks", 0))
    if snapshot_chunks < 0:
        raise SystemExit(f"--snapshot-chunks must be >= 0 (got {snapshot_chunks})")
    mate_aware = opt("mate_aware", "auto")
    max_reads = opt("max_reads", 0)
    if max_reads < 0:
        raise SystemExit(f"--max-reads must be >= 0 (got {max_reads})")
    per_base_tags = bool(opt("per_base_tags", False))
    read_group = str(opt("read_group_id", "A"))
    # a bad id would crash at record serialization or forge header
    # fields (a tab splices extra @RG columns): refuse before the run
    if not read_group or not all(33 <= ord(ch) <= 126 for ch in read_group):
        raise SystemExit(
            f"--read-group-id must be non-empty printable ASCII without "
            f"whitespace (got {read_group!r})"
        )
    write_index = bool(opt("write_index", False))
    if write_index and not args.output.endswith(".bam"):
        raise SystemExit("--write-index requires a .bam output path")
    ref_projected = bool(opt("ref_projected", False))
    if ref_projected:
        if args.input.endswith(".npz"):
            raise SystemExit(
                "--ref-projected requires BAM input (the .npz "
                "interchange carries no CIGARs)"
            )
        if chunk_reads > 0 or args.n_hosts > 0:
            raise SystemExit(
                "--ref-projected runs on the whole-file executor "
                "(omit --chunk-reads / --n-hosts)"
            )
    umi_whitelist = None
    wl_path = opt("umi_whitelist", None)
    umi_max_mismatches = int(opt("umi_max_mismatches", 1))
    if wl_path:
        if chunk_reads > 0 or args.n_hosts > 0:
            raise SystemExit(
                "--umi-whitelist runs on the whole-file executor "
                "(omit --chunk-reads / --n-hosts)"
            )
        umi_whitelist = _load_whitelist_or_exit(wl_path)

    if backend == "tpu":
        # a JAX package's config file may carry it
        raise SystemExit(
            "--backend tpu is the JAX package's; this package runs "
            "--backend cuda (the default, on --device) or --backend cpu"
        )
    # config-file values bypass argparse's choices; a typo must fail
    # loudly, not select a default behaviour
    resolved = {"grouping": grouping, "mode": mode, "error_model": error_model,
                "backend": backend, "mate_aware": mate_aware}
    for key, allowed in (
        ("grouping", {"exact", "adjacency", "cluster"}),
        ("mode", {"ss", "duplex"}),
        ("error_model", {"none", "cycle"}),
        ("backend", {"cuda", "cpu"}),
        ("mate_aware", {"auto", "on", "off"}),
    ):
        if resolved[key] not in allowed:
            raise SystemExit(
                f"invalid {key} value {resolved[key]!r} (allowed: {sorted(allowed)})"
            )
    if (args.config or fileconf.get("config")) and not preset:
        raise SystemExit(f"unknown config preset {args.config or fileconf.get('config')!r}")
    if capacity < 1:
        raise SystemExit(f"--capacity must be >= 1 (got {capacity})")
    if chunk_reads < 0:
        raise SystemExit(f"--chunk-reads must be >= 0 (got {chunk_reads})")

    if args.submit:
        return _submit(args, opt, dict(
            grouping=grouping, mode=mode, error_model=error_model, capacity=capacity,
            backend=backend, chunk_reads=chunk_reads, cycle_shards=cycle_shards,
            devices=devices, max_inflight=max_inflight, drain_workers=drain_workers,
            packed=packed, prefetch_depth=prefetch_depth, ingest_overlap=ingest_overlap,
            mesh=mesh, ladder_norm=ladder_norm, mate_aware=mate_aware,
            max_reads=max_reads, per_base_tags=per_base_tags, read_group=read_group,
            write_index=write_index, follow=follow, finalize_on=finalize_on,
            live_poll_s=live_poll_s, snapshot_chunks=snapshot_chunks,
            whole_file_only=bool(ref_projected or wl_path),
        ))
    if args.deadline is not None:
        raise SystemExit(
            "--deadline applies to --submit jobs (daemon default: "
            "serve.daemon --deadline)"
        )
    if args.shards is not None or args.shard_bytes is not None:
        raise SystemExit(
            "--shards/--shard-bytes apply to --submit jobs (the fleet "
            "fans the sub-jobs out and merges the shards)"
        )

    if args.trace and chunk_reads <= 0:
        raise SystemExit("--trace requires the streaming executor (--chunk-reads N)")
    if chunk_reads <= 0:
        _refuse_streaming_only(args, {
            "packed": packed, "prefetch_depth": prefetch_depth,
            # the ladder by its NORMALISED value, so a cosmetic "OFF"
            # cannot slip past
            "ingest_overlap": ingest_overlap, "mesh": mesh, "bucket_ladder": ladder_norm,
            "follow": follow, "finalize_on": finalize_on, "live_poll_s": live_poll_s,
            "snapshot_chunks": snapshot_chunks,
        })
    if args.heartbeat:
        if args.heartbeat < 0:
            raise SystemExit(f"--heartbeat must be > 0 seconds (got {args.heartbeat})")
        if chunk_reads <= 0:
            raise SystemExit("--heartbeat requires the streaming executor (--chunk-reads N)")
    plan = None
    if args.chaos:
        if chunk_reads <= 0:
            raise SystemExit("--chaos requires the streaming executor (--chunk-reads N)")
        from duplexumiconsensusreads_torch.runtime import faults

        try:
            plan = faults.FaultPlan.parse(args.chaos)
        except ValueError as e:
            raise SystemExit(f"--chaos: {e}")
    if chunk_reads <= 0:
        # the whole-file executor has no chunks to checkpoint, pipeline or
        # drain: these would be inert there, so they are refused
        set_ = [n for n, v in (("checkpoint", args.checkpoint), ("resume", args.resume or None))
                if v is not None]
        set_ += [n for n, v, d in (("max_inflight", max_inflight, 4),
                                   ("drain_workers", drain_workers, 2))
                 if getattr(args, n) is not None or v != d]
        if set_:
            raise SystemExit(
                "not supported by the torch port's whole-file call (needs "
                f"--chunk-reads N): {', '.join('--' + k.replace('_', '-') for k in set_)}"
            )
    elif backend != "cuda":
        raise SystemExit("--chunk-reads streaming requires --backend=cuda")
    if backend == "cpu" and args.device is not None:
        raise SystemExit("--device applies to --backend cuda (the cpu backend runs "
                         "the NumPy oracle on the host)")
    device = args.device or "cuda"

    gp = GroupingParams(
        strategy=grouping,
        max_hamming=opt("max_hamming", 1),
        count_ratio=opt("count_ratio", 2),
        paired=(mode == "duplex"),
    )
    cp = ConsensusParams(
        mode="duplex" if mode == "duplex" else "single_strand",
        min_reads=opt("min_reads", 1),
        min_duplex_reads=opt("min_duplex_reads", 1),
        max_qual=opt("max_qual", 90),
        max_input_qual=opt("max_input_qual", 50),
        min_input_qual=opt("min_input_qual", 0),
        error_model=None if error_model == "none" else error_model,
    )
    if args.n_hosts > 0:
        rep = _multihost(args, gp, cp, device, dict(
            capacity=capacity, chunk_reads=chunk_reads,
            n_devices=mesh if mesh != "auto" else devices, cycle_shards=cycle_shards,
            max_inflight=max_inflight, drain_workers=drain_workers,
            packed=packed, prefetch_depth=prefetch_depth,
            ingest_overlap=ingest_overlap, bucket_ladder=ladder_norm,
            profile_dir=args.profile, mate_aware=mate_aware, max_reads=max_reads,
            per_base_tags=per_base_tags, read_group=read_group,
            write_index=write_index, heartbeat_s=args.heartbeat, device=device,
        ))
        if rep is None:
            return 0
    elif chunk_reads > 0:
        from duplexumiconsensusreads_torch.runtime import faults
        from duplexumiconsensusreads_torch.runtime.stream import stream_call_consensus

        if plan is not None:
            # the explicit flag wins over a DUT_FAULTS export
            faults.install(plan)
        try:
            rep = stream_call_consensus(
                args.input, args.output, gp, cp,
                capacity=capacity, chunk_reads=chunk_reads,
                n_devices=mesh if mesh != "auto" else devices, cycle_shards=cycle_shards,
                max_inflight=max_inflight, drain_workers=drain_workers,
                checkpoint_path=args.checkpoint, resume=args.resume,
                report_path=args.report, profile_dir=args.profile,
                mate_aware=mate_aware, max_reads=max_reads,
                per_base_tags=per_base_tags, read_group=read_group,
                write_index=write_index, packed=packed,
                prefetch_depth=prefetch_depth, ingest_overlap=ingest_overlap,
                bucket_ladder=ladder_norm, trace_path=args.trace,
                heartbeat_s=args.heartbeat, follow=follow, finalize_on=finalize_on,
                live_poll_s=live_poll_s, snapshot_chunks=snapshot_chunks, device=device,
            )
        finally:
            if plan is not None:
                faults.uninstall()
    else:
        from duplexumiconsensusreads_torch.runtime.executor import call_consensus_file

        try:
            rep = call_consensus_file(
                args.input, args.output, gp, cp,
                capacity=capacity, report_path=args.report, mate_aware=mate_aware,
                max_reads=max_reads, per_base_tags=per_base_tags,
                read_group=read_group, write_index=write_index,
                ref_projected=ref_projected, umi_whitelist=umi_whitelist,
                umi_max_mismatches=umi_max_mismatches, device=device,
                backend=backend, profile_dir=args.profile,
                n_devices=devices, cycle_shards=cycle_shards,
            )
        except ValueError as e:
            # the whitelist/UMI length check runs inside the load
            if umi_whitelist is not None and "whitelist" in str(e):
                raise SystemExit(f"--umi-whitelist: {e}")
            raise
    pairs = f", {rep.n_consensus_pairs} R1+R2 pairs" if rep.mate_aware else ""
    print(
        f"[duplexumi-torch] {rep.n_valid_reads}/{rep.n_records} reads -> "
        f"{rep.n_consensus} consensus ({rep.n_molecules} molecules{pairs}, "
        f"{rep.n_buckets} buckets, backend={rep.backend}) on {rep.device}",
        file=sys.stderr,
    )
    return 0


def _multihost(args, gp, cp, device, stream_kw: dict):
    """``call --n-hosts N --host-id I``: this host's partition of the
    call (parallel/distributed.py), the JAX CLI's branch. The process
    joins the run's coordination store when MASTER_ADDR/MASTER_PORT,
    WORLD_SIZE and RANK are set (torchrun's environment, the port's
    counterparts of JAX_COORDINATOR_ADDRESS/NUM_PROCESSES/PROCESS_ID)
    and is a single-process emulation otherwise. Output, checkpoint,
    trace and report get the per-host suffix. Returns the run report,
    or None for an idle host."""
    if args.host_id is None:
        raise SystemExit("--n-hosts requires --host-id")
    if stream_kw["chunk_reads"] <= 0:
        raise SystemExit("multi-host mode streams: pass --chunk-reads")
    import os

    from duplexumiconsensusreads_torch.parallel.distributed import (
        init_distributed,
        multihost_call,
    )

    dist = init_distributed(auto=True, device=device)
    if dist["num_processes"] > 1:
        print(
            f"[duplexumi] distributed runtime: process "
            f"{dist['process_id']}/{dist['num_processes']}, "
            f"{dist['local_devices']} local / "
            f"{dist['global_devices']} global devices",
            file=sys.stderr,
        )
    # hosts share storage: a verbatim --output, --checkpoint, --trace or
    # --report path would have every host clobber one file ('-' stays
    # stdout, per-host by nature)
    base, ext = os.path.splitext(args.output)
    host_out = f"{base}.host{args.host_id}{ext or '.bam'}"
    suffix = f".host{args.host_id}"
    rep = multihost_call(
        args.input, host_out, gp, cp,
        index_path=args.index, process_id=args.host_id, num_processes=args.n_hosts,
        checkpoint_path=args.checkpoint + suffix if args.checkpoint else None,
        resume=args.resume,
        report_path=(args.report + suffix if args.report and args.report != "-"
                     else args.report),
        trace_path=args.trace + suffix if args.trace else None,
        **stream_kw,
    )
    if rep is None:
        print("[duplexumi] host has no records in range; idle", file=sys.stderr)
        return None
    print(f"[duplexumi] host output → {host_out}", file=sys.stderr)
    return rep


def _submit(args, opt, r: dict) -> int:
    """``call --submit``: spool the resolved call as a service job (the
    JAX CLI's checks and config, in its words). The job spec carries no
    device: the daemon that runs it owns its card."""
    if args.n_hosts > 0:
        raise SystemExit(
            "--submit jobs are single-host (each host runs its own "
            "daemon over its own partition); drop --n-hosts"
        )
    if r["whole_file_only"]:
        raise SystemExit(
            "--submit jobs run on the streaming executor; "
            "--ref-projected/--umi-whitelist are whole-file only"
        )
    if r["backend"] != "cuda":
        raise SystemExit("--submit jobs stream on --backend=cuda")
    if args.chunk_reads is not None and args.chunk_reads <= 0:
        raise SystemExit("--submit jobs stream: --chunk-reads must be >= 1")
    if args.priority < 0:
        raise SystemExit(f"--priority must be >= 0 (got {args.priority})")
    if args.deadline is not None and args.deadline <= 0:
        raise SystemExit(f"--deadline must be > 0 (got {args.deadline})")
    if args.shards is not None and args.shards < 1:
        raise SystemExit(f"--shards must be >= 1 (got {args.shards})")
    if args.shard_bytes is not None and args.shard_bytes < 1:
        raise SystemExit(f"--shard-bytes must be >= 1 (got {args.shard_bytes})")
    if args.shards is not None and args.shard_bytes is not None:
        raise SystemExit("--shards and --shard-bytes are mutually exclusive")
    if args.checkpoint or args.resume or args.report or args.profile:
        raise SystemExit(
            "--submit: --checkpoint/--resume/--report/--profile are "
            "owned by the service (results land in the spool's "
            "results/ dir; jobs always checkpoint and resume)"
        )
    if r["cycle_shards"] != 1 or r["devices"] is not None or args.heartbeat:
        raise SystemExit(
            "--submit: --cycle-shards/--devices/--heartbeat are "
            "daemon-side settings (see serve.daemon --devices/"
            "--heartbeat); jobs cannot carry them"
        )
    if args.device is not None:
        raise SystemExit(
            "--submit: --device is a daemon-side setting (the daemon owns "
            "its card: serve.daemon --device cuda|cpu); jobs cannot carry it"
        )
    from duplexumiconsensusreads_torch.serve import client

    spool = _spool_or_exit(args)
    chunk_reads = r["chunk_reads"]
    ladder = r["ladder_norm"]
    config = {
        "grouping": r["grouping"],
        "mode": r["mode"],
        "error_model": r["error_model"],
        "max_hamming": opt("max_hamming", 1),
        "count_ratio": opt("count_ratio", 2),
        "min_reads": opt("min_reads", 1),
        "min_duplex_reads": opt("min_duplex_reads", 1),
        "max_qual": opt("max_qual", 90),
        "max_input_qual": opt("max_input_qual", 50),
        "min_input_qual": opt("min_input_qual", 0),
        "capacity": r["capacity"],
        # unset/0 chunking takes the service default: a job must stream
        "chunk_reads": chunk_reads if chunk_reads > 0 else 500_000,
        "max_inflight": r["max_inflight"],
        "drain_workers": r["drain_workers"],
        "packed": r["packed"],
        "prefetch_depth": r["prefetch_depth"],
        "ingest_overlap": r["ingest_overlap"],
        "mesh": r["mesh"],
        "bucket_ladder": list(ladder) if isinstance(ladder, tuple) else ladder,
        "mate_aware": r["mate_aware"],
        "max_reads": r["max_reads"],
        "per_base_tags": r["per_base_tags"],
        "read_group_id": r["read_group"],
        "write_index": r["write_index"],
        "follow": r["follow"],
        "finalize_on": r["finalize_on"],
        "live_poll_s": r["live_poll_s"],
        "snapshot_chunks": r["snapshot_chunks"],
    }
    try:
        job_id = client.submit(
            spool, args.input, args.output, config=config, priority=args.priority,
            chaos=args.chaos, trace=args.trace, deadline_s=args.deadline,
            shards=args.shards, shard_bytes=args.shard_bytes,
        )
    except (ValueError, OSError) as e:
        raise SystemExit(f"--submit: {e}")
    print(job_id)  # stdout: the parseable handle for --status/--wait
    print(
        f"[duplexumi] job {job_id} spooled to {spool} (priority {args.priority}); "
        f"follow with `python -m duplexumiconsensusreads_torch call --wait {job_id} "
        f"--spool {spool}`",
        file=sys.stderr,
    )
    return 0


def _cmd_simulate(args) -> int:
    import numpy as np

    from duplexumiconsensusreads_torch.io import simulated_bam
    from duplexumiconsensusreads_torch.simulate import SimConfig

    cfg = SimConfig(
        n_molecules=args.molecules,
        read_len=args.read_len,
        umi_len=args.umi_len,
        n_positions=args.positions,
        mean_family_size=args.family_size,
        max_family_size=args.max_family_size,
        base_error=args.base_error,
        cycle_error_slope=args.cycle_error_slope,
        umi_error=args.umi_error,
        indel_error=args.indel_error,
        duplex=not args.single_strand,
        paired_reads=args.paired_reads,
        seed=args.seed,
    )
    _, recs, _, truth = simulated_bam(
        cfg, path=args.output, sort=args.sorted, paired_end=args.paired_end
    )
    if args.truth:
        extra = {}
        if truth.mol_seq2 is not None:
            extra["mol_seq2"] = truth.mol_seq2
        np.savez_compressed(
            args.truth,
            mol_seq=truth.mol_seq,
            mol_pos_key=truth.mol_pos_key,
            mol_umi=truth.mol_umi,
            read_mol=truth.read_mol,
            read_strand=truth.read_strand,
            duplex=np.bool_(cfg.duplex),
            **extra,
        )
    print(
        f"[duplexumi-torch] simulated {len(recs)} reads / {args.molecules} molecules "
        f"-> {args.output}",
        file=sys.stderr,
    )
    return 0


def _cmd_validate(args) -> int:
    import numpy as np

    from duplexumiconsensusreads_torch.io import read_bam
    from duplexumiconsensusreads_torch.io.bam import FLAG_READ2
    from duplexumiconsensusreads_torch.io.convert import (
        pack_pos_key,
        umi_string_to_codes,
        unpack_pos_key,
    )
    from duplexumiconsensusreads_torch.runtime.executor import count_consensus_pairs

    _, recs = read_bam(args.consensus)
    with np.load(args.truth) as z:
        mol_seq = z["mol_seq"]
        mol_pos_key = z["mol_pos_key"]
        mol_umi = z["mol_umi"]
        # paired-reads truth: consensus R2 records validate against end 2
        mol_seq2 = z["mol_seq2"] if "mol_seq2" in z.files else None

    # the truth pos_key is the simulator's raw key; the consensus BAM
    # re-packs it as (ref=0) << 36 | pos, so compare coordinates
    _, truth_pos = unpack_pos_key(pack_pos_key(np.zeros(len(mol_pos_key)), mol_pos_key))
    index = {}
    by_pos: dict = {}
    by_umi: dict = {}
    for m in range(len(mol_seq)):
        index[(int(truth_pos[m]), mol_umi[m].tobytes())] = m
        by_pos.setdefault(int(truth_pos[m]), []).append(m)
        by_umi.setdefault(mol_umi[m].tobytes(), []).append(m)

    # pass 1: exact matches + error rate
    n_match = n_err = n_base = 0
    unmatched_idx = []
    matched_mols: set = set()
    for i in range(len(recs)):
        codes = umi_string_to_codes(recs.umi[i])
        ub = codes.tobytes() if codes is not None else b""
        m = index.get((int(recs.pos[i]), ub))
        if m is None and args.pos_window > 0:
            # opt-in: the nearest same-UMI truth molecule within the
            # window (ref-projected records move POS); by default a
            # record at a wrong position stays loudly unmatched
            cand = [
                c for c in by_umi.get(ub, ())
                if abs(int(recs.pos[i]) - int(truth_pos[c])) <= args.pos_window
            ]
            if cand:
                m = min(cand, key=lambda c: abs(int(recs.pos[i]) - int(truth_pos[c])))
        if m is None:
            unmatched_idx.append((i, codes))
            continue
        matched_mols.add(m)
        n_match += 1
        l = int(recs.lengths[i])
        called = recs.seq[i, :l]
        is_r2 = bool(recs.flags[i] & FLAG_READ2)
        true_row = (mol_seq2 if (is_r2 and mol_seq2 is not None) else mol_seq)[m]
        # CIGAR-aware: walk M runs and compare at reference offsets;
        # inserted and beyond-truth bases have no truth to compare
        p0 = int(recs.pos[i]) - int(truth_pos[m])
        q = r = 0
        for nop, op in recs.cigars[i]:
            if op in "M=X":
                roff = p0 + r + np.arange(nop)
                sel = (roff >= 0) & (roff < len(true_row))
                qs = called[q : q + nop][sel]
                tr = true_row[roff[sel]]
                real = qs != 4
                n_err += int((qs[real] != tr[real]).sum())
                n_base += int(real.sum())
                q += nop
                r += nop
            elif op in ("I", "S"):
                q += nop
            elif op in ("D", "N"):
                r += nop

    # pass 2: classify every unmatched record
    #   position_miss  no truth molecule at this coordinate at all
    #   seed_mismatch  a truth molecule within Hamming<=1 exists whose
    #                  exact UMI was never reported (errored seed UMI)
    #   over_split     the nearest truth molecule (Hamming<=1) was ALSO
    #                  matched exactly: an extra molecule split off
    #   other          no truth UMI within Hamming<=1 at this position
    cls = {"position_miss": 0, "seed_mismatch": 0, "over_split": 0, "other": 0}
    for i, codes in unmatched_idx:
        mols = by_pos.get(int(recs.pos[i]))
        if not mols:
            cls["position_miss"] += 1
            continue
        c = codes if codes is not None else np.zeros(0, np.uint8)
        best_m, best_h = -1, 1 << 30
        for m in mols:
            t = mol_umi[m]
            h = int((t != c).sum()) if len(t) == len(c) else 1 << 30
            if h < best_h:
                best_h, best_m = h, m
        if best_h <= 1:
            if best_m in matched_mols:
                cls["over_split"] += 1
            else:
                cls["seed_mismatch"] += 1
        else:
            cls["other"] += 1

    rate = n_err / max(n_base, 1)
    out = {
        "n_consensus": len(recs),
        "n_consensus_pairs": count_consensus_pairs(recs),
        "n_matched_to_truth": n_match,
        "n_unmatched": len(unmatched_idx),
        "unmatched": cls,
        "n_bases": n_base,
        "n_errors": n_err,
        "error_rate": rate,
    }
    if args.json:
        print(json.dumps(out))
    else:
        print(
            f"[duplexumi-torch] {n_match}/{len(recs)} consensus matched to truth; "
            f"error rate {rate:.3e} ({n_err}/{n_base} bases); "
            f"{len(unmatched_idx)} unmatched ({cls['over_split']} over-split, "
            f"{cls['seed_mismatch']} seed-mismatch, "
            f"{cls['position_miss']} position-miss, {cls['other']} other)",
        )
    return 0


def _cmd_filter(args) -> int:
    """Streaming consensus post-filter (FilterConsensusReads analogue):
    record-level thresholds on the cD/cM depth stats and mean base
    quality, per-base masking to N by quality, per-base depth (cd) and
    per-base error rate (ce/cd). Streams in record chunks: filtering is
    per record."""
    import os
    import struct

    import numpy as np

    from duplexumiconsensusreads_torch.constants import BASE_N, NO_CALL_QUAL
    from duplexumiconsensusreads_torch.io import bgzf
    from duplexumiconsensusreads_torch.io.bam import (
        derive_output_header,
        iter_aux_fields,
        reorder_records,
        serialize_bam,
    )
    from duplexumiconsensusreads_torch.runtime.stream import (
        BamStreamReader,
        _empty_records,
        _records_from_raw,
    )

    int_fmt = {b"c": "<b", b"C": "<B", b"s": "<h", b"S": "<H", b"i": "<i", b"I": "<I"}
    b_dt = {b"c": "<i1", b"C": "<u1", b"s": "<i2", b"S": "<u2", b"i": "<i4", b"I": "<u4"}

    def aux_i(aux: bytes, tag: bytes) -> int | None:
        """Integer aux value of ``tag``, any BAM integer type (other
        writers store small depths as c/s). None when absent; raises on
        a malformed aux stream or a non-integer value, so a missing tag
        and a broken record are told apart."""
        try:
            for _s, t, typ, vstart, end in iter_aux_fields(aux):
                if end > len(aux):
                    raise ValueError("malformed aux stream: value past end")
                if t == tag:
                    fmt = int_fmt.get(typ)
                    if fmt is None:
                        raise ValueError(
                            f"aux tag {tag.decode()} has non-integer type {typ.decode()!r}"
                        )
                    return struct.unpack_from(fmt, aux, vstart)[0]
        except (IndexError, struct.error) as e:
            raise ValueError(f"malformed aux stream: {e}") from e
        return None

    def aux_b(a: bytes, tag: bytes):
        """Integer B-array value of ``tag`` (any int subtype); None if absent."""
        try:
            for _s, t, typ, vs, _e in iter_aux_fields(a):
                sub = a[vs : vs + 1]
                if t == tag and typ == b"B" and sub in b_dt:
                    (cnt,) = struct.unpack_from("<I", a, vs + 1)
                    return np.frombuffer(a, b_dt[sub], cnt, vs + 5)
        except (struct.error, KeyError, IndexError) as e:
            raise ValueError(f"malformed aux stream: {e}") from e
        return None

    reader = BamStreamReader(args.input)
    # record order is preserved, so the input SO stays truthful
    header = derive_output_header(reader.header, sort_order=None)
    shell = serialize_bam(header, _empty_records())
    n_in = n_kept = n_masked = n_no_tag = n_no_cd = n_no_ce = 0
    err_filters = args.max_base_error_rate < 1.0 or args.max_read_error_rate < 1.0
    need_mask = (args.mask_qual > 0 or args.min_mean_qual > 0 or args.max_n_frac < 1.0
                 or err_filters)
    try:
        with open(args.output, "wb") as out_f:
            out_f.write(bgzf.compress_fast(shell, eof=False))
            while True:
                raw = reader.read_raw_records(args.chunk_records)
                if raw is None:
                    break
                recs = _records_from_raw(header, raw)
                n = len(recs)
                n_in += n
                if need_mask:
                    lens = np.asarray(recs.lengths)
                    in_read = np.arange(recs.qual.shape[1])[None, :] < lens[:, None]
                if args.mask_qual > 0:
                    low = (recs.qual < args.mask_qual) & in_read
                    n_masked += int(low.sum())
                    recs.seq[low] = BASE_N
                    recs.qual[low] = NO_CALL_QUAL
                if args.min_base_depth > 0:
                    # shallow cycles go N first, so the later thresholds
                    # see the post-mask record
                    for i, a in enumerate(recs.aux_raw):
                        arr = aux_b(a, b"cd")
                        li = int(recs.lengths[i])
                        if arr is None or len(arr) < li:
                            # missing, or shorter than the read: skip the
                            # record's mask rather than kill the run
                            n_no_cd += 1
                            continue
                        shallow = np.zeros(recs.seq.shape[1], bool)
                        shallow[:li] = arr[:li] < args.min_base_depth
                        shallow &= recs.seq[i] != BASE_N  # count NEW masks
                        n_masked += int(shallow.sum())
                        recs.seq[i][shallow] = BASE_N
                        recs.qual[i][shallow] = NO_CALL_QUAL
                keep = np.ones(n, bool)
                if err_filters:
                    # fgbio's error-rate pair from the ce/cd arrays: base
                    # masking before max-n-frac; the read rate drops
                    for i, a in enumerate(recs.aux_raw):
                        cdv = aux_b(a, b"cd")
                        cev = aux_b(a, b"ce")
                        li = int(recs.lengths[i])
                        if cdv is None or cev is None or len(cdv) < li or len(cev) < li:
                            n_no_ce += 1
                            continue
                        d = cdv[:li].astype(np.int64)
                        e = cev[:li].astype(np.int64)
                        if args.max_read_error_rate < 1.0:
                            tot = int(d.sum())
                            if tot and int(e.sum()) > args.max_read_error_rate * tot:
                                keep[i] = False
                                continue
                        if args.max_base_error_rate < 1.0:
                            bad = np.zeros(recs.seq.shape[1], bool)
                            # e > rate*d: zero-depth cycles never divide
                            bad[:li] = e > args.max_base_error_rate * d
                            bad &= recs.seq[i] != BASE_N
                            n_masked += int(bad.sum())
                            recs.seq[i][bad] = BASE_N
                            recs.qual[i][bad] = NO_CALL_QUAL
                if args.min_depth > 0 or args.min_min_depth > 0:
                    # a tag is required only when its threshold is on;
                    # records missing it are dropped but counted
                    cd = np.empty(n, np.int64)
                    cm = np.empty(n, np.int64)
                    for i, a in enumerate(recs.aux_raw):
                        vd = aux_i(a, b"cD") if args.min_depth > 0 else 0
                        vm = aux_i(a, b"cM") if args.min_min_depth > 0 else 0
                        if vd is None or vm is None:
                            n_no_tag += 1
                            cd[i] = cm[i] = -1
                        else:
                            cd[i], cm[i] = vd, vm
                    keep &= cd >= args.min_depth
                    keep &= cm >= args.min_min_depth
                if args.min_mean_qual > 0:
                    qsum = (recs.qual * in_read).sum(axis=1)
                    keep &= qsum >= args.min_mean_qual * np.maximum(lens, 1)
                if args.max_n_frac < 1.0:
                    n_count = ((recs.seq == BASE_N) & in_read).sum(axis=1)
                    keep &= n_count <= args.max_n_frac * np.maximum(lens, 1)
                kept_idx = np.nonzero(keep)[0]
                n_kept += len(kept_idx)
                if len(kept_idx):
                    sub = recs if len(kept_idx) == n else reorder_records(recs, kept_idx)
                    payload = serialize_bam(header, sub)[len(shell):]
                    out_f.write(bgzf.compress_fast(payload, eof=False))
            out_f.write(bgzf.BGZF_EOF)
    except ValueError as e:
        # a malformed record must not leave a truncated, EOF-less BAM
        # behind for a later step to half-read
        try:
            os.remove(args.output)
        except OSError:
            pass
        raise SystemExit(f"[duplexumi-torch] filter: {e} (input record ~{n_in})")
    finally:
        reader.close()
    if n_no_tag:
        print(
            f"[duplexumi-torch] filter: WARNING: {n_no_tag} records lack a "
            "required depth tag and were dropped by the depth filter "
            "(input not produced by `call`?)",
            file=sys.stderr,
        )
    if n_no_cd:
        print(
            f"[duplexumi-torch] filter: WARNING: {n_no_cd} records lack a "
            "usable per-base cd array (absent or shorter than the read) and "
            "were left unmasked by --min-base-depth (run `call --per-base-tags` "
            "to emit cd)",
            file=sys.stderr,
        )
    if n_no_ce:
        print(
            f"[duplexumi-torch] filter: WARNING: {n_no_ce} records lack usable "
            "cd+ce per-base arrays and skipped the error-rate filters (run "
            "`call --per-base-tags` to emit both)",
            file=sys.stderr,
        )
    masks = args.mask_qual > 0 or args.min_base_depth > 0 or args.max_base_error_rate < 1.0
    print(
        f"[duplexumi-torch] filter: kept {n_kept}/{n_in} consensus reads"
        + (f", masked {n_masked} bases" if masks else ""),
        file=sys.stderr,
    )
    return 0


def _cmd_stats(args) -> int:
    """Input metrics from the oracle grouper (the GroupReadsByUmi metrics
    analogue): family/molecule counts, family-size histogram, duplex
    strand balance, position-group sizes."""
    import numpy as np

    from duplexumiconsensusreads_torch.io import load_input
    from duplexumiconsensusreads_torch.oracle import group_reads
    from duplexumiconsensusreads_torch.types import GroupingParams

    _, batch, info = load_input(args.input, duplex=args.duplex)
    fams = group_reads(batch, GroupingParams(strategy=args.grouping, paired=args.duplex))
    valid = np.asarray(batch.valid, bool)
    fam_id = np.asarray(fams.family_id)[valid]
    mol_id = np.asarray(fams.molecule_id)[valid]
    pos = np.asarray(batch.pos_key)[valid]
    strand = np.asarray(batch.strand_ab, bool)[valid]

    sizes = np.bincount(fam_id[fam_id >= 0])
    hist = {}
    prev = 1
    for e in (2, 3, 4, 5, 10, 20, 50, 100, 1000, 1 << 30):
        label = f"{prev}" if e == prev + 1 else f"{prev}-{e - 1}"
        hist[label] = int(((sizes >= prev) & (sizes < e)).sum())
        prev = e
    _, pg_sizes = np.unique(pos, return_counts=True)
    n_mol = int(fams.n_molecules)
    duplex_mols = 0
    duplex_size_hist: dict = {}
    duplex_yield: dict = {}
    if args.duplex and n_mol:
        ab = np.bincount(mol_id[strand], minlength=n_mol)
        ba = np.bincount(mol_id[~strand], minlength=n_mol)
        duplex_mols = int(((ab > 0) & (ba > 0)).sum())
        # CollectDuplexSeqMetrics-style: the (larger, smaller) per-strand
        # size pairs, and the share of molecules whose weaker strand
        # clears a min-reads bar
        hi = np.maximum(ab, ba)
        lo = np.minimum(ab, ba)
        pairs, cnts = np.unique(np.stack([hi, lo], axis=1), axis=0, return_counts=True)
        order = np.argsort(-cnts)[:20]  # top pairs; the tail is noise
        duplex_size_hist = {
            f"{int(pairs[o, 0])}+{int(pairs[o, 1])}": int(cnts[o]) for o in order
        }
        duplex_yield = {
            f"min_reads={k}": round(float((lo >= k).mean()), 4) for k in (1, 2, 3, 5)
        }
    out = {
        "n_records": info["n_records"],
        "n_valid_reads": int(valid.sum()),
        "n_families": int(fams.n_families),
        "n_molecules": n_mol,
        "mean_family_size": round(float(sizes.mean()), 3) if len(sizes) else 0,
        "max_family_size": int(sizes.max()) if len(sizes) else 0,
        "family_size_hist": hist,
        "n_position_groups": int(len(pg_sizes)),
        "max_position_group": int(pg_sizes.max()) if len(pg_sizes) else 0,
        "duplex_complete_molecules": duplex_mols,
        "duplex_family_size_hist": duplex_size_hist,
        "duplex_yield": duplex_yield,
        "grouping": args.grouping,
    }
    if args.json:
        print(json.dumps(out))
    else:
        for k, v in out.items():
            print(f"{k}: {v}")
    return 0


def _cmd_bench(args) -> int:
    import os

    if args.reads:
        os.environ["DUT_BENCH_READS"] = str(args.reads)
    if args.capacity:
        os.environ["DUT_BENCH_CAPACITY"] = str(args.capacity)
    from duplexumiconsensusreads_torch.benchmark import main as bench_main

    bench_main(device=args.device)
    return 0


def group_molecules(batch, gp, capacity: int, device, counters: dict):
    """The cuda backend of ``group``: per-read molecule ids of ``batch``
    (-1 where untagged), the molecule and family totals, the bucket
    count and the number of ``group_kernel`` launches.

    The batch is bucketed as ``call`` buckets it; buckets are grouped by
    (capacity, strategy, u_max), each bucket's u_max being the JAX
    package's ``min(pow2(n_unique), capacity)``, and each group is ONE
    batched ``group_kernel`` launch on ``device``. Bucket-local ids are
    then renumbered bucket by bucket in bucketing order, which is the
    JAX package's launch order, so the labels equal its ``group``'s."""
    import numpy as np
    import torch

    from duplexumiconsensusreads_torch.bucketing import build_buckets, stack_buckets
    from duplexumiconsensusreads_torch.bucketing.buckets import _pow2
    from duplexumiconsensusreads_torch.kernels.grouping import group_kernel
    from duplexumiconsensusreads_torch.runtime.executor import resolve_device

    dev = resolve_device(device)
    buckets = build_buckets(batch, capacity=capacity, grouping=gp, counters=counters)
    classes: dict = {}
    for i, bk in enumerate(buckets):
        key = (bk.capacity, "exact" if bk.preclustered else gp.strategy,
               min(_pow2(max(bk.n_unique_umi, 1)), bk.capacity))
        classes.setdefault(key, []).append(i)
    ids_of: list = [None] * len(buckets)
    n_fam_total = 0
    for (_, strategy, u_max), idx in classes.items():
        st = stack_buckets([buckets[i] for i in idx])

        def put(k):
            return torch.from_numpy(st[k]).to(dev)

        _, mids, pairs, n_fam, _, n_over = group_kernel(
            put("pos"), put("umi"), put("strand_ab"), put("frag_end"), put("valid"),
            strategy=strategy, max_hamming=gp.max_hamming, count_ratio=gp.count_ratio,
            paired=gp.paired, mate_aware=gp.mate_aware, u_max=u_max, presorted=True,
        )
        n_over = n_over.cpu().numpy()
        if n_over.any():
            # a production invariant (u_max >= a bucket's unique count),
            # checked so overflowed reads never drop from MI tagging
            j = int(np.argmax(n_over != 0))
            raise RuntimeError(
                f"group: {int(n_over[j])} reads overflowed u_max in a bucket "
                f"(capacity {buckets[idx[j]].capacity}); this is a bug in bucket "
                f"sizing — please report"
            )
        mids = mids.cpu().numpy()
        src = pairs.cpu().numpy() if gp.mate_aware else mids
        n_fam_total += int(n_fam.sum())
        for row, i in enumerate(idx):
            ids_of[i] = (mids[row], src[row])
    mol = np.full(len(np.asarray(batch.valid)), -1, np.int64)
    n_mol_total = 0
    for bk, (mids, ids) in zip(buckets, ids_of):
        sel = (bk.read_index >= 0) & bk.valid & (ids >= 0) & (mids >= 0)
        # bucket-local dense renumber of the chosen id space
        uniq, inv = np.unique(ids[sel], return_inverse=True)
        mol[bk.read_index[sel]] = inv + n_mol_total
        n_mol_total += len(uniq)
    return mol, n_mol_total, n_fam_total, len(buckets), len(classes)


def _cmd_group(args) -> int:
    """The UmiGrouper operator boundary at the CLI: annotate every
    groupable read with its molecule id (MI:Z), leaving the records
    otherwise untouched (fgbio GroupReadsByUmi). Duplex mode appends the
    /A or /B strand suffix. The cuda backend groups per position-tiled
    bucket exactly as ``call`` does (:func:`group_molecules`); MI labels
    equal the JAX package's ``group``. Two result-changing fallbacks
    (precluster of oversized position groups, jumbo hard cuts) are
    tallied as in ``call`` and reported when nonzero. Host memory holds
    the whole record set."""
    import numpy as np

    from duplexumiconsensusreads_torch.io.bam import (
        derive_output_header,
        make_aux_z,
        read_bam,
        strip_aux_tag,
        write_bam,
    )
    from duplexumiconsensusreads_torch.io.convert import records_to_readbatch
    from duplexumiconsensusreads_torch.oracle import group_reads
    from duplexumiconsensusreads_torch.runtime.executor import resolve_mate_aware
    from duplexumiconsensusreads_torch.types import GroupingParams

    if args.capacity < 1:
        raise SystemExit(f"--capacity must be >= 1 (got {args.capacity})")
    header, recs = read_bam(args.input)
    wl = _load_whitelist_or_exit(args.umi_whitelist) if args.umi_whitelist else None
    try:
        batch, info = records_to_readbatch(
            recs, duplex=args.duplex,
            umi_whitelist=wl, umi_max_mismatches=args.umi_max_mismatches,
        )
    except ValueError as e:
        if wl is not None and "whitelist" in str(e):
            raise SystemExit(f"--umi-whitelist: {e}")
        raise
    gp = GroupingParams(
        strategy=args.grouping,
        max_hamming=args.max_hamming,
        count_ratio=args.count_ratio,
        paired=args.duplex,
    )
    # the same auto-detection as call: MI reproduces the molecule
    # structure call consensuses on the same flags
    gp = resolve_mate_aware(gp, info, args.mate_aware)
    n = len(recs)
    counters: dict = {}
    launches = None
    if args.backend == "cpu":
        fams = group_reads(batch, gp)
        # MI carries the source molecule: pair_id under mate-aware
        # grouping (R1 and R2 units share it), else molecule_id
        mol = np.asarray(fams.pair_id if gp.mate_aware else fams.molecule_id).astype(np.int64)
        n_mol_total = int(mol.max()) + 1 if (mol >= 0).any() else 0
        n_fam_total = int(fams.n_families)
    else:
        mol, n_mol_total, n_fam_total, n_buckets, launches = group_molecules(
            batch, gp, args.capacity, args.device, counters)
    valid = np.asarray(batch.valid, bool)
    strand = np.asarray(batch.strand_ab, bool)
    tagged = valid & (mol >= 0)
    # strip stale MI from EVERY record: ids of another run on untagged
    # reads would collide with this run's molecule-id space
    for i in range(n):
        if b"MI" in recs.aux_raw[i]:
            recs.aux_raw[i] = strip_aux_tag(recs.aux_raw[i], "MI")
    for i in np.nonzero(tagged)[0]:
        mi = str(int(mol[i]))
        if args.duplex:
            mi += "/A" if strand[i] else "/B"
        recs.aux_raw[i] = recs.aux_raw[i] + make_aux_z("MI", mi)
    write_bam(args.output, derive_output_header(header, sort_order=None), recs)
    summary = {
        "n_records": len(recs),
        "n_tagged": int(tagged.sum()),
        "n_molecules": n_mol_total,
        "n_families": n_fam_total,
        "grouping": args.grouping,
        "backend": args.backend,
        "mate_aware": gp.mate_aware,
    }
    if launches is not None:
        summary.update(device=args.device, buckets=n_buckets, group_kernel_launches=launches)
    nonzero = {k: v for k, v in counters.items() if v}
    if nonzero:
        summary["fallbacks"] = nonzero
    if args.json:
        print(json.dumps(summary))
    else:
        print(
            f"[duplexumi-torch] {summary['n_tagged']}/{summary['n_records']} reads "
            f"tagged with MI across {summary['n_molecules']} molecules "
            f"({summary['n_families']} families, {args.grouping}) -> {args.output}",
            file=sys.stderr,
        )
    if nonzero:
        print(
            f"[duplexumi-torch] WARNING: result-changing grouping fallbacks fired: "
            f"{nonzero} — the MI partition may deviate from whole-file oracle "
            f"grouping (precluster can miss cross-piece merges; jumbo hard cuts "
            f"split molecules)",
            file=sys.stderr,
        )
    return 0


def _cmd_index(args) -> int:
    if args.bai and args.csi:
        raise SystemExit("--bai and --csi are mutually exclusive")
    if args.csi:
        from duplexumiconsensusreads_torch.io.csi import build_csi

        out = build_csi(args.input, args.output)
        print(f"[duplexumi-torch] wrote standard CSI -> {out}", file=sys.stderr)
        return 0
    if args.bai:
        from duplexumiconsensusreads_torch.io.bai import build_bai

        out = build_bai(args.input, args.output)
        print(f"[duplexumi-torch] wrote standard BAI -> {out}", file=sys.stderr)
        return 0
    from duplexumiconsensusreads_torch.io.index import INDEX_SUFFIX, build_linear_index

    out = args.output or args.input + INDEX_SUFFIX
    idx = build_linear_index(args.input, every=args.every)
    idx.save(out)
    print(
        f"[duplexumi-torch] indexed {idx.n_records} records "
        f"({len(idx.pos_key)} entries, every {idx.every}) -> {out}",
        file=sys.stderr,
    )
    return 0


def parse_region(region: str, header) -> tuple[int, int, int, str]:
    """samtools-style REF[:BEG-END] (1-based inclusive) -> (ref_id, beg,
    end, ref_name) with a 0-based half-open [beg, end). Reference names
    may themselves contain ':' (GRCh38 HLA alt contigs): the whole
    string is tried as a name first."""
    import re

    ref_name, g_beg, g_end = None, None, None
    if region in header.ref_names:
        ref_name = region
    else:
        m = re.fullmatch(r"(.+):(\d+)-(\d+)", region)
        if m and m.group(1) in header.ref_names:
            ref_name, g_beg, g_end = m.group(1), m.group(2), m.group(3)
    if ref_name is None:
        raise SystemExit(
            f"unknown reference in region {region!r} (want REF or "
            f"REF:BEG-END with REF from the header)"
        )
    ref_id = header.ref_names.index(ref_name)
    beg = int(g_beg) - 1 if g_beg else 0
    end = int(g_end) if g_end else header.ref_lengths[ref_id]
    if beg < 0 or end <= beg:
        raise SystemExit(f"bad region bounds in {region!r}")
    return ref_id, beg, end, ref_name


def region_records(path: str, header, ref_id: int, beg: int, end: int) -> list:
    """Rows of the records overlapping [beg, end) on ref_id, through the
    file's .bai, else its .csi, else one built now (BAI, or CSI when a
    contig exceeds BAI's 2^29 coordinate space): one seek to the
    query's start virtual offset, then a forward scan that stops at the
    first record starting at or past ``end`` (the file is
    coordinate-sorted). Each row is a tuple of one record's fields."""
    import os

    from duplexumiconsensusreads_torch.io.bai import query_start_voffset, read_bai
    from duplexumiconsensusreads_torch.runtime.executor import write_bam_index
    from duplexumiconsensusreads_torch.runtime.stream import (
        BamStreamReader,
        _records_from_raw,
    )

    bai_path, csi_path = path + ".bai", path + ".csi"
    if not os.path.exists(bai_path) and not os.path.exists(csi_path):
        print(f"[duplexumi-torch] building the index of {path}", file=sys.stderr)
        write_bam_index(path, header.ref_lengths)
    if os.path.exists(bai_path):
        start_v = query_start_voffset(read_bai(bai_path), ref_id, beg, end)
    else:
        from duplexumiconsensusreads_torch.io.csi import query_start_voffset_csi, read_csi

        start_v = query_start_voffset_csi(read_csi(csi_path), ref_id, beg, end)
    kept = []
    if start_v is None:
        return kept
    rdr = BamStreamReader(path, start=(start_v >> 16, start_v & 0xFFFF))
    try:
        while True:
            raw = rdr.read_raw_records(4096)
            if raw is None:
                break
            recs = _records_from_raw(header, raw)
            for i in range(len(recs)):
                rid, pos = int(recs.ref_id[i]), int(recs.pos[i])
                if rid != ref_id or pos >= end:
                    # rid < 0 is the unmapped tail, which sorts last
                    if rid < 0 or rid > ref_id or (rid == ref_id and pos >= end):
                        return kept  # sorted: nothing further overlaps
                    continue  # an earlier ref, or before the chunk floor
                span = sum(n for n, op in recs.cigars[i] if op in "MDN=X") or 1
                if pos + span > beg:
                    # copy the row out: keeping (recs, i) would pin each
                    # parsed batch with a hit until output time
                    li = int(recs.lengths[i])
                    kept.append((
                        recs.names[i], int(recs.flags[i]), rid, pos,
                        int(recs.mapq[i]), int(recs.next_ref_id[i]),
                        int(recs.next_pos[i]), int(recs.tlen[i]), li,
                        recs.seq[i, :li].copy(), recs.qual[i, :li].copy(),
                        recs.cigars[i], recs.umi[i], recs.aux_raw[i],
                    ))
    finally:
        rdr.close()
    return kept


def rows_to_records(kept):
    """BamRecords of region_records' rows."""
    import numpy as np

    from duplexumiconsensusreads_torch.constants import BASE_PAD
    from duplexumiconsensusreads_torch.io.bam import BamRecords

    l_max = max((k[8] for k in kept), default=0)

    def _pad(row, fill):
        out = np.full(l_max, fill, np.uint8)
        out[: len(row)] = row
        return out

    return BamRecords(
        names=[k[0] for k in kept],
        flags=np.array([k[1] for k in kept], np.uint16),
        ref_id=np.array([k[2] for k in kept], np.int32),
        pos=np.array([k[3] for k in kept], np.int32),
        mapq=np.array([k[4] for k in kept], np.uint8),
        next_ref_id=np.array([k[5] for k in kept], np.int32),
        next_pos=np.array([k[6] for k in kept], np.int32),
        tlen=np.array([k[7] for k in kept], np.int32),
        lengths=np.array([k[8] for k in kept], np.int32),
        seq=(np.stack([_pad(k[9], BASE_PAD) for k in kept])
             if kept else np.zeros((0, 0), np.uint8)),
        qual=(np.stack([_pad(k[10], 0) for k in kept])
              if kept else np.zeros((0, 0), np.uint8)),
        cigars=[k[11] for k in kept],
        umi=[k[12] for k in kept],
        aux_raw=[k[13] for k in kept],
    )


def _cmd_view(args) -> int:
    """Region query through the standard .bai/.csi: the consuming side
    of ``index --bai`` / ``call --write-index`` (samtools-view analogue)."""
    import json

    from duplexumiconsensusreads_torch.io.bam import derive_output_header, write_bam
    from duplexumiconsensusreads_torch.runtime.stream import BamStreamReader

    rdr = BamStreamReader(args.input)
    header = rdr.header
    rdr.close()
    ref_id, beg, end, ref_name = parse_region(args.region, header)
    kept = region_records(args.input, header, ref_id, beg, end)
    if args.output:
        write_bam(args.output, derive_output_header(header, sort_order=None),
                  rows_to_records(kept))
    summary = {"region": f"{ref_name}:{beg + 1}-{end}", "n_records": len(kept)}
    if args.json:
        print(json.dumps(summary))
    else:
        print(
            f"[duplexumi-torch] {summary['n_records']} records overlap {summary['region']}"
            + (f" -> {args.output}" if args.output else ""),
            file=sys.stderr,
        )
    return 0
