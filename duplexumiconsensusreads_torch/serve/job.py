"""Job specs: what a client submits and what a worker slice runs.

The JAX package's serve/job.py, copied with the imports rewritten;
the spec, its validation, ``job_params`` and ``serve_provenance`` are
the JAX package's, so a job file and its @PG line read the same for
both engines. The spec carries no device (the daemon's ``--device``
and ``--devices`` own it). ``mesh`` stays in the config, validated as
the JAX package validates it: "auto" is the daemon's device pool, an
int the lanes a slice shards over (checked against the pool only when
the slice runs). ``spec_signature`` keeps its
meaning as the job's bucket-geometry identity; here it keys the
worker's warm-signature count (serve/worker.py) instead of jit
programs.

A job is (input BAM → output path) plus a CONFIG dict holding the same
keys as the streaming ``call`` flags (underscored). The spec is
validated twice — at submission (a typo fails in the client, not hours
later in the daemon) and again at admission (the daemon never trusts
spooled bytes) — with the same function, so the two ends cannot drift.

Only STREAMING params are accepted: the service's whole preemption and
crash-recovery story is phrased over chunk boundaries, so a job must
run on the streaming executor (``chunk_reads > 0``). Whole-file-only
features (--ref-projected, --umi-whitelist) are rejected at submission.
"""

from __future__ import annotations

import dataclasses

from duplexumiconsensusreads_torch.runtime import knobs
from duplexumiconsensusreads_torch.types import ConsensusParams, GroupingParams

# config keys a job may carry, with the SAME defaults as cli/main.py's
# opt() resolution — a job submitted with an empty config must run the
# identical workload as a bare `call --chunk-reads` would. Derived from
# the knob registry (runtime/knobs.py): the job_config surface IS the
# declaration, so job.py and main.py cannot drift. Table order is the
# canonical @PG CL flag order serve_provenance emits.
CONFIG_DEFAULTS = knobs.job_config_defaults()

_CHOICES = knobs.job_choice_map()


@dataclasses.dataclass(frozen=True)
class JobSpec:
    """One validated consensus job."""

    job_id: str
    input: str
    output: str
    priority: int = 1  # lower = more urgent; FIFO within a class
    config: dict = dataclasses.field(default_factory=dict)
    chaos: str | None = None  # per-job fault schedule (faults.FaultPlan)
    trace: str | None = None  # per-job run-capture path
    # optional wall budget (seconds from ADMISSION, not from first
    # chunk): admission stamps a monotonic expiry on the journal entry,
    # the scheduler refuses to claim past it and a running slice aborts
    # at its next checkpoint boundary — terminal state "expired", with
    # the partial checkpoint preserved so a re-submitted job resumes
    deadline_s: float | None = None
    # scatter-gather sharding (serve/shard/): a PARENT job asks to be
    # split into K range sub-jobs (`shards`), or into sub-jobs of
    # roughly this many compressed input bytes each (`shard_bytes`);
    # the planner fans the sub-jobs across the fleet and a merge stage
    # splices their outputs into one BAM byte-identical to the same job
    # run unsharded. Mutually exclusive with each other and with
    # `shard` below.
    shards: int | None = None
    shard_bytes: int | None = None
    # planner-written SUB-JOB metadata (never client-set): the child's
    # half-open range on the parent's whole-file chunk grid — see
    # serve/shard/plan.py for the field contract
    shard: dict | None = None

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        return {k: v for k, v in d.items() if v not in (None, {})}


def validate_spec(d: dict) -> JobSpec:
    """Dict (from a client call or a spooled JSON file) → JobSpec.
    Raises ValueError naming the offending field; never half-accepts."""
    if not isinstance(d, dict):
        raise ValueError("job spec must be a JSON object")
    allowed_top = {"job_id", "input", "output", "priority", "config",
                   "chaos", "trace", "deadline_s", "shards",
                   "shard_bytes", "shard"}
    unknown = set(d) - allowed_top
    if unknown:
        raise ValueError(f"unknown job fields: {sorted(unknown)}")
    for field in ("job_id", "input", "output"):
        v = d.get(field)
        if not isinstance(v, str) or not v:
            raise ValueError(f"job {field!r} must be a non-empty string")
    priority = d.get("priority", 1)
    if not isinstance(priority, int) or isinstance(priority, bool) or priority < 0:
        raise ValueError(f"job priority must be an int >= 0 (got {priority!r})")
    config = d.get("config", {})
    if not isinstance(config, dict):
        raise ValueError("job config must be an object")
    unknown = set(config) - set(CONFIG_DEFAULTS)
    if unknown:
        raise ValueError(
            f"unknown job config keys: {sorted(unknown)} "
            f"(allowed: {sorted(CONFIG_DEFAULTS)})"
        )
    merged = {**CONFIG_DEFAULTS, **config}
    for key, allowed in _CHOICES.items():
        if merged[key] not in allowed:
            raise ValueError(
                f"invalid config {key} value {merged[key]!r} "
                f"(allowed: {sorted(allowed)})"
            )
    if not isinstance(merged["chunk_reads"], int) or merged["chunk_reads"] < 1:
        raise ValueError(
            "jobs run on the streaming executor: config chunk_reads "
            f"must be an int >= 1 (got {merged['chunk_reads']!r})"
        )
    for key in knobs.job_min_int_keys():
        if not isinstance(merged[key], int) or merged[key] < 1:
            raise ValueError(f"config {key} must be an int >= 1")
    mesh = merged["mesh"]
    if mesh != "auto" and (
        not isinstance(mesh, int) or isinstance(mesh, bool) or mesh < 1
    ):
        # the job's mesh size (devices its slices shard over): "auto" =
        # the daemon's device pool; an int is validated against the
        # pool only at slice time (submission hosts may not see the
        # daemon's devices)
        raise ValueError(
            f"config mesh must be 'auto' or an int >= 1 (got {mesh!r})"
        )
    ladder = _normalized_ladder(merged)  # raises ValueError on a bad value
    if isinstance(ladder, tuple) and ladder[-1] != merged["capacity"]:
        # an explicit ladder's top rung REPLACES the capacity in the
        # executor — but serve_provenance excludes bucket_ladder from
        # the @PG CL (tuner overrides must not change job bytes), so a
        # mismatched top rung would make the recorded '--capacity' a
        # lie and break the reproduce-from-provenance contract. Refuse
        # at submission like every other config error.
        raise ValueError(
            f"config bucket_ladder top rung {ladder[-1]} must equal "
            f"config capacity {merged['capacity']} (the top rung IS the "
            f"job's capacity; set them consistently)"
        )
    from duplexumiconsensusreads_torch.live.tail import parse_finalize_on

    try:
        # structured domain (eof | idle:<seconds> | marker), hand-
        # validated like mesh/bucket_ladder; the parser is shared with
        # the CLI so both surfaces reject exactly the same strings
        parse_finalize_on(merged["finalize_on"])
    except ValueError as e:
        raise ValueError(f"config finalize_on: {e}")
    lp = merged["live_poll_s"]
    if not isinstance(lp, (int, float)) or isinstance(lp, bool) or lp <= 0:
        raise ValueError(
            f"config live_poll_s must be a number > 0 (got {lp!r})"
        )
    sc = merged["snapshot_chunks"]
    if not isinstance(sc, int) or isinstance(sc, bool) or sc < 0:
        raise ValueError(
            f"config snapshot_chunks must be an int >= 0 (got {sc!r})"
        )
    chaos = d.get("chaos")
    if chaos is not None:
        if not isinstance(chaos, str) or not chaos:
            raise ValueError("job chaos must be a non-empty schedule string")
        from duplexumiconsensusreads_torch.runtime.faults import FaultPlan

        FaultPlan.parse(chaos)  # reject a bad schedule at submission
    trace = d.get("trace")
    if trace is not None and (not isinstance(trace, str) or not trace):
        raise ValueError("job trace must be a non-empty path")
    deadline_s = d.get("deadline_s")
    if deadline_s is not None:
        if (
            not isinstance(deadline_s, (int, float))
            or isinstance(deadline_s, bool)
            or deadline_s <= 0
        ):
            raise ValueError(
                f"job deadline_s must be a number > 0 (got {deadline_s!r})"
            )
        deadline_s = float(deadline_s)
    shards = d.get("shards")
    if shards is not None and (
        not isinstance(shards, int) or isinstance(shards, bool) or shards < 1
    ):
        raise ValueError(f"job shards must be an int >= 1 (got {shards!r})")
    shard_bytes = d.get("shard_bytes")
    if shard_bytes is not None and (
        not isinstance(shard_bytes, int)
        or isinstance(shard_bytes, bool)
        or shard_bytes < 1
    ):
        raise ValueError(
            f"job shard_bytes must be an int >= 1 (got {shard_bytes!r})"
        )
    if shards is not None and shard_bytes is not None:
        raise ValueError("job shards and shard_bytes are mutually exclusive")
    shard = d.get("shard")
    if shard is not None:
        if shards is not None or shard_bytes is not None:
            raise ValueError(
                "a shard sub-job cannot itself request sharding"
            )
        if not isinstance(shard, dict):
            raise ValueError("job shard metadata must be an object")
        missing = {"parent", "idx", "k", "chunk_base"} - set(shard)
        if missing:
            raise ValueError(
                f"job shard metadata lacks required keys: {sorted(missing)}"
            )
    if merged["follow"] and (
        shards is not None or shard_bytes is not None or shard is not None
    ):
        # shard planning walks the finished file to place byte-range
        # cut points; a growing input has no finished length to plan
        # over and no random access for sub-jobs to seek into
        raise ValueError(
            "a follow job cannot be sharded: byte-range planning "
            "requires the finished input file"
        )
    return JobSpec(
        job_id=d["job_id"],
        input=d["input"],
        output=d["output"],
        priority=priority,
        config=config,
        chaos=chaos,
        trace=trace,
        deadline_s=deadline_s,
        shards=shards,
        shard_bytes=shard_bytes,
        shard=shard,
    )


def _normalized_ladder(c: dict):
    """The config's bucket_ladder, NORMALISED ("auto" | "off" | rung
    tuple) — one helper shared by validation, job_params and
    spec_signature so a cosmetic variant ("AUTO", " 256 , 1024 ") can
    never bypass the verdict store or split the compile signature.
    Raises ValueError naming the field on an invalid value."""
    ladder = c["bucket_ladder"]
    if not isinstance(ladder, (str, list, tuple)):
        raise ValueError(
            f"config bucket_ladder must be 'auto', 'off' or a rung list "
            f"(got {ladder!r})"
        )
    from duplexumiconsensusreads_torch.tuning import normalize_bucket_ladder

    try:
        return normalize_bucket_ladder(ladder)
    except ValueError as e:
        raise ValueError(f"config bucket_ladder: {e}")


def job_params(spec: JobSpec):
    """(GroupingParams, ConsensusParams, stream kwargs) for one job —
    the serve-side mirror of cli/main.py's flag resolution."""
    c = {**CONFIG_DEFAULTS, **spec.config}
    gp = GroupingParams(
        strategy=c["grouping"],
        max_hamming=c["max_hamming"],
        count_ratio=c["count_ratio"],
        paired=(c["mode"] == "duplex"),
    )
    cp = ConsensusParams(
        mode="duplex" if c["mode"] == "duplex" else "single_strand",
        min_reads=c["min_reads"],
        min_duplex_reads=c["min_duplex_reads"],
        max_qual=c["max_qual"],
        max_input_qual=c["max_input_qual"],
        min_input_qual=c["min_input_qual"],
        error_model=None if c["error_model"] == "none" else c["error_model"],
    )
    kwargs = dict(
        capacity=c["capacity"],
        chunk_reads=c["chunk_reads"],
        max_inflight=c["max_inflight"],
        drain_workers=c["drain_workers"],
        packed=c["packed"],
        prefetch_depth=c["prefetch_depth"],
        ingest_overlap=c["ingest_overlap"],
        bucket_ladder=_normalized_ladder(c),
        # "auto" -> None: the worker resolves the mesh within its own
        # device pool (run_slice pops this key; it is not a
        # stream_call_consensus kwarg)
        mesh=None if c["mesh"] == "auto" else int(c["mesh"]),
        mate_aware=c["mate_aware"],
        max_reads=c["max_reads"],
        per_base_tags=bool(c["per_base_tags"]),
        read_group=str(c["read_group_id"]),
        write_index=bool(c["write_index"]),
        follow=bool(c["follow"]),
        finalize_on=str(c["finalize_on"]),
        live_poll_s=float(c["live_poll_s"]),
        snapshot_chunks=int(c["snapshot_chunks"]),
    )
    return gp, cp, kwargs


def serve_provenance(config: dict) -> str:
    """The deterministic @PG CL line for a service-run output: the
    equivalent ``duplexumi call`` CONFIG flags in canonical order, with
    no paths and no daemon argv. A one-shot output's CL records the
    invoking command line — but a service job's bytes must be a pure
    function of (input bytes, config): the same job must produce
    identical bytes whichever daemon (or daemon restart) finishes it,
    and two equal jobs writing different paths must still compare
    byte-identical. That is exactly the property the soak and
    crash-convergence tests are phrased over, so paths and argv are
    deliberately excluded."""
    parts = ["duplexumi", "call"]
    merged = {**CONFIG_DEFAULTS, **config}
    for key, default in CONFIG_DEFAULTS.items():  # canonical flag order
        val = merged[key]
        if val == default:
            continue
        if "provenance" not in knobs.KNOBS[key].surfaces:
            # surface membership is DECLARED, not hand-rolled here:
            # mesh / ingest_overlap / bucket_ladder carry their
            # why-excluded rationale on their KNOB_TABLE rows in
            # runtime/knobs.py, and the knob-taint rule holds this
            # loop to the declaration. (bucket_ladder is the only
            # list-capable config key, so every value below is a
            # scalar.)
            continue
        flag = "--" + key.replace("_", "-")
        if isinstance(val, bool):
            parts.append(flag)
        else:
            parts.extend([flag, str(val)])
    parts.append("[dut-serve]")
    return " ".join(parts)


def spec_signature(spec: JobSpec) -> str:
    """The job's COMPILE identity: the config subset that determines
    bucket geometry + pipeline spec (capacity, grouping strategy, mode,
    error model, per-base tags, and the bucket-ladder spec — each rung
    is its own dispatch-class capacity, so the ladder IS geometry). Two
    jobs sharing a signature share dispatch classes, so the second
    starts warm in the daemon — the amortisation the service exists to
    provide (in this package: the kernel libraries are loaded and the
    caching allocator already holds blocks of the classes' sizes, see
    serve/worker.py). "auto" jobs share the auto token: their resolved
    ladders come from the spool's verdict store, which maps one input
    profile to one ladder, so equal-profile jobs still share programs
    in practice."""
    c = {**CONFIG_DEFAULTS, **spec.config}
    try:
        ladder = _normalized_ladder(c)
    except ValueError:
        # a never-validated spec (direct construction): fall back to
        # the raw token — the signature must never raise
        ladder = c["bucket_ladder"]
    if isinstance(ladder, (list, tuple)):
        ladder = ",".join(str(x) for x in ladder)
    # mesh joins the identity, as in the JAX package (a job whose mesh
    # is not "auto" or 1 fails here before it warms anything)
    return "|".join(
        str(c[k])
        for k in ("capacity", "grouping", "mode", "error_model",
                  "per_base_tags")
    ) + f"|ladder={ladder}|mesh={c['mesh']}"
