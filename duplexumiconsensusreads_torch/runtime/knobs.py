"""The execution-knob registry: every knob declared ONCE, as data.

A copy of the JAX package's runtime/knobs.py: the same table, in the
same order, with the same accessors (``tests/test_torch_cli.py`` holds
them equal), and the thread-confinement table ``THREAD_ROLES`` over
the threads the port starts (the same roles, entries and markers as
the JAX package's).

The load-bearing contract is that output bytes are a pure function of
(input, config). Which knobs join which determinism surface — the
checkpoint fingerprint, the compile ``spec_signature``, the ``@PG CL``
provenance line, the serve job config, the streaming-only CLI
refusals — is declared here once. The CLI (``cli/main.py``) derives
its ``--config-file`` keys and its whole-file refusals from the table.
``devices``, ``mesh`` and ``cycle_shards`` resolve as in the JAX
package, over parallel/mesh.py's device pool (the visible cards, or
logical CPU lanes).

``KNOB_TABLE`` and ``THREAD_ROLES`` are PURE LITERALS on purpose: the
lint rules read them from the parsed source with ``ast.literal_eval``,
without importing this module, so fixture corpora in tests can declare
their own miniature registries.

Per-knob fields:

- ``flag``: the CLI spelling (``cli/main.py`` dest = the table key).
- ``class``: ``"semantic"`` (changes output bytes — must be carried by
  every surface that replays or fingerprints the run) or
  ``"scheduling"`` (provably byte-neutral — throughput/topology only;
  MUST NOT reach the checkpoint fingerprint).
- ``surfaces``: membership in the determinism surfaces, the shipped
  behaviour stated as data:
    * ``fingerprint`` — joins the streaming checkpoint fingerprint
      (runtime/stream.py ``_fingerprint``); a resumed run must refuse
      a checkpoint written under different semantics.
    * ``spec_signature`` — joins the compile identity (serve/job.py
      ``spec_signature``): bucket geometry + pipeline spec.
    * ``provenance`` — recorded in the deterministic ``@PG CL`` line
      (serve/job.py ``serve_provenance``). Scheduling knobs the daemon
      may resolve/override per slice (mesh, ingest_overlap,
      bucket_ladder) are excluded: embedding them would make job bytes
      depend on serving topology / tuner state, breaking
      bytes == f(input, config). Client-verbatim scheduling knobs
      (drain_workers, max_inflight, packed, prefetch_depth) stay in —
      they reproduce the submitted command faithfully and are
      byte-neutral by the A/B matrix.
    * ``job_config`` — a key of the serve job config
      (serve/job.py ``CONFIG_DEFAULTS`` is derived from this table).
    * ``streaming_only`` — meaningless on the whole-file executor; the
      CLI refuses it there (refuse-don't-drop), resolved-value
      semantics: a config-file key is refused exactly like the flag.
- ``default``: the job-config default (CLI defaults match except
  ``chunk_reads``, whose CLI default 0 means "whole file").
- ``choices`` / ``min_int``: value domain, where closed/bounded.
- ``stream_kwarg``: the ``stream_call_consensus`` parameter name when
  it differs from the knob name (``read_group_id`` -> ``read_group``).
- ``via``: ``"params"`` marks knobs that reach the fingerprint through
  ``dataclasses.asdict(GroupingParams/ConsensusParams)`` rather than
  as a named ``_fingerprint`` argument.
- ``refuse_alone`` / ``refuse_note``: streaming-only refusal grouping
  (knobs without ``refuse_alone`` share one combined message).
"""

from __future__ import annotations

import dataclasses

# the determinism surfaces a knob can belong to (see module docstring)
SURFACES = (
    "fingerprint",
    "spec_signature",
    "provenance",
    "job_config",
    "streaming_only",
)

# NOTE: dict order is load-bearing — serve/job.py's CONFIG_DEFAULTS
# and the canonical @PG CL flag order are derived from it.
KNOB_TABLE = {
    "grouping": {
        "flag": "--grouping",
        "class": "semantic",
        "surfaces": ("fingerprint", "spec_signature", "provenance",
                     "job_config"),
        "default": "exact",
        "choices": ("exact", "adjacency", "cluster"),
        "via": "params",
    },
    "mode": {
        "flag": "--mode",
        "class": "semantic",
        "surfaces": ("fingerprint", "spec_signature", "provenance",
                     "job_config"),
        "default": "ss",
        "choices": ("ss", "duplex"),
        "via": "params",
    },
    "error_model": {
        "flag": "--error-model",
        "class": "semantic",
        "surfaces": ("fingerprint", "spec_signature", "provenance",
                     "job_config"),
        "default": "none",
        "choices": ("none", "cycle"),
        "via": "params",
    },
    "max_hamming": {
        "flag": "--max-hamming",
        "class": "semantic",
        "surfaces": ("fingerprint", "provenance", "job_config"),
        "default": 1,
        "via": "params",
    },
    "count_ratio": {
        "flag": "--count-ratio",
        "class": "semantic",
        "surfaces": ("fingerprint", "provenance", "job_config"),
        "default": 2,
        "via": "params",
    },
    "min_reads": {
        "flag": "--min-reads",
        "class": "semantic",
        "surfaces": ("fingerprint", "provenance", "job_config"),
        "default": 1,
        "via": "params",
    },
    "min_duplex_reads": {
        "flag": "--min-duplex-reads",
        "class": "semantic",
        "surfaces": ("fingerprint", "provenance", "job_config"),
        "default": 1,
        "via": "params",
    },
    "max_qual": {
        "flag": "--max-qual",
        "class": "semantic",
        "surfaces": ("fingerprint", "provenance", "job_config"),
        "default": 90,
        "via": "params",
    },
    "max_input_qual": {
        "flag": "--max-input-qual",
        "class": "semantic",
        "surfaces": ("fingerprint", "provenance", "job_config"),
        "default": 50,
        "via": "params",
    },
    "min_input_qual": {
        "flag": "--min-input-qual",
        "class": "semantic",
        "surfaces": ("fingerprint", "provenance", "job_config"),
        "default": 0,
        "via": "params",
    },
    "capacity": {
        "flag": "--capacity",
        "class": "semantic",
        "surfaces": ("fingerprint", "spec_signature", "provenance",
                     "job_config"),
        "default": 2048,
        "min_int": 1,
    },
    "chunk_reads": {
        # semantic: chunk boundaries name the emitted consensus
        # records (cons<tag><chunk> ids), so different chunking is
        # different bytes. Job default 500_000 (a job MUST stream);
        # the CLI's own default is 0 = whole file, validated with a
        # dedicated streaming message — hence no min_int here.
        "flag": "--chunk-reads",
        "class": "semantic",
        "surfaces": ("fingerprint", "provenance", "job_config"),
        "default": 500_000,
    },
    "max_inflight": {
        "flag": "--max-inflight",
        "class": "scheduling",
        "surfaces": ("provenance", "job_config"),
        "default": 4,
        "min_int": 1,
    },
    "drain_workers": {
        "flag": "--drain-workers",
        "class": "scheduling",
        "surfaces": ("provenance", "job_config"),
        "default": 2,
        "min_int": 1,
    },
    "packed": {
        "flag": "--packed",
        "class": "scheduling",
        "surfaces": ("provenance", "job_config", "streaming_only"),
        "default": "auto",
        "choices": ("auto", "byte", "off"),
    },
    "prefetch_depth": {
        "flag": "--prefetch-depth",
        "class": "scheduling",
        "surfaces": ("provenance", "job_config", "streaming_only"),
        "default": 2,
        "min_int": 1,
    },
    "ingest_overlap": {
        # provenance-EXCLUDED: the producer pipeline provably cannot
        # change output bytes (the producer emits in chunk order, so
        # the consumer sees the sync path's exact sequence) — a @PG CL
        # carrying it would make job bytes depend on how a daemon
        # chose to overlap its host work
        "flag": "--ingest-overlap",
        "class": "scheduling",
        "surfaces": ("job_config", "streaming_only"),
        "default": "auto",
        "choices": ("auto", "on", "off"),
    },
    "mesh": {
        # provenance-EXCLUDED: device count provably cannot change
        # output bytes (chunk order is commit order, pad buckets emit
        # nothing) and the daemon resolves "auto" against ITS pool — a
        # @PG CL carrying it would make job bytes depend on serving
        # topology. It DOES join spec_signature: GSPMD partitions the
        # same program differently per device count
        "flag": "--mesh",
        "class": "scheduling",
        "surfaces": ("spec_signature", "job_config", "streaming_only"),
        "default": "auto",
        "refuse_alone": True,
        "refuse_note": "; whole-file runs size the mesh with --devices",
    },
    "bucket_ladder": {
        # provenance-EXCLUDED: a shape knob that provably cannot
        # change output bytes (the executors' final sort makes bytes
        # a pure function of the read set), and the serve layer may
        # override it per slice from a tuner verdict — a @PG CL
        # carrying it would make job bytes depend on tuner state. It
        # DOES join spec_signature: each rung is its own
        # dispatch-class capacity, so the ladder IS geometry
        "flag": "--bucket-ladder",
        "class": "scheduling",
        "surfaces": ("spec_signature", "job_config", "streaming_only"),
        "default": "off",
        "refuse_alone": True,
    },
    "mate_aware": {
        "flag": "--mate-aware",
        "class": "semantic",
        "surfaces": ("fingerprint", "provenance", "job_config"),
        "default": "auto",
        "choices": ("auto", "on", "off"),
    },
    "max_reads": {
        "flag": "--max-reads",
        "class": "semantic",
        "surfaces": ("fingerprint", "provenance", "job_config"),
        "default": 0,
    },
    "per_base_tags": {
        "flag": "--per-base-tags",
        "class": "semantic",
        "surfaces": ("fingerprint", "spec_signature", "provenance",
                     "job_config"),
        "default": False,
    },
    "read_group_id": {
        "flag": "--read-group-id",
        "class": "semantic",
        "surfaces": ("fingerprint", "provenance", "job_config"),
        "default": "A",
        "stream_kwarg": "read_group",
    },
    "write_index": {
        # changes WHAT is produced (the .bai beside the output), not
        # the BAM bytes — carried by provenance/job_config, absent
        # from the fingerprint like every non-BAM-bytes knob
        "flag": "--write-index",
        "class": "semantic",
        "surfaces": ("provenance", "job_config"),
        "default": False,
    },
    # ---- live follow-mode knobs (live/): ALL scheduling-class and
    # fingerprint/spec_signature/provenance-EXCLUDED on purpose — they
    # steer WHEN input bytes become visible to the executor, never what
    # the executor computes from them. The chunk grid is pinned by
    # chunk_reads + the hold-back rule, so a follow run over the
    # finished file is byte-identical to the batch run (the A/B matrix
    # proves it), and a @PG CL carrying them would make job bytes
    # depend on how the input happened to arrive.
    "follow": {
        "flag": "--follow",
        "class": "scheduling",
        "surfaces": ("job_config", "streaming_only"),
        "default": False,
        "refuse_alone": True,
        "refuse_note": "; tailing a growing input requires the "
                       "streaming executor's chunk grid",
    },
    "finalize_on": {
        # structured domain (eof | idle:<seconds> | marker) hand-
        # validated like mesh/bucket_ladder — no closed choices tuple
        "flag": "--finalize-on",
        "class": "scheduling",
        "surfaces": ("job_config", "streaming_only"),
        "default": "eof",
    },
    "live_poll_s": {
        "flag": "--live-poll-s",
        "class": "scheduling",
        "surfaces": ("job_config", "streaming_only"),
        "default": 0.25,
    },
    "snapshot_chunks": {
        # 0 = no partial snapshots; N>0 publishes an indexed BAM
        # prefix every N committed chunks. Output-bytes-neutral: the
        # snapshot is a SIDE artifact (out + ".snapshot.bam"), the
        # final output bytes never depend on it
        "flag": "--snapshot-chunks",
        "class": "scheduling",
        "surfaces": ("job_config", "streaming_only"),
        "default": 0,
    },
    # ---- CLI-only execution knobs: resolvable via opt()/config file
    # but never part of a serve job (refused at --submit); empty
    # surface sets are the honest declaration, not an omission.
    "backend": {
        "flag": "--backend",
        "class": "scheduling",  # cpu/tpu outputs are byte-identical
        "surfaces": (),
        "default": "tpu",
        "choices": ("tpu", "cpu"),
    },
    "devices": {
        "flag": "--devices",
        "class": "scheduling",
        "surfaces": (),
        "default": None,
    },
    "cycle_shards": {
        "flag": "--cycle-shards",
        "class": "scheduling",
        "surfaces": (),
        "default": 1,
    },
    "ref_projected": {
        # whole-file executor only: changes bytes, but whole-file runs
        # have no checkpoint fingerprint and jobs refuse it
        "flag": "--ref-projected",
        "class": "semantic",
        "surfaces": (),
        "default": False,
    },
    "umi_whitelist": {
        "flag": "--umi-whitelist",
        "class": "semantic",
        "surfaces": (),
        "default": None,
    },
    "umi_max_mismatches": {
        "flag": "--umi-max-mismatches",
        "class": "semantic",
        "surfaces": (),
        "default": 1,
    },
    "config": {
        # the benchmark preset selector: expands to other knobs'
        # values, carries none of its own
        "flag": "--config",
        "class": "semantic",
        "surfaces": (),
        "default": None,
    },
}

# The declared thread-confinement model: every thread a port run starts
# has a row (the `thread-confinement` dutlint rule, analysis/rules.py,
# walks each entry's transitive same-file call graph against it;
# tests/test_torch_knobs.py maps the threads a real run starts onto
# the rows). Per role:
#
# - ``module``: corpus-path suffix holding the entry function.
# - ``entry``: the thread-entry function name; "" marks the main loop,
#   which is not walked — its row only declares OWNERSHIP, feeding the
#   per-module watched-name union that confines every other role.
# - ``marker``: the thread-name literal (Thread name= /
#   thread_name_prefix) pinning the role to a real thread; rename
#   protection — registry row present, entry function gone, marker
#   still in the module — is a finding, not a silent skip.
# - ``may``: permitted effect classes — "device" (torch.cuda.*, the
#   H2D/D2H, the fused pipeline and the kernel wrappers),
#   "durable" (checkpoint marks / durable writes), "journal" (flock'd
#   journal txns). Anything outside the tuple is a finding.
# - ``shared``: (structure, lock) pairs the role may touch; lock ""
#   means the structure is self-synchronizing (a Semaphore, a bounded
#   Queue). Touching a watched structure not listed, or listed but
#   outside `with <lock>:`, is a finding.
# - ``handoff``: the ONE queue the role may put to (producer roles).
THREAD_ROLES = {
    "main": {
        "module": "runtime/stream.py",
        "entry": "",
        "marker": "",
        "may": ("device", "durable", "journal"),
        "shared": (
            ("inflight", ""),
            ("done_q", ""),
            ("prefetch_sem", ""),
            ("ckpt", ""),
            ("drain", ""),
            ("xfer", ""),
            ("ingest_q", ""),
        ),
    },
    "xfer": {
        "module": "runtime/stream.py",
        "entry": "dispatch",
        "marker": "dut-xfer",
        "may": ("device",),
        "shared": (
            ("phase", "phase_lock"),
            ("rep", "phase_lock"),
            ("led", "phase_lock"),
            ("dev_pending", "phase_lock"),
            ("dev_compiled", "phase_lock"),
        ),
    },
    "drain": {
        # materialize re-dispatches on OOM retry (device) and
        # _finish_chunk -> _write_shard commits shards (durable), so
        # the drain lane legitimately holds both effect grants
        "module": "runtime/stream.py",
        "entry": "drain_chunk",
        "marker": "dut-drain",
        "may": ("device", "durable"),
        "shared": (
            ("phase", "phase_lock"),
            ("rep", "phase_lock"),
            ("led", "phase_lock"),
            ("dev_pending", "phase_lock"),
            ("dev_compiled", "phase_lock"),
            ("prefetch_sem", ""),
        ),
    },
    "ingest": {
        # the producer contract: pure host prep, no device, no
        # durable state, the bounded handoff queue is the only seam
        "module": "runtime/stream.py",
        "entry": "_ingest_producer",
        "marker": "dut-ingest",
        "may": (),
        "handoff": "ingest_q",
        "shared": (
            ("phase", "phase_lock"),
            ("ingest_q", ""),
            # the auto-ladder tuner verdict: _prep_chunk pins
            # rep.bucket_ladder ONCE on the first non-empty chunk — a
            # single GIL-atomic attribute write, before any consumer
            # reads the report, so it needs no lock
            ("rep", ""),
        ),
    },
    "heartbeat": {
        "module": "telemetry/trace.py",
        "entry": "_run",
        "marker": "dut-heartbeat",
        "may": (),
        "shared": (),
    },
    "live-tail": {
        # the follow-mode tailing producer (live/tail.py): pure host
        # I/O against the growing input — no device, no durable state
        # (the admission watermark is persisted by the main loop at
        # commit time), and the bounded admission queue is its only
        # output seam. Poll timing accrues in TailSource's own
        # lock-guarded counters; the consumer drains them into the
        # phase dict at chunk boundaries, so the tailer never touches
        # stream.py's shared state
        "module": "live/tail.py",
        "entry": "_tail_loop",
        "marker": "dut-live-tail",
        "may": (),
        "handoff": "_q",
        "shared": (),
    },
    "watchdog": {
        # reclaim/expiry sweeps move journal state through the flock'd
        # txn seam; instance-attribute structures (self.*) are rule 6
        # lock-discipline's jurisdiction, hence the empty shared list
        "module": "serve/service.py",
        "entry": "_watchdog_loop",
        "marker": "dut-watchdog",
        "may": ("journal", "durable"),
        "shared": (),
    },
    "serve-worker": {
        "module": "serve/service.py",
        "entry": "_worker_loop",
        "marker": "dut-serve",
        "may": ("device", "durable", "journal"),
        "shared": (),
    },
}


@dataclasses.dataclass(frozen=True)
class Knob:
    """One execution knob, hydrated from its KNOB_TABLE row."""

    name: str
    flag: str
    knob_class: str  # "semantic" | "scheduling"
    surfaces: tuple
    default: object
    choices: tuple | None = None
    min_int: int | None = None
    stream_kwarg: str | None = None
    via: str | None = None
    refuse_alone: bool = False
    refuse_note: str = ""

    @property
    def config_key(self) -> str:
        return self.name


def _build() -> dict:
    out = {}
    for name, row in KNOB_TABLE.items():
        cls = row["class"]
        if cls not in ("semantic", "scheduling"):
            raise ValueError(f"knob {name!r}: bad class {cls!r}")
        bad = set(row["surfaces"]) - set(SURFACES)
        if bad:
            raise ValueError(f"knob {name!r}: unknown surfaces {sorted(bad)}")
        out[name] = Knob(
            name=name,
            flag=row["flag"],
            knob_class=cls,
            surfaces=tuple(row["surfaces"]),
            default=row["default"],
            choices=tuple(row["choices"]) if "choices" in row else None,
            min_int=row.get("min_int"),
            stream_kwarg=row.get("stream_kwarg"),
            via=row.get("via"),
            refuse_alone=bool(row.get("refuse_alone", False)),
            refuse_note=row.get("refuse_note", ""),
        )
    return out


KNOBS: dict[str, Knob] = _build()


def knobs_on(surface: str) -> list[str]:
    """Knob names declaring ``surface``, in table (canonical) order."""
    if surface not in SURFACES:
        raise ValueError(f"unknown surface {surface!r}")
    return [k for k, knob in KNOBS.items() if surface in knob.surfaces]


def job_config_defaults() -> dict:
    """serve/job.py's CONFIG_DEFAULTS, derived: job-config knobs in
    table order (the canonical @PG CL flag order) with their
    defaults."""
    return {k: KNOBS[k].default for k in knobs_on("job_config")}


def job_choice_map() -> dict:
    """Closed value domains for job-config knobs (validate_spec's
    choices check; mesh/bucket_ladder have structured domains checked
    separately)."""
    return {
        k: set(KNOBS[k].choices)
        for k in knobs_on("job_config")
        if KNOBS[k].choices is not None
    }


def job_min_int_keys() -> tuple:
    """Job-config knobs requiring an int >= min_int (chunk_reads keeps
    its dedicated must-stream message in validate_spec)."""
    return tuple(
        k for k in knobs_on("job_config") if KNOBS[k].min_int is not None
    )


def streaming_only_keys() -> tuple:
    """Knobs the CLI refuses on the whole-file path, in table order."""
    return tuple(knobs_on("streaming_only"))


def config_file_keys() -> frozenset:
    """Keys accepted in a --config-file document: exactly the declared
    knobs (every execution knob is file-settable; run-control flags
    like --resume/--trace are not knobs and not file keys)."""
    return frozenset(KNOBS)
