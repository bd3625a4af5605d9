"""Profile-guided bucket auto-tuner: the bucket ladder and the
ssc-method race.

Every padded row the bucketer emits costs twice: once in the reduction
rows and once in wire bytes. This module turns the shape choice from a
hand-picked ``--capacity`` into a measured decision:

  profile pass   one cheap host-side scan of a chunk's position-group
                 size sequence (``group_sizes``) — the exact input the
                 bucketer packs, no device involved;
  cost model     candidate ladders are scored by SIMULATING the
                 bucketer's own packing on that sequence
                 (``ladder_cost`` runs the same DP
                 ``bucketing.buckets._ladder_partition`` uses, so the
                 prediction and the run can never disagree about how
                 reads would pack), plus per-bucket dispatch overhead,
                 per-rung dispatch-class overhead, and the stack-padding
                 multiple;
  verdict        a ledgered :class:`TunerVerdict` — the chosen ladder,
                 the stack-padding multiple it modelled, the ssc method
                 (filled in by the offline race), and the predicted fill
                 factors/speedup (tuning/store.py keeps verdicts
                 durably, one per input profile);
  micro race     ``race_ssc_methods`` times the FUSED pipeline per ssc
                 method on one device — tools/tune_ssc.py runs it
                 from the command line.

The functions, verdicts and error texts are the JAX package's
(tuning/tuner.py there), so both engines decide the same ladder on the
same reads. Verdicts are shape decisions ONLY: output bytes are
identical at every ladder (the executors' final (pos_key, UMI) sort
makes bytes a pure function of the read set).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time

import numpy as np

# NOTE: bucketing (and through it the torch kernel stack) is imported
# lazily inside ladder_cost, and the pipeline inside race_ssc_methods:
# validating a ladder value needs neither.

# Cost-model constants, in padded-row-equivalents. Each bucket costs a
# fixed host+dispatch overhead on top of its rows (stack/pack slices,
# per-bucket scatter bookkeeping); each distinct rung adds a dispatch
# class — an extra fused-pipeline call per chunk. Both are deliberately
# coarse: the model's job is to rank ladders on the dominant
# padded-rows term and stop rung proliferation from winning on noise,
# not to predict wall-clock.
BUCKET_OVERHEAD_ROWS = 64
CLASS_OVERHEAD_ROWS = 512

# auto mode proposes at most this many rungs (every rung past the first
# buys less and costs a dispatch class)
MAX_RUNGS = 3

# rungs below this are never proposed: the per-bucket overhead
# dominates a 16-row bucket's work
MIN_RUNG = 32

# the methods race_ssc_methods races by default: the kernel, the dense
# product and the two family-sorted reductions ("segment", the kernel's
# plain version, only when asked for)
RACE_METHODS = ("segment_gemm", "matmul", "blockseg", "runsum")


def validate_ladder(ladder) -> tuple:
    """Normalise + validate an explicit ladder: 1-4 strictly-ascending
    power-of-two rungs, each >= MIN_RUNG. Returns the tuple; raises
    ValueError naming the offence (shared by the CLI, the job-spec
    validator and the executors, so the three ends cannot drift)."""
    try:
        rungs = tuple(int(r) for r in ladder)
    except (TypeError, ValueError):
        raise ValueError(f"bucket ladder must be a list of ints, got {ladder!r}")
    if not 1 <= len(rungs) <= 4:
        raise ValueError(
            f"bucket ladder needs 1-4 rungs, got {len(rungs)} ({rungs})"
        )
    if list(rungs) != sorted(set(rungs)):
        raise ValueError(
            f"bucket ladder rungs must be strictly ascending, got {rungs}"
        )
    for r in rungs:
        if r < MIN_RUNG or r & (r - 1):
            raise ValueError(
                f"bucket ladder rungs must be powers of two >= {MIN_RUNG}, "
                f"got {r}"
            )
    return rungs


def normalize_bucket_ladder(value):
    """The ``--bucket-ladder`` setting in any of its carriers (CLI
    string, config-file/job-config string or int list, executor tuple)
    -> "auto" | "off" | validated rung tuple."""
    if value is None:
        return "off"
    if isinstance(value, str):
        v = value.strip().lower()
        if v in ("auto", "off"):
            return v
        parts = [p for p in v.replace(" ", "").split(",") if p]
        if not parts:
            raise ValueError(f"invalid bucket ladder {value!r}")
        try:
            return validate_ladder(int(p) for p in parts)
        except ValueError as e:
            raise ValueError(f"invalid bucket ladder {value!r}: {e}")
    if isinstance(value, (list, tuple)):
        return validate_ladder(value)
    raise ValueError(
        f"bucket ladder must be 'auto', 'off' or a rung list, got {value!r}"
    )


# ------------------------------------------------------------ profile pass

def group_sizes(batch) -> np.ndarray:
    """Valid-read position-group sizes of a chunk, in the ascending
    pos_key order the bucketer packs them — the profile pass. One
    np.unique over the valid pos_keys; no device, no second sort (the
    bucketer re-derives its own boundaries)."""
    valid = np.asarray(batch.valid, bool)
    pos = np.asarray(batch.pos_key)[valid]
    if len(pos) == 0:
        return np.zeros(0, np.int64)
    _, counts = np.unique(pos, return_counts=True)
    return counts.astype(np.int64)


def single_capacity_cost(
    sizes: np.ndarray, capacity: int, pack_mult: int = 1
) -> dict:
    """Padded-rows cost of the single-capacity packer on a group-size
    sequence (the tuner's "off" baseline): exactly the 1-rung ladder,
    which the DP pads like the legacy greedy (pinned by
    test_single_rung_matches_greedy_cost). ONE simulation of the
    packer's semantics on purpose — a second hand-rolled greedy here
    would have to mirror every flush/oversized rule (groups past the
    capacity take the escapes identically under every ladder and drop
    out of both sides of the comparison), and the two drifting apart
    would silently bias every auto verdict."""
    return ladder_cost(sizes, (int(capacity),), pack_mult)


def ladder_cost(
    sizes: np.ndarray, ladder: tuple, pack_mult: int = 1
) -> dict:
    """Padded-rows cost of a candidate ladder on a group-size sequence,
    via the SAME DP the bucketer runs (oversized groups flush the
    contiguous run exactly as the special paths do). Mesh stack-padding
    and dispatch-class overhead are modelled per RUNG as an
    approximation: each distinct rung's bucket count pads to a multiple
    of ``pack_mult`` with full-capacity empties and is charged one
    CLASS_OVERHEAD_ROWS. Real dispatch classes additionally key on
    (preclustered, pow2 unique-count), so one rung can split into
    several independently mesh-padded classes the model undercharges —
    a bias toward multi-rung ladders that grows with ``pack_mult``.
    Acceptable for a heuristic whose verdict is informational and whose
    byte-level effect is nil (bytes are ladder-invariant); revisit if
    fleet meshes (pack_mult > 1) start picking ladders the measured
    fill factors contradict."""
    from duplexumiconsensusreads_torch.bucketing.buckets import _ladder_partition

    capacity = ladder[-1]
    per_rung: dict[int, int] = {}
    real = 0
    seg = [0]

    def _flush():
        if len(seg) > 1:
            for a, b, cap in _ladder_partition(
                np.asarray(seg, np.int64), ladder
            ):
                per_rung[cap] = per_rung.get(cap, 0) + 1
        del seg[1:]

    for s in sizes:
        s = int(s)
        if s > capacity:
            _flush()
            continue
        real += s
        seg.append(seg[-1] + s)
    _flush()
    rows = 0
    n_b = 0
    mult = max(pack_mult, 1)
    for rung, cnt in per_rung.items():
        padded_cnt = cnt + ((-cnt) % mult)
        rows += padded_cnt * rung
        n_b += padded_cnt
    n_classes = max(len(per_rung), 1)
    return {
        "rows_padded": rows,
        "n_buckets": n_b,
        "rows_real": real,
        "cost": rows
        + BUCKET_OVERHEAD_ROWS * sum(per_rung.values())
        + CLASS_OVERHEAD_ROWS * n_classes,
    }


def candidate_ladders(capacity: int, max_rungs: int = MAX_RUNGS) -> list[tuple]:
    """Candidate ladders for a top capacity: every <=``max_rungs``
    subset of the pow2 sub-rungs capacity/2 .. max(MIN_RUNG,
    capacity/32), each ending at the capacity itself (the top rung must
    keep the oversized/jumbo escapes' boundary). The single-rung
    ``(capacity,)`` candidate IS the off baseline, so auto can
    legitimately conclude "one capacity was right"."""
    import itertools

    subs = []
    r = capacity // 2
    while r >= max(MIN_RUNG, capacity // 32):
        subs.append(r)
        r //= 2
    out = [(capacity,)]
    for k in range(1, max_rungs):
        for combo in itertools.combinations(subs, k):
            out.append(tuple(sorted(combo)) + (capacity,))
    return out


@dataclasses.dataclass(frozen=True)
class TunerVerdict:
    """One durable tuning decision for one input profile.

    ``ladder`` is the chosen rung tuple (length 1 = single-capacity —
    the tuner concluded the ladder buys nothing); ``pack_mult`` the
    mesh stack-padding multiple the cost model assumed; ``ssc_method``
    the raced reduction method (None until an offline
    ``tools/tune_ssc.py`` race fills it in — the executors then keep
    their per-backend default). Fill factors are real rows over padded
    row-slots as the cost model predicts them; ``source`` says whether
    the verdict came from the model alone or a timed race."""

    ladder: tuple
    capacity: int
    pack_mult: int = 1
    ssc_method: str | None = None
    fill_factor: float = 0.0
    fill_factor_off: float = 0.0
    predicted_speedup: float = 1.0
    n_reads: int = 0
    n_groups: int = 0
    source: str = "model"

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["ladder"] = list(self.ladder)
        return d

    @staticmethod
    def from_dict(d: dict) -> "TunerVerdict":
        known = {f.name for f in dataclasses.fields(TunerVerdict)}
        kw = {k: v for k, v in d.items() if k in known}
        kw["ladder"] = tuple(int(r) for r in kw.get("ladder", ()))
        return TunerVerdict(**kw)


def choose_ladder(
    sizes: np.ndarray,
    capacity: int,
    pack_mult: int = 1,
    max_rungs: int = MAX_RUNGS,
) -> TunerVerdict:
    """The auto verdict: score every candidate ladder on the profiled
    group-size sequence and keep the cheapest (the per-rung class
    overhead in the model is the anti-proliferation term — an extra
    rung must pay for its dispatch class in padded rows saved)."""
    base = single_capacity_cost(sizes, capacity, pack_mult)
    best_l: tuple = (capacity,)
    best = dict(base)
    for cand in candidate_ladders(capacity, max_rungs=max_rungs):
        if len(cand) == 1:
            continue  # == the base case by the DP's single-rung parity
        c = ladder_cost(sizes, cand, pack_mult)
        if c["cost"] < best["cost"]:
            best, best_l = c, cand
    def _fill(c):
        return round(c["rows_real"] / c["rows_padded"], 4) if c["rows_padded"] else 1.0
    return TunerVerdict(
        ladder=best_l,
        capacity=capacity,
        pack_mult=max(pack_mult, 1),
        fill_factor=_fill(best),
        fill_factor_off=_fill(base),
        predicted_speedup=round(base["cost"] / max(best["cost"], 1), 3),
        n_reads=int(np.asarray(sizes).sum()) if len(sizes) else 0,
        n_groups=int(len(sizes)),
        source="model",
    )


def profile_key(input_path: str, signature: str) -> str:
    """Stable key of one (input, geometry-signature) profile for a
    verdict store (tuning/store.py): the same input bytes under the same
    geometry-determining config always map to one verdict, so a fleet
    converges instead of re-profiling per daemon."""
    try:
        st = os.stat(input_path)
        ident = [os.path.abspath(input_path), st.st_size, int(st.st_mtime)]
    except OSError:
        ident = [os.path.abspath(input_path), -1, -1]
    key = json.dumps([ident, signature], sort_keys=True)
    return hashlib.sha256(key.encode()).hexdigest()[:16]


# ------------------------------------------------------------- micro race

def race_workload(
    n_molecules: int = 22_000,
    read_len: int = 150,
    n_positions: int = 460,
    capacity: int = 2048,
    seed: int = 7,
):
    """The race's input: (grouping, consensus params, valid reads,
    buckets) of a simulated config5 duplex batch (adjacency grouping,
    the cycle error model, min_duplex_reads 1) bucketed at
    ``capacity`` — so a caller can hold the methods' outputs against
    each other on the very buckets the race timed."""
    from duplexumiconsensusreads_torch.bucketing import build_buckets
    from duplexumiconsensusreads_torch.simulate import SimConfig, simulate_batch
    from duplexumiconsensusreads_torch.types import ConsensusParams, GroupingParams

    gp = GroupingParams(strategy="adjacency", paired=True)
    cp = ConsensusParams(mode="duplex", error_model="cycle", min_duplex_reads=1)
    cfg = SimConfig(
        n_molecules=n_molecules,
        read_len=read_len,
        n_positions=n_positions,
        mean_family_size=4,
        umi_error=0.01,
        duplex=True,
        seed=seed,
    )
    batch, _ = simulate_batch(cfg)
    n_reads = int(np.asarray(batch.valid).sum())
    return gp, cp, n_reads, build_buckets(batch, capacity=capacity, grouping=gp)


def race_ssc_methods(
    methods: tuple = RACE_METHODS,
    blockseg_ts: tuple = (128,),
    reps: int = 6,
    n_molecules: int = 22_000,
    read_len: int = 150,
    n_positions: int = 460,
    capacity: int = 2048,
    seed: int = 7,
    device="cuda",
) -> dict:
    """Timed fused-pipeline race over the ssc reduction methods on one
    device (the only honest scope: a method's cost depends on the
    pipeline around it). Each method's dispatch classes are built once
    from ``race_workload``'s buckets (``partition_buckets`` -> stacked
    tensors on the device), then ``fused_pipeline`` runs every class
    ``reps`` times; the step time is the best of two such rounds (the first
    round can absorb one-off allocator growth), closed by a device
    synchronize. ``blockseg`` runs once per tile height in
    ``blockseg_ts``. ``segment`` is the kernel's plain version (a
    row-by-row loop): it races only when named in ``methods``.

    ``device`` is "cuda" unless the caller asks for "cpu"; no card
    raises. Returns the JAX package's schema: ``{"backend" ("cuda" |
    "cpu"), "n_reads", "capacity", "reps", "methods": {label: {method,
    blockseg_t, step_s, reads_per_sec}}, "winner", "winner_method"}``."""
    import torch

    from duplexumiconsensusreads_torch.bucketing import stack_buckets
    from duplexumiconsensusreads_torch.interop import ARRAY_KEYS, stacked_from_numpy
    from duplexumiconsensusreads_torch.ops.pipeline import fused_pipeline
    from duplexumiconsensusreads_torch.runtime.executor import (
        partition_buckets,
        resolve_device,
    )

    dev = resolve_device(device)
    on_cuda = dev.type == "cuda"

    def sync():
        if on_cuda:
            torch.cuda.synchronize(dev)

    gp, cp, n_reads, buckets = race_workload(
        n_molecules, read_len, n_positions, capacity, seed
    )

    plans = []
    for m in methods:
        if m == "blockseg":
            plans.extend(("blockseg", t) for t in blockseg_ts)
        else:
            plans.append((m, None))

    rows: dict[str, dict] = {}
    with torch.no_grad():
        for method, t in plans:
            part = partition_buckets(buckets, gp, cp, method, blockseg_t=t)
            classes = []
            for cb, cspec in part:
                args = stacked_from_numpy(stack_buckets(cb, multiple_of=1), dev)
                classes.append((cspec, [args[k] for k in ARRAY_KEYS]))

            def run_all():
                return [fused_pipeline(*args, cspec) for cspec, args in classes]

            run_all()  # warm-up
            sync()
            dt = None
            for _ in range(2):
                t0 = time.monotonic()
                for _ in range(max(reps, 1)):
                    run_all()
                sync()
                d = (time.monotonic() - t0) / max(reps, 1)
                dt = d if dt is None else min(dt, d)
            label = method if t is None else f"{method}(T={t})"
            rows[label] = {
                "method": method,
                "blockseg_t": t,
                "step_s": round(dt, 4),
                "reads_per_sec": round(n_reads / dt, 1),
            }
            del classes
    winner = max(rows, key=lambda k: rows[k]["reads_per_sec"])
    return {
        "backend": dev.type,
        "n_reads": n_reads,
        "capacity": capacity,
        "reps": reps,
        "methods": rows,
        "winner": winner,
        "winner_method": rows[winner]["method"],
    }
