"""Host-side bucketing: pack reads into fixed-shape device buckets.

This is the shape-static trick the north-star mandates ("families
bucketed by (genomic tile, family-size) to keep shapes static"): the
heavy-tailed family-size distribution never reaches XLA — every bucket
is a (R, L) padded tensor, compiled once per geometry.

Rules:
- reads are sorted by (pos_key, packed UMI) so whole position groups
  (and within them, whole exact families) stay contiguous;
- buckets are filled greedily with whole position groups (adjacency
  clustering is position-local, so a split position group would miss
  cluster merges);
- a position group larger than the capacity is handled WITHOUT changing
  results: in adjacency mode the group is preclustered on the host with
  the oracle's directional algorithm and its reads' UMIs are relabeled
  to the cluster seed, after which splitting at (relabeled) family
  boundaries is lossless under exact grouping — the kernel result then
  matches the oracle exactly no matter how large the group is;
- a single family larger than the capacity goes to its own "jumbo"
  bucket with a next-pow2 capacity (dispatched as its own size class),
  so consensus sees the whole family in one piece;
- each bucket records source read indices so outputs can be scattered
  back to the caller's order.

Bucket LADDERS (``ladder=`` — the profile-guided auto-tuner's lever,
see tuning/): instead of one global capacity, a run may carry 2-4 pow2
size classes, e.g. ``(256, 1024, 4096)``. Contiguous runs of position
groups are then partitioned by an exact DP that minimises total padded
row-slots over the ladder (``_ladder_partition``) — a long-tail group
mix stops forcing every bucket to the top rung's padding. The
partition NEVER changes results: buckets still hold whole position
groups, each bucket's geometry invariants (u_max/f_max sized from its
own n_unique) hold per rung because dispatch classes key on capacity,
and the executors' final (pos_key, UMI) sort makes output bytes a pure
function of the read set — byte-identical at ANY ladder (pinned by
tests/test_tuning.py's matrix). The top rung plays the old capacity's
role for the oversized-group and jumbo escapes.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np

from duplexumiconsensusreads_torch.constants import BASE_PAD
from duplexumiconsensusreads_torch.ops.grouper import dense_pos_ids
from duplexumiconsensusreads_torch.types import GroupingParams, ReadBatch
from duplexumiconsensusreads_torch.utils.phred import pack_umi_words64

# Host preclustering builds an nU x nU adjacency matrix; beyond this
# many unique UMIs in ONE position group (far past any real panel
# hotspot) fall back to the old family-boundary split with a warning.
PRECLUSTER_MAX_UNIQUE = 40_000


@dataclasses.dataclass
class Bucket:
    """One fixed-shape unit of device work (host NumPy arrays)."""

    pos: np.ndarray  # (R,) i32 bucket-local dense position ids
    umi: np.ndarray  # (R, B) u8
    strand_ab: np.ndarray  # (R,) bool
    frag_end: np.ndarray  # (R,) bool
    valid: np.ndarray  # (R,) bool
    bases: np.ndarray  # (R, L) u8
    quals: np.ndarray  # (R, L) u8
    read_index: np.ndarray  # (R,) i64 into the source batch; -1 = padding
    n_unique_umi: int  # unique (pos, UMI) pairs — must be <= u_max
    # True: UMIs were host-preclustered (relabeled to their directional
    # cluster seed); the dispatcher must run this bucket with exact
    # grouping so the device does not re-cluster relabeled seeds.
    preclustered: bool = False

    @property
    def capacity(self) -> int:
        return self.pos.shape[0]


def _empty_bucket(r: int, l: int, b: int) -> Bucket:
    return Bucket(
        pos=np.zeros(r, np.int32),
        umi=np.zeros((r, b), np.uint8),
        strand_ab=np.zeros(r, bool),
        frag_end=np.zeros(r, bool),
        valid=np.zeros(r, bool),
        bases=np.full((r, l), BASE_PAD, np.uint8),
        quals=np.zeros((r, l), np.uint8),
        read_index=np.full(r, -1, np.int64),
        n_unique_umi=0,
    )


def _fill_bucket(
    batch: ReadBatch,
    idx: np.ndarray,
    r: int,
    umi_override: np.ndarray | None = None,
    preclustered: bool = False,
    n_unique: int | None = None,
) -> Bucket:
    l, b = batch.read_len, batch.umi_len
    bk = _empty_bucket(r, l, b)
    n = len(idx)
    umi = umi_override if umi_override is not None else np.asarray(batch.umi)[idx]
    bk.pos[:n] = dense_pos_ids(np.asarray(batch.pos_key)[idx])
    bk.umi[:n] = umi
    bk.strand_ab[:n] = np.asarray(batch.strand_ab)[idx]
    bk.frag_end[:n] = np.asarray(batch.frag_end)[idx]
    bk.valid[:n] = np.asarray(batch.valid)[idx]
    bk.bases[:n] = np.asarray(batch.bases)[idx]
    bk.quals[:n] = np.asarray(batch.quals)[idx]
    bk.read_index[:n] = idx
    bk.preclustered = preclustered
    if n_unique is not None:
        # caller derived the unique-(pos, UMI) count from the chunk's
        # family-run boundaries — per-bucket pack+unique was a top host
        # cost at scale
        bk.n_unique_umi = n_unique
    else:
        key = np.column_stack(
            [np.asarray(batch.pos_key)[idx], pack_umi_words64(umi)]
        )
        bk.n_unique_umi = len(np.unique(key, axis=0))
    return bk


def _pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def _rung_for(n: int, ladder: tuple) -> int:
    """Smallest ladder rung holding ``n`` rows (ladder is ascending and
    its top rung bounds every caller's ``n`` by construction)."""
    for r in ladder:
        if n <= r:
            return r
    return ladder[-1]


# past this many position groups in one contiguous run, the ladder DP
# coalesces consecutive groups into blocks of up to min(ladder)//8 rows
# first — bucket boundaries then land on block edges, bounding the DP at
# O(reads/block * |ladder|) python steps for a worst waste of one block
# per bucket (<= 12.5% of the smallest rung)
_LADDER_DP_MAX_GROUPS = 4096


def _ladder_partition(
    bounds: np.ndarray, ladder: tuple
) -> list[tuple[int, int, int]]:
    """Partition a contiguous run of whole position groups into buckets
    drawn from ``ladder``, minimising total padded row-slots.

    ``bounds`` holds the groups' half-open offsets (len m+1, ascending);
    every single group fits the top rung (oversized groups took the
    precluster/jumbo escapes before this is called). Returns
    ``[(start, end, rung), ...]`` covering ``bounds[0]..bounds[-1]``.

    Exact DP: cost(i) = min over rungs r of cost(j_min(r, i)) + r where
    j_min is the earliest cut such that groups (j..i] fit r. Prefix
    costs are monotone (truncating a feasible packing stays feasible),
    so the earliest cut in each rung's window is optimal and a
    two-pointer per rung makes the whole thing O(m * |ladder|). The
    single-rung case degenerates to the classic greedy's cost, so a
    1-rung ladder pads exactly like the legacy single-capacity path.
    """
    if len(bounds) > _LADDER_DP_MAX_GROUPS + 1:
        block = max(min(ladder) // 8, 1)
        keep = [0]
        for i in range(1, len(bounds)):
            # close BEFORE a group that would overflow a non-empty
            # block: every coalesced block is then either <= `block`
            # rows or one single group (<= the top rung by the caller's
            # contract), so the DP below always stays feasible — a
            # block merging a partial run with a near-capacity group
            # could otherwise exceed every rung and leave cost(i)
            # unreachable
            if bounds[i] - bounds[keep[-1]] > block and i - 1 > keep[-1]:
                keep.append(i - 1)
        if keep[-1] != len(bounds) - 1:
            keep.append(len(bounds) - 1)
        bounds = bounds[np.asarray(keep)]
    m = len(bounds) - 1
    if m <= 0:
        return []
    inf = float("inf")
    cost = [0.0] + [inf] * m
    choice: list[tuple[int, int] | None] = [None] * (m + 1)
    jmin = [0] * len(ladder)
    b0 = int(bounds[0])
    for i in range(1, m + 1):
        hi = int(bounds[i])
        for ri, r in enumerate(ladder):
            j = jmin[ri]
            while hi - int(bounds[j]) > r:
                j += 1
            jmin[ri] = j
            if j < i and cost[j] + r < cost[i]:
                cost[i] = cost[j] + r
                choice[i] = (j, r)
    out: list[tuple[int, int, int]] = []
    i = m
    while i > 0:
        j, r = choice[i]  # type: ignore[misc]
        out.append((int(bounds[j]), int(bounds[i]), r))
        i = j
    out.reverse()
    assert out[0][0] == b0 and out[-1][1] == int(bounds[-1])
    return out


#: counter keys build_buckets increments when a RESULT-CHANGING
#: fallback fires (VERDICT r2: every deviation from oracle semantics
#: must be tallied, not just warned about)
FALLBACK_COUNTERS = (
    "n_precluster_fallback_groups",  # >PRECLUSTER_MAX_UNIQUE position groups
    "n_precluster_fallback_reads",  # reads in those groups
    "n_jumbo_hardcut_families",  # families split past the jumbo limit
    "n_jumbo_hardcut_splits",  # pieces emitted for them (each gets its
    # own consensus record — duplicates by oracle semantics)
)


def build_buckets(
    batch: ReadBatch,
    capacity: int,
    adjacency: bool = False,
    grouping: GroupingParams | None = None,
    counters: dict | None = None,
    ladder: tuple | None = None,
) -> list[Bucket]:
    """Pack a host ReadBatch into fixed-capacity buckets.

    ``grouping`` supplies the directional parameters used to
    host-precluster oversized position groups in adjacency mode; if
    omitted, UMI-tools defaults (Hamming<=1, count_ratio 2) are used.
    ``counters`` (a plain dict) is incremented with FALLBACK_COUNTERS
    whenever a result-changing fallback fires.

    ``ladder`` (ascending pow2 rung capacities whose top rung equals
    ``capacity``) switches the plain-bucket packer from the greedy
    single-capacity fill to the padded-rows-minimising DP over the
    rungs (see the module docstring); the oversized-group and jumbo
    escapes keep their ``capacity``-keyed behaviour, but the family
    runs they emit round up to the smallest fitting rung instead of
    always paying the top rung. Results are identical at any ladder.
    """
    if ladder is not None:
        ladder = tuple(int(r) for r in ladder)
        if len(ladder) < 1 or list(ladder) != sorted(set(ladder)):
            raise ValueError(f"ladder must be ascending distinct rungs, got {ladder}")
        if ladder[-1] != capacity:
            raise ValueError(
                f"ladder top rung {ladder[-1]} must equal capacity {capacity}"
            )
        if len(ladder) == 1:
            ladder = None  # degenerate: the classic single-capacity path
    if grouping is not None:
        adjacency = adjacency or grouping.strategy in ("adjacency", "cluster")
    valid = np.asarray(batch.valid, bool)
    idx_all = np.nonzero(valid)[0]
    if len(idx_all) == 0:
        return []
    pos = np.asarray(batch.pos_key)[idx_all]
    words = pack_umi_words64(np.asarray(batch.umi)[idx_all])  # any UMI length
    w = words.shape[1]
    order = None
    if w == 1 and len(pos) and (np.diff(pos) >= 0).all():
        # fast path for streaming chunks (pos already non-decreasing,
        # single-word UMIs): one packed-key argsort instead of a
        # multi-key lexsort. Dense pos ids come from run boundaries;
        # the UMI word's payload sits in the TOP 2*31 bits, so shift it
        # down to its true width before packing beside the dense id.
        dense = np.cumsum(np.r_[True, pos[1:] != pos[:-1]]) - 1
        u_bits = 2 * batch.umi_len
        if u_bits + int(dense[-1] + 1).bit_length() <= 63:
            keyv = (dense.astype(np.int64) << u_bits) | (
                words[:, 0] >> (62 - u_bits) if u_bits else 0
            )
            order = np.argsort(keyv, kind="stable")
    if order is None:
        order = np.lexsort((*[words[:, i] for i in range(w - 1, -1, -1)], pos))
    idx_sorted = idx_all[order]
    pos_s = pos[order]
    words_s = words[order]

    # position-group and family boundaries in sorted order
    n = len(idx_sorted)
    pos_start = np.nonzero(np.r_[True, pos_s[1:] != pos_s[:-1]])[0]
    fam_start = np.nonzero(
        np.r_[
            True,
            (pos_s[1:] != pos_s[:-1]) | (words_s[1:] != words_s[:-1]).any(axis=1),
        ]
    )[0]

    # plain buckets as contiguous [start, end, bucket_capacity) ranges
    # of idx_sorted — their unique-(pos, UMI) counts come from fam_start
    # (no per-bucket pack+unique, which was a top host cost at scale)
    ranges: list[tuple] = []
    # (idx, umi_override|None, capacity, preclustered, n_unique)
    special: list[tuple] = []
    cur_start = cur_end = 0
    # ladder mode: pending contiguous position-group bounds awaiting the
    # DP cut (offsets into idx_sorted; groups stay whole either way)
    pend: list[int] = []

    def flush():
        nonlocal cur_start, cur_end
        if ladder is not None:
            if len(pend) > 1:
                for a, b, cap in _ladder_partition(
                    np.asarray(pend, np.int64), ladder
                ):
                    ranges.append((a, b, cap))
            pend.clear()
            return
        if cur_end > cur_start:
            ranges.append((cur_start, cur_end, capacity))
            cur_start = cur_end

    # Jumbo buckets keep a whole >capacity family in one piece, but the
    # geometry must stay bounded (stack_buckets pads the class with
    # same-shape empties and XLA compiles per capacity): families past
    # 64x the base capacity are hard-cut with a warning, the bounded
    # behaviour the old splitter had.
    jumbo_max = capacity * 64

    def count(key, by=1):
        if counters is not None:
            counters[key] = counters.get(key, 0) + by

    def run_cap(n: int) -> int:
        # ladder mode: a family run of n rows pays the smallest rung
        # that holds it instead of the top capacity
        return capacity if ladder is None else _rung_for(n, ladder)

    def pack_family_runs(idx_g, bounds, umi_rows, preclustered):
        """Greedy-pack whole families (runs delimited by ``bounds``,
        local offsets into ``idx_g``) into capacity-sized buckets; a
        family larger than the capacity gets a jumbo pow2 bucket."""

        def emit(a, b, cap, n_uni):
            special.append(
                (
                    idx_g[a:b],
                    None if umi_rows is None else umi_rows[a:b],
                    cap,
                    preclustered,
                    n_uni,
                )
            )

        run_s = 0
        run_n = 0
        run_fi = 0
        for fi in range(len(bounds) - 1):
            fs, fe = int(bounds[fi]), int(bounds[fi + 1])
            fsize = fe - fs
            if fsize > jumbo_max:
                warnings.warn(
                    f"single UMI family of {fsize} reads exceeds the jumbo "
                    f"bucket limit {jumbo_max}; splitting the family "
                    "(consensus will emit one record per split)"
                )
                count("n_jumbo_hardcut_families")
                if run_n:
                    emit(run_s, fs, run_cap(fs - run_s), fi - run_fi)
                for cs in range(fs, fe, jumbo_max):
                    ce = min(cs + jumbo_max, fe)
                    count("n_jumbo_hardcut_splits")
                    emit(cs, ce, _pow2(ce - cs), 1)
                run_s, run_n, run_fi = fe, 0, fi + 1
                continue
            if fsize > capacity:
                if run_n:
                    emit(run_s, fs, run_cap(fs - run_s), fi - run_fi)
                emit(fs, fe, _pow2(fsize), 1)
                run_s, run_n, run_fi = fe, 0, fi + 1
                continue
            if run_n + fsize > capacity:
                emit(run_s, fs, run_cap(fs - run_s), fi - run_fi)
                run_s, run_n, run_fi = fs, 0, fi
            run_n += fsize
        if run_n:
            emit(
                run_s, len(idx_g), run_cap(len(idx_g) - run_s),
                len(bounds) - 1 - run_fi,
            )

    pos_bounds = np.r_[pos_start, n]
    for gi in range(len(pos_start)):
        s, e = pos_bounds[gi], pos_bounds[gi + 1]
        size = e - s
        if size > capacity:
            flush()
            sel = idx_sorted[s:e]
            if adjacency:
                g = grouping or GroupingParams(strategy="adjacency")
                umi_g = np.asarray(batch.umi)[sel]
                uu, inv, cnt = np.unique(
                    umi_g, axis=0, return_inverse=True, return_counts=True
                )
                if len(uu) > PRECLUSTER_MAX_UNIQUE:
                    warnings.warn(
                        f"position group with {len(uu)} unique UMIs exceeds "
                        f"the precluster limit {PRECLUSTER_MAX_UNIQUE}; "
                        "falling back to a family-boundary split (adjacency "
                        "merges across the split will be missed)"
                    )
                    count("n_precluster_fallback_groups")
                    count("n_precluster_fallback_reads", int(size))
                    fs_ = fam_start[(fam_start >= s) & (fam_start < e)]
                    pack_family_runs(sel, np.r_[fs_, e] - s, None, False)
                    # NO early continue: fall through to the shared
                    # range reset below — skipping it would let the
                    # final flush re-emit these reads in a plain bucket
                else:
                    from duplexumiconsensusreads_torch.oracle.grouping import (
                        directional_seeds,
                    )

                    seed_of = directional_seeds(
                        uu, cnt, g.max_hamming, g.effective_count_ratio
                    )
                    new_umi = uu[seed_of][inv]  # (size, B) seed-relabeled
                    w2 = pack_umi_words64(new_umi)
                    order_g = np.lexsort(
                        tuple(w2[:, i] for i in range(w2.shape[1] - 1, -1, -1))
                    )
                    sel = sel[order_g]
                    new_umi = new_umi[order_g]
                    w2 = w2[order_g]
                    fam_b = np.nonzero(
                        np.r_[True, (w2[1:] != w2[:-1]).any(axis=1)]
                    )[0]
                    pack_family_runs(sel, np.r_[fam_b, size], new_umi, True)
            else:
                fs_ = fam_start[(fam_start >= s) & (fam_start < e)]
                pack_family_runs(sel, np.r_[fs_, e] - s, None, False)
            cur_start = cur_end = e  # special paths consumed [s, e)
            continue
        if ladder is not None:
            if not pend:
                pend.append(int(s))
            pend.append(int(e))
            continue
        if (cur_end - cur_start) + size > capacity:
            flush()
            cur_start = s
        cur_end = e
    flush()

    out = [
        _fill_bucket(
            batch,
            idx_sorted[a:b],
            cap,
            n_unique=int(
                np.searchsorted(fam_start, b, side="left")
                - np.searchsorted(fam_start, a, side="left")
            ),
        )
        for a, b, cap in ranges
    ]
    out.extend(
        _fill_bucket(
            batch, idx, cap, umi_override=um, preclustered=pc, n_unique=nu
        )
        for idx, um, cap, pc, nu in special
    )
    return out


def pad_buckets(buckets: list[Bucket], multiple_of: int = 1) -> list[Bucket]:
    """``buckets`` followed by empty ones up to a multiple of
    ``multiple_of`` buckets (the mesh pad)."""
    if not buckets:
        raise ValueError("no buckets to stack")
    r = buckets[0].capacity
    l = buckets[0].bases.shape[1]
    b = buckets[0].umi.shape[1]
    return buckets + [_empty_bucket(r, l, b) for _ in range((-len(buckets)) % multiple_of)]


# the arrays stack_buckets stacks, in its order
STACKED_KEYS = ("pos", "umi", "strand_ab", "frag_end", "valid", "bases", "quals", "read_index")


def stack_buckets(buckets: list[Bucket], multiple_of: int = 1, out: dict | None = None) -> dict:
    """Stack buckets into (B, R, ...) arrays, padding the bucket count up
    to a multiple (for even mesh sharding). ``out`` (arrays of the
    stacked shapes and dtypes, by key, for some of STACKED_KEYS) receives
    those keys' stacks in place of new arrays."""
    padded = pad_buckets(buckets, multiple_of)
    out = out or {}
    res = {k: np.stack([getattr(x, k) for x in padded], out=out.get(k)) for k in STACKED_KEYS}
    res["n_real_buckets"] = len(buckets)
    return res
