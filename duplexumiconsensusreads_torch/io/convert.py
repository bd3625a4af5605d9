"""BamRecords ↔ ReadBatch conversion: where alignment records become
the HBM-resident padded tensors the kernels run on.

Conventions (the contract between io and grouping — SURVEY.md §7):

- **UMI**: the RX:Z aux tag, segments joined in read order ("ACG-TTG"
  → 6 codes). Reads with a missing RX or an N inside the UMI are marked
  invalid (the conventional fgbio/UMI-tools behaviour of dropping
  un-groupable reads) and counted in the returned info dict.
- **Duplex strand** (paired mode): a read observes the *top* (AB)
  strand iff it is read1-forward or read2-reverse (F1R2); the
  complementary F2R1 orientation is the bottom (BA) strand. For
  unpaired records the reverse flag alone decides. BA reads have their
  two UMI segments swapped so both strands of one source molecule carry
  the identical canonical UMI pair — molecule identity is then exactly
  (pos_key, clustered UMI) as oracle/grouping.py defines it.
- **pos_key**: i64 packing (ref_id << 36) | canonical fragment start,
  where the canonical start is min(pos, next_pos) for properly-paired
  records (both mates and both strands of a molecule share it) and pos
  otherwise.
"""

from __future__ import annotations

import numpy as np

from duplexumiconsensusreads_torch.constants import BASE_PAD, N_REAL_BASES
from duplexumiconsensusreads_torch.io.bam import (
    _CIGAR_OPS,
    FLAG_PAIRED,
    FLAG_READ1,
    FLAG_READ2,
    FLAG_REVERSE,
    BamHeader,
    BamRecords,
    consensus_excluded,
    make_aux_i,
    make_aux_z,
)
from duplexumiconsensusreads_torch.types import ReadBatch
from duplexumiconsensusreads_torch.utils.phred import pack_umi_words64

UMI_SEP = "-"
_POS_BITS = 36
_POS_MASK = (1 << _POS_BITS) - 1

_CHAR_TO_CODE = {c: i for i, c in enumerate("ACGT")}
_CODE_TO_CHAR = "ACGTN."
# u8 code -> ASCII byte, vectorised twin of _CODE_TO_CHAR (codes past
# the alphabet render as '.', same as the scalar path would index-error
# rather than emit — consensus UMIs only carry 0..3 in practice)
_CODE_CHARS = np.full(256, ord("."), np.uint8)
_CODE_CHARS[: len(_CODE_TO_CHAR)] = np.frombuffer(
    _CODE_TO_CHAR.encode("ascii"), np.uint8
)


# Sentinel key for unmapped records (ref_id < 0). samtools places
# unmapped reads at EOF of a coordinate-sorted BAM, so their key must
# sort AFTER every mapped key; sign-extending -1 through the shift/OR
# would instead give pos_key=-1 (sorts first) and trip the streaming
# sort-contract check on perfectly standard input.
UNMAPPED_POS_KEY = np.int64(1) << 62
_REF_ID_MAX = 1 << (62 - _POS_BITS)  # mapped keys must stay below the sentinel


def pack_pos_key(ref_id: np.ndarray, coord: np.ndarray) -> np.ndarray:
    ref_id = np.asarray(ref_id, np.int64)
    if (ref_id >= _REF_ID_MAX).any():
        # a mapped key must never alias UNMAPPED_POS_KEY (the streaming
        # chunker flushes sentinel keys without family hold-back) or
        # overflow i64; refuse rather than silently corrupt grouping
        raise ValueError(
            f"ref_id >= {_REF_ID_MAX} cannot be packed into a pos_key "
            f"({_POS_BITS} position bits); re-shard the reference"
        )
    coord = np.maximum(np.asarray(coord, np.int64), 0)
    key = (np.maximum(ref_id, 0) << _POS_BITS) | (coord & _POS_MASK)
    return np.where(ref_id < 0, UNMAPPED_POS_KEY, key)


def unpack_pos_key(key: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    key = np.asarray(key, np.int64)
    return (key >> _POS_BITS).astype(np.int32), (key & _POS_MASK).astype(np.int32)


def umi_string_to_codes(rx: str) -> np.ndarray | None:
    """RX string → u8 codes; None if any base is not ACGT."""
    s = rx.replace(UMI_SEP, "")
    codes = np.empty(len(s), np.uint8)
    for i, c in enumerate(s.upper()):
        v = _CHAR_TO_CODE.get(c)
        if v is None:
            return None
        codes[i] = v
    return codes


def load_umi_whitelist(path: str) -> np.ndarray:
    """Read an expected-UMI list (one ACGT string per line, '#'
    comments and blanks skipped) into an (W, U) u8 code matrix.
    All entries must share one length (the fgbio CorrectUmis input
    contract); raises ValueError otherwise."""
    entries = []
    with open(path) as f:
        for ln, line in enumerate(f, 1):
            s = line.strip()
            if not s or s.startswith("#"):
                continue
            codes = umi_string_to_codes(s)
            if codes is None:
                raise ValueError(
                    f"{path}:{ln}: non-ACGT UMI {s!r} in whitelist"
                )
            entries.append(codes)
    if not entries:
        raise ValueError(f"{path}: empty UMI whitelist")
    lens = {len(e) for e in entries}
    if len(lens) != 1:
        raise ValueError(
            f"{path}: whitelist mixes UMI lengths {sorted(lens)}"
        )
    return np.stack(entries)


def correct_umis_whitelist(
    batch, whitelist: np.ndarray, max_mismatches: int = 1
) -> dict:
    """fgbio CorrectUmis analogue, as an input policy: snap every valid
    read's UMI (each half independently in duplex mode) to its UNIQUE
    nearest whitelist entry within ``max_mismatches``; reads whose half
    has no whitelist entry close enough, or ties between two entries,
    are invalidated (counted, never silently kept — a wrong-molecule
    merge is the error class UMIs exist to prevent).

    Mutates batch.umi/batch.valid in place. Returns counters:
    n_umi_corrected (reads with >=1 half changed),
    n_dropped_whitelist (reads invalidated). Runs BEFORE grouping,
    mixed-mate detection, and projection, so every family-identity
    consumer sees corrected UMIs.
    """
    v = np.asarray(batch.valid, bool)
    idx = np.nonzero(v)[0]
    if not len(idx):
        return {"n_umi_corrected": 0, "n_dropped_whitelist": 0}
    u = np.asarray(batch.umi)[idx]  # (n, U)
    w_len = whitelist.shape[1]
    total = u.shape[1]
    if total % w_len != 0 or total // w_len not in (1, 2):
        raise ValueError(
            f"whitelist UMI length {w_len} does not divide the input "
            f"UMI length {total} into 1 or 2 halves"
        )
    halves = total // w_len
    changed = np.zeros(len(idx), bool)
    bad = np.zeros(len(idx), bool)
    for h in range(halves):
        part = u[:, h * w_len : (h + 1) * w_len]
        # (n, W) mismatch counts, blocked to bound peak memory
        best = np.full(len(idx), 255, np.uint8)
        second = np.full(len(idx), 255, np.uint8)
        best_w = np.zeros(len(idx), np.int64)
        block = max(1, (32 << 20) // max(len(whitelist) * w_len, 1))
        for s in range(0, len(idx), block):
            e = min(s + block, len(idx))
            d = (part[s:e, None, :] != whitelist[None, :, :]).sum(
                axis=2
            ).astype(np.uint8)
            o = np.argsort(d, axis=1)[:, :2]
            best[s:e] = d[np.arange(e - s), o[:, 0]]
            best_w[s:e] = o[:, 0]
            second[s:e] = (
                d[np.arange(e - s), o[:, 1]]
                if d.shape[1] > 1
                else np.uint8(255)
            )
        ok = (best <= max_mismatches) & (second > best)
        bad |= ~ok
        hit = ok & (best > 0)
        changed |= hit
        part[ok] = whitelist[best_w[ok]]
        u[:, h * w_len : (h + 1) * w_len] = part
    batch.umi[idx] = u
    batch.valid[idx[bad]] = False
    changed &= ~bad
    return {
        "n_umi_corrected": int(changed.sum()),
        "n_dropped_whitelist": int(bad.sum()),
    }


def umi_codes_to_string(codes: np.ndarray, paired: bool) -> str:
    s = "".join(_CODE_TO_CHAR[int(c)] for c in codes)
    if paired:
        h = len(s) // 2
        return s[:h] + UMI_SEP + s[h:]
    return s


def read_is_top_strand(flag: int) -> bool:
    if flag & FLAG_PAIRED:
        r1 = bool(flag & FLAG_READ1)
        rev = bool(flag & FLAG_REVERSE)
        return r1 != rev  # F1R2 → top
    return not flag & FLAG_REVERSE


def records_pos_keys(recs: BamRecords) -> np.ndarray:
    """Canonical fragment pos_key per record — THE grouping key.

    Single source of truth shared by batch conversion and the
    streaming chunker (whose family-integrity guarantee requires the
    chunk-boundary key to be byte-identical to the grouping key).
    """
    flags = np.asarray(recs.flags)
    paired_ok = (
        (flags & FLAG_PAIRED).astype(bool)
        & (recs.next_ref_id == recs.ref_id)
        & (recs.next_pos >= 0)
    )
    coord = np.where(paired_ok, np.minimum(recs.pos, recs.next_pos), recs.pos)
    return pack_pos_key(recs.ref_id, coord)


_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
# derived from io/bam.py's single spec constant — the FNV hash parity
# between both codecs depends on this mapping staying identical
_CIGAR_OP_IDX = {c: i for i, c in enumerate(_CIGAR_OPS)}


def cigar_hashes(cigars) -> np.ndarray:
    """FNV-1a64 over each record's BAM-encoded cigar op words — MUST
    stay bit-identical to the native loader's fnv1a64 over the raw
    cigar bytes (bamloader.cpp). 0 for cigar-less records."""
    out = np.empty(len(cigars), np.uint64)
    for i, cig in enumerate(cigars):
        if not cig:
            out[i] = 0
            continue
        h = _FNV_OFFSET
        for n_op, op in cig:
            v = (int(n_op) << 4) | _CIGAR_OP_IDX[op]
            for b in v.to_bytes(4, "little"):
                h = ((h ^ b) * _FNV_PRIME) & 0xFFFFFFFFFFFFFFFF
        out[i] = h
    return out


def modal_cigar_keep(
    pos_key: np.ndarray,  # (N,) i64
    umi: np.ndarray,  # (N, U) u8 canonical codes
    valid: np.ndarray,  # (N,) bool
    cig_hash: np.ndarray,  # (N,) u64
    strand_ab: np.ndarray | None = None,  # (N,) bool
) -> np.ndarray:
    """CIGAR/indel policy (VERDICT r1 item 6): within each EXACT family
    (pos_key, canonical UMI, strand), keep only reads carrying the
    family's modal CIGAR (ties to the smaller hash). Consensus math
    operates on raw cycles, so a read whose alignment differs from its
    family's (indel, clipping) would misalign every downstream column;
    a true indel-bearing molecule keeps its own family intact because
    ALL its reads share the indel CIGAR. The A/B strand sub-families
    are independent alignments that can legitimately differ in
    soft-clipping, so the modal vote runs PER STRAND (ADVICE r2) —
    keying on (pos, UMI) alone would silently drop a whole minority
    strand and downgrade the molecule from duplex to single-strand.
    Exact-family granularity is chosen over adjacency-cluster
    granularity so the filter can run at input conversion, identically
    for the oracle and the device pipeline.
    Returns the reduced validity mask."""
    idx = np.nonzero(np.asarray(valid, bool))[0]
    if not len(idx):
        return np.asarray(valid, bool).copy()
    # fast path: one CIGAR shape across the whole batch (the normal
    # uniform-length case) — every read is trivially modal
    ch_all = cig_hash[idx]
    if (ch_all == ch_all[0]).all():
        return np.asarray(valid, bool).copy()
    fam = _family_cols(pos_key, umi, idx)
    if strand_ab is not None:
        fam = np.column_stack(
            [fam, np.asarray(strand_ab, bool)[idx][:, None].astype(np.int64)]
        )
    # flip the sign bit so int64 comparison reproduces UNSIGNED hash
    # order ("ties to the smaller u64 hash" stays literally true)
    ch = (cig_hash[idx] ^ np.uint64(1 << 63)).view(np.int64)
    key = np.column_stack([fam, ch[:, None]])
    uniq, inv, cnt = np.unique(key, axis=0, return_inverse=True, return_counts=True)
    w = uniq.shape[1] - 1
    order = np.lexsort((uniq[:, w], -cnt, *[uniq[:, j] for j in range(w - 1, -1, -1)]))
    fam_sorted = uniq[order, :w]
    first = np.nonzero(
        np.r_[True, (fam_sorted[1:] != fam_sorted[:-1]).any(axis=1)]
    )[0]
    winner = np.zeros(len(uniq), bool)
    winner[order[first]] = True
    keep = np.asarray(valid, bool).copy()
    keep[idx] = winner[inv]
    return keep


def _cigar_edges(cig):
    """(lead_soft, core_ops, trail_soft, core_query_len) — the CIGAR
    split the soft-clip rescue compares on: edge S ops stripped, the
    aligned core kept verbatim."""
    if not cig:
        return 0, (), 0, 0
    i0, i1 = 0, len(cig)
    lead = trail = 0
    if cig[0][1] == "S":
        lead, i0 = cig[0][0], 1
    if i1 > i0 and cig[-1][1] == "S":
        trail, i1 = cig[-1][0], i1 - 1
    core = tuple(cig[i0:i1])
    qlen = sum(n for n, op in core if op in "MIS=X")
    return lead, core, trail, qlen


def softclip_rescue(
    bases: np.ndarray,  # (N, L) u8, MUTATED for rescued rows
    quals: np.ndarray,  # (N, L) u8, MUTATED for rescued rows
    keep: np.ndarray,  # (N,) bool modal-vote result, updated in place
    valid: np.ndarray,  # (N,) bool pre-CIGAR validity
    pos_key: np.ndarray,
    umi: np.ndarray,
    strand_ab: np.ndarray,
    read_pos: np.ndarray,  # (N,) i32 each record's OWN alignment start
    get_cigar,  # callable i -> [(n, op), ...]
    l_cap: int | None = None,  # true cycle width; defaults to the
    # matrix width, which is ONLY correct for unprojected batches — a
    # ref-projected caller must pass read_len, since its fallback rows
    # live in cycle space [0, read_len) inside a wider projected matrix
    # and a rescue spilling past read_len would be silently truncated
    # at emission
) -> dict:
    """Rescue minority-CIGAR reads whose difference from their family's
    modal CIGAR is SOFT-CLIPPING ONLY (identical aligned core): instead
    of dropping their evidence, trim to the aligned span and shift into
    the modal reads' cycle space (query q of the rescued read covers
    the same reference offset as modal query q - lead_r + lead_m,
    because the rescue REQUIRES the read's own alignment start to equal
    the donor's — family membership alone does not imply it: paired
    mates share (pos_key, UMI, strand) while their own POS differ, and
    repeat-region minority alignments can start a few bases off; a
    shift computed from clip leads alone would inject misaligned
    evidence, the exact corruption the modal vote exists to prevent).
    The read's own clipped bases are masked PAD — they were clipped
    for a reason. Runs at input
    conversion in BOTH codecs, so the oracle and device pipelines see
    the identical transformed batch (VERDICT r3 item 7).

    Returns counters: n_rescued_cigar, and the per-strand evidence-loss
    split n_dropped_cigar_ab / n_dropped_cigar_ba of the reads that
    stayed dropped (per-strand because losing one strand downgrades a
    molecule from duplex to single-strand — an invisible cost when only
    the aggregate was reported).
    """
    from duplexumiconsensusreads_torch.constants import BASE_PAD

    v = np.asarray(valid, bool)
    sab = np.asarray(strand_ab, bool)
    dropped = np.nonzero(v & ~keep)[0]
    n_rescued = 0
    rp = np.asarray(read_pos)
    if len(dropped):
        kept_idx = np.nonzero(v & keep)[0]
        # the donor key includes the read's OWN alignment start, so each
        # mate side (and each distinct minority start) gets its own
        # donor — keying by family alone let the first kept mate shadow
        # rescues whose span matched a later same-POS kept read
        # (advisor r4 finding)
        famk = _family_cols(pos_key, umi, kept_idx)
        famk = np.column_stack(
            [famk, sab[kept_idx].astype(np.int64), rp[kept_idx].astype(np.int64)]
        )
        dfam = _family_cols(pos_key, umi, dropped)
        dfam = np.column_stack(
            [dfam, sab[dropped].astype(np.int64), rp[dropped].astype(np.int64)]
        )
        # vectorised pre-filter BEFORE any per-record Python: the vote
        # drops a handful of reads but the kept set is the whole chunk —
        # restrict it to rows of families that actually lost a read
        # (realistic indel inputs hit this path on nearly every chunk)
        allrows = np.concatenate([dfam, famk])
        _u, inv = np.unique(allrows, axis=0, return_inverse=True)
        d_ids = np.unique(inv[: len(dfam)])
        hit = np.isin(inv[len(dfam):], d_ids)
        kept_idx, famk = kept_idx[hit], famk[hit]
        modal_of: dict = {}
        for row, i in zip(map(tuple, famk.tolist()), kept_idx.tolist()):
            modal_of.setdefault(row, i)
        if l_cap is None:
            l_cap = bases.shape[1]
        for row, i in zip(map(tuple, dfam.tolist()), dropped.tolist()):
            m = modal_of.get(row)
            if m is None:
                # no kept read shares this (family, strand, own-POS):
                # other mate / shifted alignment, or the whole family
                # was dropped elsewhere (not by the vote)
                continue
            lead_r, core_r, _tr, qlen = _cigar_edges(get_cigar(i))
            lead_m, core_m, _tm, _q = _cigar_edges(get_cigar(m))
            if not core_r or core_r != core_m or lead_m + qlen > l_cap:
                continue
            span_b = bases[i, lead_r : lead_r + qlen].copy()
            span_q = quals[i, lead_r : lead_r + qlen].copy()
            bases[i, :] = BASE_PAD
            quals[i, :] = 0
            bases[i, lead_m : lead_m + qlen] = span_b
            quals[i, lead_m : lead_m + qlen] = span_q
            keep[i] = True
            n_rescued += 1
    still = v & ~keep
    return {
        "n_rescued_cigar": n_rescued,
        "n_dropped_cigar_ab": int((still & sab).sum()),
        "n_dropped_cigar_ba": int((still & ~sab).sum()),
    }


def _family_cols(pos_key, umi, idx) -> np.ndarray:
    """THE exact-family key columns — (pos_key, packed UMI words) per
    selected read. Single source of truth for every conversion-time
    family grouping (modal-CIGAR filter, mixed-mate detection)."""
    return np.column_stack(
        [np.asarray(pos_key)[idx][:, None], pack_umi_words64(np.asarray(umi)[idx])]
    )


MIXED_MATE_WARNING = (
    "input families contain both R1 and R2 mates: cycle-space "
    "consensus would mix opposite fragment ends. Use mate-aware "
    "calling (--mate-aware on, the default auto resolution) or "
    "split the input by read number (samtools view -f 64 / "
    "-f 128). See n_mixed_mate_families in the report."
)


def warn_mixed_mates(
    flags: np.ndarray, pos_key, umi, strand_ab, valid, warn: bool = True
) -> tuple[int, bool]:
    """Detect families containing BOTH R1 and R2 mates.

    Cycle-space consensus assumes every family member covers the same
    cycles; a template's two mates cover opposite fragment ends, so
    merging them corrupts columns. Mate-aware grouping
    (GroupingParams.mate_aware, resolved automatically by the CLI)
    handles this properly by splitting families on the fragment-end
    bit and emitting consensus R1+R2 pairs; callers that run WITHOUT
    mate-aware grouping leave ``warn`` on so the hazard stays loud.
    Must run on the PRE-CIGAR-filter mask: mates often differ in
    soft-clips, so the modal-CIGAR filter would hide exactly the
    families this check exists to surface. Returns (n_mixed,
    mixed_present): the number of affected exact families — a LOWER
    bound under adjacency grouping (a mate with an errored UMI joins
    its cluster but forms a distinct exact key here) — and whether any
    family actually mixes the two mates (the CLI's mate-aware
    auto-detection signal). Mere R1+R2 flag PRESENCE is deliberately
    not the signal: classic one-read-per-strand F1R2/F2R1 inputs carry
    both flags yet every strand-keyed family is single-mate, and
    mate-aware grouping must stay off there (it provably changes
    nothing for such inputs, but the emitted records would gain paired
    flags).
    """
    import warnings as _warnings

    v = np.asarray(valid, bool)
    idx = np.nonzero(v)[0]
    if not len(idx):
        return 0, False
    fl = np.asarray(flags)[idx]
    paired = (fl & FLAG_PAIRED) != 0
    if not paired.any():
        return 0, False
    r1 = ((fl & FLAG_READ1) != 0) & paired
    r2 = ((fl & FLAG_READ2) != 0) & paired
    # inputs split by read number (the recommended workflow) skip the
    # family grouping entirely
    if not (r1.any() and r2.any()):
        return 0, False
    key = np.column_stack(
        [
            _family_cols(pos_key, umi, idx),
            np.asarray(strand_ab, bool)[idx][:, None].astype(np.int64),
        ]
    )
    uniq, inv = np.unique(key, axis=0, return_inverse=True)
    has_r1 = np.zeros(len(uniq), bool)
    has_r2 = np.zeros(len(uniq), bool)
    np.logical_or.at(has_r1, inv, r1)
    np.logical_or.at(has_r2, inv, r2)
    n_mixed = int((has_r1 & has_r2).sum())
    if n_mixed and warn:
        # stable text (no counts) so the warnings module dedups it on
        # chunked runs; the count travels in info/run reports instead
        _warnings.warn(MIXED_MATE_WARNING)
    return n_mixed, n_mixed > 0


def mixed_ends_present(batch) -> bool:
    """True iff some exact (pos_key, UMI, strand) family holds reads of
    BOTH fragment ends — the batch-level twin of warn_mixed_mates'
    mixed-mate detection, for inputs that carry no BAM flags (npz).
    Mere presence of second-end reads is NOT the signal: a
    split-by-read-number file has end-2 reads (bottom-strand R1) in
    every family, yet each family is single-end and mate-aware grouping
    must stay off for it."""
    v = np.asarray(batch.valid, bool)
    idx = np.nonzero(v)[0]
    if not len(idx):
        return False
    e2 = np.asarray(batch.frag_end, bool)[idx]
    if not e2.any() or e2.all():
        return False
    key = np.column_stack(
        [
            _family_cols(batch.pos_key, batch.umi, idx),
            np.asarray(batch.strand_ab, bool)[idx][:, None].astype(np.int64),
        ]
    )
    uniq, inv = np.unique(key, axis=0, return_inverse=True)
    has1 = np.zeros(len(uniq), bool)
    has2 = np.zeros(len(uniq), bool)
    np.logical_or.at(has1, inv, ~e2)
    np.logical_or.at(has2, inv, e2)
    return bool((has1 & has2).any())


def downsample_families(batch, max_reads: int) -> int:
    """Cap every exact sub-family (pos_key, UMI, strand, fragment end)
    at ``max_reads`` reads, keeping the highest-summed-quality reads
    (ties break to the earliest record — deterministic). Extra reads
    are marked invalid in place; returns how many were dropped.

    This is the input-policy analogue of the reference domain's
    --max-reads: beyond ~20 reads the consensus posterior is saturated,
    so pathological families (primer stacks, optical duplicates of
    duplicates) only cost compute and pad jumbo buckets. Applied on the
    host BEFORE grouping — the same stage as every other input policy
    here (SAM-flag exclusion, min-input-qual, the modal-CIGAR filter),
    so both backends and both executors see the identical capped input.
    Two documented consequences of the pre-grouping semantics:
    - under adjacency grouping, the directional count-ratio rule sees
      CAPPED counts, so an error-UMI sub-family at >= max_reads reads
      may stay unmerged where uncapped counts would have absorbed it
      (tools that downsample after a separate grouping step — fgbio's
      CallMolecularConsensusReads after GroupReadsByUmi — do not have
      this edge; here grouping is fused). Choose max_reads comfortably
      above the error-family size (>= 20) to keep the edge negligible.
    - a directional cluster may still merge several capped
      sub-families, so a cluster's total depth can exceed max_reads.
    """
    v = np.asarray(batch.valid, bool)
    idx = np.nonzero(v)[0]
    if max_reads <= 0 or not len(idx):
        return 0
    key = np.column_stack(
        [
            _family_cols(batch.pos_key, batch.umi, idx),
            np.asarray(batch.strand_ab, bool)[idx][:, None].astype(np.int64),
            np.asarray(batch.frag_end, bool)[idx][:, None].astype(np.int64),
        ]
    )
    _, inv = np.unique(key, axis=0, return_inverse=True)
    bases = np.asarray(batch.bases)[idx]
    quals = np.asarray(batch.quals)[idx]
    score = (quals.astype(np.int64) * (bases < N_REAL_BASES)).sum(axis=1)
    order = np.lexsort((idx, -score, inv))  # family, then best-first
    sf = inv[order]
    rank = np.arange(len(sf)) - np.searchsorted(sf, sf, side="left")
    drop = rank >= max_reads
    batch.valid[idx[order[drop]]] = False
    return int(drop.sum())


def records_to_readbatch(
    recs: BamRecords, duplex: bool = True, warn_mixed: bool = True,
    ref_projected: bool = False, mate_aware: str = "off",
    umi_whitelist: np.ndarray | None = None, umi_max_mismatches: int = 1,
) -> tuple[ReadBatch, dict]:
    """Convert parsed BAM records into a padded ReadBatch.

    Returns (batch, info); info counts reads dropped for missing/N UMIs,
    inconsistent UMI length, excluded FLAGs, or a CIGAR differing from
    the exact family's modal CIGAR. Dropped reads occupy invalid slots
    so read indices stay aligned with ``recs``. ``warn_mixed=False``
    suppresses the mixed-mate warning (mate-aware callers handle those
    families; the counter still fills).

    ref_projected=True places reads on per-position-group REFERENCE
    columns instead of cycles (io/refproject.py): indel-bearing reads
    contribute realigned evidence instead of being dropped, and
    info["ref_projection"] carries the column metadata the emission
    side needs. Groups that cannot project (span too wide) keep the
    classic cycle layout + modal-CIGAR policy. ``mate_aware`` (the CLI
    setting: auto/on/off) decides the projection grouping: when it
    resolves on (auto = mixed mates present — the same rule the
    executor applies), column tables split by fragment end so each
    mate side projects around its own alignment span instead of one
    fragment-length-wide table that would blow the span cap.
    """
    n = len(recs)
    l = recs.seq.shape[1] if n else 0
    flags = np.asarray(recs.flags)
    excluded = consensus_excluded(flags, recs.ref_id)
    n_flag_excluded = int(excluded.sum())

    umi_len = 0
    umi_codes: list[np.ndarray | None] = []
    for i, rx in enumerate(recs.umi):
        # excluded reads skip UMI parsing entirely — their codes are
        # never consumed, and a large unmapped/secondary tail would
        # otherwise burn per-char Python time for nothing
        codes = umi_string_to_codes(rx) if (rx and not excluded[i]) else None
        umi_codes.append(codes)
        if codes is not None and len(codes) > umi_len:
            umi_len = len(codes)

    batch = ReadBatch.empty(n, l, umi_len)
    n_no_umi = n_bad_len = 0
    pos_key = records_pos_keys(recs)

    for i in range(n):
        if excluded[i]:
            continue
        codes = umi_codes[i]
        if codes is None:
            n_no_umi += 1
            continue
        if len(codes) != umi_len:
            n_bad_len += 1
            continue
        fl = int(flags[i])
        top = read_is_top_strand(fl)
        if duplex and not top:
            h = umi_len // 2
            codes = np.concatenate([codes[h:], codes[:h]])
        batch.umi[i] = codes
        batch.strand_ab[i] = top
        # fragment-end bit: top-R1 and bottom-R2 observe end 1 (the
        # cross-mate duplex partners); single-end records are end 1
        batch.frag_end[i] = bool(fl & FLAG_PAIRED) and (
            bool(fl & FLAG_READ2) == top
        )
        batch.valid[i] = True
    batch.bases[:] = recs.seq
    batch.quals[:] = recs.qual
    batch.pos_key[:] = pos_key

    # whitelist UMI correction FIRST (CorrectUmis analogue): every
    # family-identity consumer below — mixed-mate detection, the
    # projection grouping, the modal-CIGAR vote — must see corrected
    # UMIs, or a heals-to-the-same-molecule read would split a family
    wl_info = {}
    if umi_whitelist is not None:
        wl_info = correct_umis_whitelist(
            batch, umi_whitelist, umi_max_mismatches
        )

    # mixed-mate detection BEFORE the CIGAR filter: mates often differ
    # in soft-clips, so the modal filter would hide exactly these
    n_mixed, mixed_present = warn_mixed_mates(
        flags, batch.pos_key, batch.umi, batch.strand_ab, batch.valid,
        warn=warn_mixed,
    )
    n_before = int(batch.valid.sum())
    proj = None
    if ref_projected:
        from duplexumiconsensusreads_torch.io.refproject import ref_project

        mate_split = mate_aware == "on" or (
            mate_aware == "auto" and mixed_present
        )
        gk = np.asarray(batch.pos_key) * 2 + (
            np.asarray(batch.frag_end).astype(np.int64) if mate_split else 0
        )
        pb, pq, proj, fb, unanch = ref_project(
            batch.bases, batch.quals, batch.valid, gk,
            batch.umi, np.asarray(recs.pos), lambda i: recs.cigars[i],
        )
        proj.mate_split = mate_split
        widened = ReadBatch.empty(n, proj.width, umi_len)
        widened.bases[:] = pb
        widened.quals[:] = pq
        for f in ("umi", "pos_key", "strand_ab", "frag_end", "valid"):
            getattr(widened, f)[:] = getattr(batch, f)
        batch = widened
        # unanchored reads (CIGAR consumes no reference) placed nothing:
        # an all-PAD row would inflate family size (min-reads gates,
        # depth denominators) without contributing evidence — invalidate
        # them after counting (proj.n_unanchored_reads above)
        batch.valid &= ~unanch
        batch.strand_ab &= ~unanch
        batch.frag_end &= ~unanch
        # the classic policy applies only to the fallback groups, whose
        # rows kept the cycle layout in columns [0, L)
        policy_valid = batch.valid & fb
    else:
        policy_valid = batch.valid
    keep = modal_cigar_keep(
        batch.pos_key, batch.umi, policy_valid, cigar_hashes(recs.cigars),
        batch.strand_ab,
    )
    keep |= batch.valid & ~policy_valid  # projected reads are all kept
    rescue_info = softclip_rescue(
        batch.bases, batch.quals, keep, policy_valid, batch.pos_key,
        batch.umi, batch.strand_ab, np.asarray(recs.pos),
        lambda i: recs.cigars[i],
        l_cap=(proj.read_len if proj is not None else None),
    )
    batch.valid &= keep
    batch.strand_ab &= keep
    batch.frag_end &= keep
    n_cigar = n_before - int(batch.valid.sum())
    if proj is not None:
        # unanchored invalidations have their own counter
        # (n_projection_unanchored_reads); keep the drop counters disjoint
        n_cigar -= proj.n_unanchored_reads

    info = {
        "n_records": n,
        "n_valid": int(batch.valid.sum()),
        "n_dropped_no_umi": n_no_umi,
        "n_dropped_umi_len": n_bad_len,
        "n_dropped_flag": n_flag_excluded,
        "n_dropped_cigar": n_cigar,
        **rescue_info,
        "n_mixed_mate_families": n_mixed,
        "mixed_mates": mixed_present,
        "umi_len": umi_len,
        **wl_info,
    }
    if proj is not None:
        info["ref_projection"] = proj
        info["n_projected_reads"] = proj.n_projected_reads
        info["n_projection_fallback_reads"] = proj.n_fallback_reads
        info["n_projection_fallback_groups"] = proj.n_fallback_groups
        info["n_projection_unanchored_reads"] = proj.n_unanchored_reads
    return batch, info


def readbatch_to_records(
    batch: ReadBatch,
    duplex: bool = True,
    names: list[str] | None = None,
    paired_end: bool = False,
) -> BamRecords:
    """Inverse of records_to_readbatch for synthetic data: emit records
    whose flags encode the strand and whose RX segments are
    de-canonicalised (swapped back for BA reads).

    paired_end=False emits single-end records (reverse flag = strand).
    paired_end=True emits paired-style flags instead, derived from the
    strand AND fragment-end bits: read number = frag_end XOR
    bottom-strand, reverse iff the read number equals the top-strand
    bit (so a frag_end-free batch reproduces the classic F1R2/F2R1
    one-read-per-strand convention) — with a mate pointer at the same
    position, exercising the full paired strand/mate derivation and
    min(pos, next_pos) pos_key path end-to-end.
    """
    from duplexumiconsensusreads_torch.io.bam import FLAG_MATE_REVERSE

    valid = np.asarray(batch.valid, bool)
    idx = np.nonzero(valid)[0]
    n = len(idx)
    l = batch.read_len
    lengths = np.full(n, l, np.int32)
    ref_id, pos = unpack_pos_key(np.asarray(batch.pos_key)[idx])
    strand = np.asarray(batch.strand_ab, bool)[idx]
    if paired_end:
        e2 = np.asarray(batch.frag_end, bool)[idx]
        r2 = e2 ^ ~strand
        rev = r2 == strand
        flags = (
            FLAG_PAIRED
            | np.where(r2, FLAG_READ2, FLAG_READ1)
            | np.where(rev, FLAG_REVERSE, 0)
            | np.where(rev, 0, FLAG_MATE_REVERSE)
        ).astype(np.uint16)
    else:
        flags = np.where(strand, 0, FLAG_REVERSE).astype(np.uint16)

    umis = []
    for j, i in enumerate(idx):
        codes = np.asarray(batch.umi)[i]
        if duplex and not strand[j]:
            h = len(codes) // 2
            codes = np.concatenate([codes[h:], codes[:h]])
        umis.append(umi_codes_to_string(codes, paired=duplex))

    seq = np.asarray(batch.bases)[idx]
    # PAD cycles inside a record are not representable; render as N
    seq = np.where(seq == BASE_PAD, 4, seq).astype(np.uint8)

    if paired_end:
        # mate points at the same fragment start so pos_key (min of the
        # two coordinates) round-trips exactly
        next_ref_id = ref_id.copy()
        next_pos = pos.copy()
        tlen = np.full(n, l, np.int32)
    else:
        next_ref_id = np.full(n, -1, np.int32)
        next_pos = np.full(n, -1, np.int32)
        tlen = np.zeros(n, np.int32)
    return BamRecords(
        # fixed-width names give every record an identical byte layout,
        # unlocking the uniform vectorised serializer (io/bam.py)
        names=(names or [f"read{i:010d}" for i in idx]),
        flags=flags,
        ref_id=ref_id,
        pos=pos,
        mapq=np.full(n, 60, np.uint8),
        next_ref_id=next_ref_id,
        next_pos=next_pos,
        tlen=tlen,
        lengths=lengths,
        seq=seq,
        qual=np.asarray(batch.quals)[idx],
        cigars=[[(l, "M")] for _ in range(n)],
        umi=umis,
        aux_raw=[make_aux_z("RX", u) for u in umis],
    )


def depth_stats(depth: np.ndarray) -> np.ndarray:
    """(F, L) per-cycle depth -> (F, 2) [cD = max depth, cM = min
    positive depth]. int64 up front: masking with the int64-max
    sentinel in the source's int32 dtype would wrap to -1 under NEP 50
    promotion. The device pipeline computes the same two stats on
    device (ops/pipeline.py) so the padded matrix never crosses the
    host link."""
    d = np.asarray(depth, np.int64)
    n = d.shape[0]
    if not d.size:
        return np.zeros((n, 2), np.int64)
    c_max = d.max(axis=1)
    masked = np.where(d > 0, d, np.iinfo(np.int64).max)
    c_min = np.where((d > 0).any(axis=1), masked.min(axis=1), 0)
    return np.stack([c_max, c_min], axis=1)


def consensus_to_records(
    cons_base: np.ndarray,  # (F, L) u8
    cons_qual: np.ndarray,  # (F, L) u8
    cons_dstats: np.ndarray,  # (F, 2) i64 [cD, cM] — see depth_stats()
    cons_valid: np.ndarray,  # (F,) bool
    fam_pos_key: np.ndarray,  # (F,) i64 representative pos_key per family
    fam_umi: np.ndarray,  # (F, U) u8 representative canonical UMI per family
    duplex: bool,
    name_prefix: str = "cons",
    cons_mate: np.ndarray | None = None,  # (F,) second-mate bit
    cons_pair: np.ndarray | None = None,  # (F,) i64 template link
    paired_out: bool = False,
    cons_pdepth: np.ndarray | None = None,  # (F, L) per-base depth -> cd:B,I
    cons_perr: np.ndarray | None = None,  # (F, L) per-base errors -> ce:B,I
    read_group: str | None = None,  # RG:Z on every record (fgbio-style
    # single consensus read group; the header gains the matching @RG)
    proj=None,  # RefProjection: reference-column emission (io/refproject)
    cons_end: np.ndarray | None = None,  # (F,) unit fragment-end bit —
    # required for proj.mate_split lookups (key = pos_key*2 + end)
) -> BamRecords:
    """Build consensus BAM records from (scattered-back) pipeline output.

    Emitted per valid family/molecule: a mapped record at the family's
    canonical position with RX (canonical UMI), cD (max depth) and cM
    (min positive depth) aux tags — the fgbio-style consensus metadata.

    paired_out=True (mate-aware runs) re-links output rows into
    consensus R1/R2 mates: two rows sharing a cons_pair value with
    opposite cons_mate bits become a proper read pair — shared qname,
    FLAG_PAIRED|PROPER|READ1/READ2, mate pointer at the shared
    canonical position. Rows whose partner emitted no consensus (e.g.
    one fragment end failed min_duplex_reads) stay single-end records.
    """
    idx = np.nonzero(np.asarray(cons_valid, bool))[0]
    n = len(idx)
    l = cons_base.shape[1]
    ref_id, pos = unpack_pos_key(fam_pos_key[idx])

    # -------- reference-column emission (--ref-projected) --------
    # Per row: keep the family's emitted columns, derive the consensus
    # CIGAR from the structural majorities decided at projection, and
    # move POS to the first called reference column. Rows whose group
    # fell back (or called nothing) keep the legacy full-M emission.
    plan = [None] * n
    if proj is not None:
        if proj.mate_split and cons_end is None:
            raise ValueError(
                "mate-split ref-projection needs cons_end (the unit "
                "fragment-end bits) to address its column tables"
            )
        from duplexumiconsensusreads_torch.io.refproject import emit_columns

        for k in range(n):
            i = int(idx[k])
            gk = int(fam_pos_key[i]) * 2 + (
                int(cons_end[i]) if proj.mate_split else 0
            )
            plan[k] = emit_columns(
                proj, gk, fam_umi[i].tobytes(), cons_base[i]
            )
            if plan[k] is not None:
                pos[k] = plan[k][2]

    # per-record emitted lengths + reference spans. In a projected run
    # the matrices are proj.width wide, but fallback rows only ever
    # held cycles [0, read_len) — emitting the full width would pad
    # their SEQ/CIGAR/cd/ce out to the widest projected group. The
    # reference span (M+D) feeds the mate-pair PNEXT/TLEN below, where
    # projection can move the two mates' POS apart.
    base_len = l if proj is None else proj.read_len
    lens = np.full(n, base_len, np.int32)
    ref_len_v = np.full(n, base_len, np.int64)
    for k, p in enumerate(plan):
        if p is not None:
            lens[k] = len(p[0])
            ref_len_v[k] = sum(nn for nn, op in p[1] if op in "MD")

    # -------- mate-pair linking (mate-aware emission) --------
    flags_v = np.zeros(n, np.uint16)
    next_ref = np.full(n, -1, np.int32)
    next_pos_v = np.full(n, -1, np.int32)
    tlen_v = np.zeros(n, np.int32)
    pair_gid = np.full(n, -1, np.int64)  # rows in a complete pair share it
    if paired_out and cons_pair is not None and n:
        mate = np.asarray(cons_mate)[idx].astype(np.int64)
        pairk = np.asarray(cons_pair)[idx].astype(np.int64)
        order = np.lexsort((mate, pairk))
        pk_s = pairk[order]
        mate_s = mate[order]
        new_grp = np.r_[True, pk_s[1:] != pk_s[:-1]]
        gid_s = np.cumsum(new_grp) - 1
        grp_start = np.nonzero(new_grp)[0]
        grp_size = np.diff(np.r_[grp_start, len(pk_s)])
        # complete = exactly two rows whose (mate-sorted) mates are 0, 1
        comp_grp = grp_size == 2
        two = grp_start[comp_grp]
        comp_grp[comp_grp] = (
            (mate_s[two] == 0) & (mate_s[two + 1] == 1) & (pk_s[two] >= 0)
        )
        row_complete = comp_grp[gid_s]
        inv = np.empty(n, np.int64)
        inv[order] = np.arange(n)
        row_complete_n = row_complete[inv]
        mate_n = mate
        pair_gid = np.where(row_complete_n, gid_s[inv], -1)
        from duplexumiconsensusreads_torch.io.bam import (
            FLAG_MATE_UNMAPPED,
            FLAG_PROPER_PAIR,
        )

        # every mate-aware row keeps its read-number flag — a row whose
        # partner emitted no consensus is still the R1 (or R2) side of
        # its template, and validators/downstream tools need that bit;
        # the missing partner is declared via FLAG_MATE_UNMAPPED
        rnum = np.where(mate_n == 1, FLAG_READ2, FLAG_READ1)
        flags_v = (
            FLAG_PAIRED
            | rnum
            | np.where(row_complete_n, FLAG_PROPER_PAIR, FLAG_MATE_UNMAPPED)
        ).astype(np.uint16)
        next_ref = np.where(row_complete_n, ref_id, -1).astype(np.int32)
        # PNEXT/TLEN from the PARTNER row: projection moves each mate's
        # POS to its own first called reference column, so the mates of
        # one template no longer share a position (unprojected runs
        # still do, where this reduces to the old shared-POS ±L form).
        # Complete pairs sort adjacently (mate 0 then 1), so the
        # partner is the sorted neighbour.
        t = np.arange(len(order))
        partner = np.clip(np.where(mate_s == 0, t + 1, t - 1), 0, max(len(t) - 1, 0))
        pos_s = pos[order].astype(np.int64)
        end_s = pos_s + ref_len_v[order]
        ppos_s = pos_s[partner]
        pend_s = end_s[partner]
        span = np.maximum(end_s, pend_s) - np.minimum(pos_s, ppos_s)
        left = (pos_s < ppos_s) | ((pos_s == ppos_s) & (mate_s == 0))
        tlen_s = np.where(left, span, -span)
        next_pos_v = np.where(
            row_complete_n, ppos_s[inv], -1
        ).astype(np.int32)
        tlen_v = np.where(row_complete_n, tlen_s[inv], 0).astype(np.int32)
    # vectorised RX strings: code matrix -> ASCII bytes (+ separator
    # column for duplex pairs), one decode per batch instead of a
    # Python join per record
    u = fam_umi.shape[1]
    chars = _CODE_CHARS[fam_umi[idx]] if n else np.zeros((0, u), np.uint8)
    if duplex:
        h = u // 2
        sep = np.full((n, 1), ord(UMI_SEP), np.uint8)
        chars = np.concatenate([chars[:, :h], sep, chars[:, h:]], axis=1)
    w = chars.shape[1]
    flat = chars.tobytes()
    umis = [flat[k * w:(k + 1) * w].decode("ascii") for k in range(n)]
    ds = np.asarray(cons_dstats, np.int64)[idx]
    cd_bytes = ds[:, 0].astype("<i4").tobytes()
    cm_bytes = ds[:, 1].astype("<i4").tobytes()

    def _row_cols(arr, k):
        """One record's emitted per-base values from a padded (F, C)
        matrix: the projection's kept columns, or the full row."""
        p = plan[k]
        row = np.asarray(arr)[idx[k]]
        return row[p[0]] if p is not None else row[:base_len]

    def _pb_rows(tag: bytes, arr):
        # fgbio-style per-base B array. fgbio emits B,S; we match that
        # whenever every value fits u16, widening to B,I only for jumbo
        # depths (the hard cap is 64x bucket capacity, which can exceed
        # u16) — strict fgbio-downstream parsers accept the common case
        import struct as _struct

        if proj is None:
            # vectorised fast path — the streaming executor calls this
            # per chunk on the 200M-read path, where per-record Python
            # costs minutes of host wall (the repo's standing contract)
            rows = np.asarray(arr)[idx]
            if rows.size == 0 or int(rows.max()) < 65536:
                sub, width, dt = b"S", 2, "<u2"
            else:
                sub, width, dt = b"I", 4, "<u4"
            hdr = tag + b"B" + sub + _struct.pack("<I", l)
            flat = rows.astype(dt).tobytes()
            return [
                hdr + flat[width * l * k : width * l * (k + 1)]
                for k in range(n)
            ]
        rows = [_row_cols(arr, k) for k in range(n)]
        vmax = max((int(r.max()) for r in rows if r.size), default=0)
        if vmax < 65536:
            sub, dt = b"S", "<u2"
        else:
            sub, dt = b"I", "<u4"
        return [
            tag + b"B" + sub + _struct.pack("<I", int(lens[k]))
            + rows[k].astype(dt).tobytes()
            for k in range(n)
        ]

    pd_rows = None if cons_pdepth is None else _pb_rows(b"cd", cons_pdepth)
    pe_rows = None if cons_perr is None else _pb_rows(b"ce", cons_perr)
    names, aux = [], []
    rg_bytes = (
        b"RGZ" + read_group.encode("ascii") + b"\x00" if read_group else b""
    )
    rid_l, pos_l, idx_l = ref_id.tolist(), pos.tolist(), idx.tolist()
    # mates must share ONE qname, but projection can move the two
    # mates' POS apart — embed the pair's LEFTMOST pos in both rows'
    # names (unprojected pairs share pos anyway, so this is identical
    # there)
    pair_pos_l = pos_l
    if n and int(pair_gid.max()) >= 0:
        g_min = np.full(int(pair_gid.max()) + 1, np.iinfo(np.int64).max)
        has = pair_gid >= 0
        np.minimum.at(g_min, pair_gid[has], pos[has])
        pair_pos_l = np.where(has, g_min[np.maximum(pair_gid, 0)], pos).tolist()
    gid_l = pair_gid.tolist()
    for k in range(n):
        # fixed-width fields -> identical record layout -> uniform
        # vectorised serializer (io/bam.py). Mate pairs share a qname
        # (their pair-group id); the s/p suffix keeps the single-record
        # and pair id spaces from colliding at equal width.
        if gid_l[k] >= 0:
            names.append(
                f"{name_prefix}:{rid_l[k]}:{pair_pos_l[k]:010d}:{gid_l[k]:07d}p"
            )
        else:
            names.append(
                f"{name_prefix}:{rid_l[k]}:{pos_l[k]:010d}:{idx_l[k]:07d}s"
            )
        aux.append(
            b"RXZ"
            + umis[k].encode("ascii")
            + b"\x00cDi"
            + cd_bytes[4 * k : 4 * k + 4]
            + b"cMi"
            + cm_bytes[4 * k : 4 * k + 4]
            + rg_bytes
            + (pd_rows[k] if pd_rows is not None else b"")
            + (pe_rows[k] if pe_rows is not None else b"")
        )
    if proj is None:
        # vectorised fast path (streaming hot path — see _pb_rows)
        rows_b = np.asarray(cons_base)[idx]
        seq_m = np.where(rows_b == BASE_PAD, 4, rows_b).astype(np.uint8)
        qual_m = np.asarray(cons_qual)[idx].astype(np.uint8)
        cigars: list = [[(base_len, "M")] for _ in range(n)]
    else:
        w_out = int(lens.max()) if n else l
        seq_m = np.full((n, w_out), 4, np.uint8)
        qual_m = np.zeros((n, w_out), np.uint8)
        cigars = []
        for k in range(n):
            m = int(lens[k])
            row = _row_cols(cons_base, k)
            seq_m[k, :m] = np.where(row == BASE_PAD, 4, row)
            qual_m[k, :m] = _row_cols(cons_qual, k)
            p = plan[k]
            cigars.append([(base_len, "M")] if p is None else p[1])
    return BamRecords(
        names=names,
        flags=flags_v,
        ref_id=ref_id,
        pos=pos,
        mapq=np.full(n, 60, np.uint8),
        next_ref_id=next_ref,
        next_pos=next_pos_v,
        tlen=tlen_v,
        lengths=lens,
        seq=seq_m,
        qual=qual_m,
        cigars=cigars,
        umi=umis,
        aux_raw=aux,
    )


def simulated_bam(
    cfg=None, path: str | None = None, sort: bool = False, paired_end: bool = False
):
    """Simulate a truth-aware batch and render it as a BAM (bytes or file).

    Convenience used by the CLI's `simulate` subcommand and tests.
    sort=True emits records in coordinate order (the streaming
    executor's input contract). Returns (header, records, batch, truth).
    """
    import dataclasses as _dc

    from duplexumiconsensusreads_torch.io.bam import write_bam
    from duplexumiconsensusreads_torch.simulate import SimConfig, simulate_batch
    from duplexumiconsensusreads_torch.types import ReadBatch

    cfg = cfg or SimConfig()
    batch, truth = simulate_batch(cfg)
    if sort:
        order = np.argsort(np.asarray(batch.pos_key), kind="stable")
        batch = batch.take(order)
        truth = _dc.replace(
            truth,
            read_mol=truth.read_mol[order],
            read_strand=truth.read_strand[order],
            read_end2=(
                None if truth.read_end2 is None else truth.read_end2[order]
            ),
        )
    header = BamHeader.synthetic(
        sort_order="coordinate" if sort else "unsorted"
    )
    # true mate pairs only exist in BAM form as paired-end records
    recs = readbatch_to_records(
        batch, duplex=cfg.duplex, paired_end=paired_end or cfg.paired_reads
    )
    if cfg.indel_error > 0:
        inject_indels(recs, cfg.indel_error, seed=cfg.seed + 9999)
    if path is not None:
        write_bam(path, header, recs)
    return header, recs, batch, truth


def inject_indels(recs: BamRecords, rate: float, seed: int = 0) -> np.ndarray:
    """Give a random subset of records a 1bp indel: shifted sequence
    content plus the matching CIGAR (pM 1I (l-p-1)M or pM 1D (l-p)M).
    These reads are cycle-misaligned relative to their family — exactly
    what the modal-CIGAR input filter must drop. Returns the mutated
    record indices."""
    rng = np.random.default_rng(seed)
    sel = np.nonzero(rng.random(len(recs)) < rate)[0]
    sel = sel[np.asarray(recs.lengths)[sel] >= 3]  # too short to cut
    for i in sel:
        l = int(recs.lengths[i])
        p = int(rng.integers(1, l - 1))
        if rng.random() < 0.5:  # insertion at cycle p
            recs.cigars[i] = [(p, "M"), (1, "I"), (l - p - 1, "M")]
            recs.seq[i, p + 1 : l] = recs.seq[i, p : l - 1].copy()
            recs.seq[i, p] = rng.integers(0, 4)
        else:  # 1bp deletion after cycle p
            recs.cigars[i] = [(p, "M"), (1, "D"), (l - p, "M")]
            recs.seq[i, p : l - 1] = recs.seq[i, p + 1 : l].copy()
            recs.seq[i, l - 1] = rng.integers(0, 4)
    return sel
