"""Standard BAI (BAM binning index) writer — SAM spec §5.2.

Every downstream consumer of consensus BAMs (variant callers, IGV,
samtools-compatible tooling) random-accesses through a ``.bai``; a
coordinate-sorted BAM without one is not drop-in output. This builder produces the spec layout directly from the
published format — R-tree bins via reg2bin, chunk lists as virtual
offset pairs, the 16 kb linear index, the htslib metadata pseudo-bin
(37450) and the unplaced-read trailer — with no htslib dependency.

One sequential pass shared with the tool's own linear index
(io/index.py): the BGZF block table maps global decompressed offsets to
virtual offsets ((coffset << 16) | uoffset), and the native record
chain walk yields record boundaries.

The layout authority is the published SAM/BAM specification. A copy
of the JAX package's io/bai.py, importing this package's modules.
"""

from __future__ import annotations

import struct

import numpy as np

BAI_MAGIC = b"BAI\x01"
LINEAR_SHIFT = 14
METADATA_BIN = 37450  # htslib pseudo-bin: file-range + mapped/unmapped counts

# CIGAR ops that consume reference: M(0) D(2) N(3) =(7) X(8)
_REF_CONSUME_MASK = (1 << 0) | (1 << 2) | (1 << 3) | (1 << 7) | (1 << 8)


class _RefIndex:
    """Accumulating per-reference state: bins -> chunk lists, linear
    index, and the metadata counts. All accumulation is batched — a
    per-record Python loop costs minutes of host time on the critical
    path of a 200M-read output."""

    __slots__ = ("bins", "linear", "off_beg", "off_end", "n_mapped", "n_unmapped")

    def __init__(self):
        self.bins: dict[int, list[list[int]]] = {}
        self.linear = np.zeros(0, np.int64)
        self.off_beg = -1
        self.off_end = 0
        self.n_mapped = 0
        self.n_unmapped = 0

    def add_batch(self, begs, ends, bins_, v_begs, v_ends, unm):
        """Accumulate one file-order batch of placed records.

        Chunk-merge semantics are identical to the per-record form: per
        bin, a record whose v_beg equals the previous record's v_end
        extends that chunk (a stable sort by bin preserves file order
        within each bin, and the dict tail carries contiguity across
        batches)."""
        n = len(begs)
        if n == 0:
            return
        if self.off_beg < 0:
            self.off_beg = int(v_begs[0])
        self.off_end = int(v_ends[-1])
        nu = int(unm.sum())
        self.n_unmapped += nu
        self.n_mapped += n - nu
        order = np.argsort(bins_, kind="stable")
        sb, svb, sve = bins_[order], v_begs[order], v_ends[order]
        new = np.r_[True, (sb[1:] != sb[:-1]) | (svb[1:] != sve[:-1])]
        starts = np.nonzero(new)[0]
        last = np.r_[starts[1:], n] - 1
        for bi, s, e in zip(
            sb[starts].tolist(), svb[starts].tolist(), sve[last].tolist()
        ):
            chunks = self.bins.setdefault(bi, [])
            if chunks and chunks[-1][1] == s:
                chunks[-1][1] = e  # contiguous across the batch seam
            else:
                chunks.append([s, e])
        # linear index: first voffset touching each 16 kb window the
        # alignment overlaps. Records arrive in coordinate (= voffset)
        # order, so first-wins == min within the batch; values from
        # earlier batches are smaller still, so set-if-unset keeps them.
        lo = begs >> LINEAR_SHIFT
        hi = np.maximum(ends - 1, begs) >> LINEAR_SHIFT
        cnt = hi - lo + 1
        tot = int(cnt.sum())
        wins = np.repeat(lo, cnt) + (
            np.arange(tot, dtype=np.int64)
            - np.repeat(np.cumsum(cnt) - cnt, cnt)
        )
        m = int(hi.max()) + 1
        if m > len(self.linear):
            grow = np.zeros(m, np.int64)
            grow[: len(self.linear)] = self.linear
            self.linear = grow
        # operate on the batch's touched window only: full-index-length
        # temporaries per batch would cost O(n_batches * contig_windows)
        # host work on a 200M-read file — a slice of the per-record-walk
        # overhead this method exists to remove
        w0 = int(lo.min())
        sentinel = np.iinfo(np.int64).max
        cur = np.full(m - w0, sentinel, np.int64)
        np.minimum.at(cur, wins - w0, np.repeat(v_begs, cnt))
        head = self.linear[w0:m]
        self.linear[w0:m] = np.where(
            (head == 0) & (cur != sentinel), cur, head
        )


def _build_refs(path: str, binner, max_coord: int, fmt: str):
    """Shared index-builder core: one sequential scan accumulating
    per-reference bins/linear/metadata, parameterized over the bin
    function so BAI (fixed 5-level reg2bin) and CSI (io/csi.py,
    min_shift/depth-generalized) share every other line.

    Returns (refs, n_ref, n_no_coor). Raises ValueError if records are
    not coordinate-sorted (an index over unsorted data would silently
    serve wrong regions) or a contig exceeds max_coord.
    """
    from duplexumiconsensusreads_torch.io.bam import FLAG_UNMAPPED
    from duplexumiconsensusreads_torch.io.index import _record_offsets, _scan_blocks
    from duplexumiconsensusreads_torch.runtime.stream import BamStreamReader

    # voffset mapping happens batched below: global decompressed offset
    # u -> ((c_off[block(u)] << 16) | (u - cum_u[block(u)])), clamped so
    # u == total size maps to the trailing block at offset 0 (the
    # conventional end-of-data virtual offset)
    c_off, cum_u = _scan_blocks(path)

    reader = BamStreamReader(path)
    refs: list[_RefIndex] = []
    n_no_coor = 0
    last_key = -1
    n_ref = 0
    try:
        header = reader.header  # parsed by the reader's constructor
        n_ref = len(header.ref_names)
        # a contig longer than the binning scheme's address space would
        # silently index wrong regions. Refuse loudly; for BAI (2^29,
        # 512 Mbp — some plant/amphibian genomes exceed it) the CSI
        # format is the spec's answer and io/csi.py sizes its depth to
        # fit any contig.
        for nm, ln in zip(header.ref_names, header.ref_lengths):
            if ln > max_coord:
                raise ValueError(
                    f"{path}: contig {nm!r} length {ln} exceeds the "
                    f"{fmt} format's {max_coord} coordinate limit"
                    + (
                        "; this file needs a CSI index "
                        "(duplexumi index --csi)"
                        if fmt == "BAI"
                        else ""
                    )
                )
        refs = [_RefIndex() for _ in range(n_ref)]
        while True:
            raw = reader.read_raw_records(8192)
            if raw is None:
                break
            offs = _record_offsets(raw)
            base = reader._consumed - len(raw)
            # fully vectorised per batch: field extraction, voffset
            # mapping, sortedness check, CIGAR reference-length
            # reduction, bin assignment, and bins/linear accumulation
            # (per-record Python here cost minutes on 1M+ records)
            b8 = np.frombuffer(raw, np.uint8)

            def _i32(field_off):
                o = offs + field_off
                return (
                    b8[o].astype(np.int64)
                    | (b8[o + 1].astype(np.int64) << 8)
                    | (b8[o + 2].astype(np.int64) << 16)
                    | (b8[o + 3].astype(np.int64) << 24)
                ).astype(np.int32)

            bszs = _i32(0).astype(np.int64)
            ref_ids = _i32(4)
            poss = _i32(8)
            l_names = b8[offs + 12].astype(np.int64)
            n_cigs = b8[offs + 16].astype(np.int64) | (
                b8[offs + 17].astype(np.int64) << 8
            )
            unm = (b8[offs + 18].astype(np.int64) & FLAG_UNMAPPED) != 0
            g_beg = base + offs
            g_end = g_beg + 4 + bszs
            bi_beg = np.minimum(
                np.searchsorted(cum_u, g_beg, side="right") - 1, len(c_off) - 1
            )
            bi_end = np.minimum(
                np.searchsorted(cum_u, g_end, side="right") - 1, len(c_off) - 1
            )
            v_begs = (c_off[bi_beg] << 16) | (g_beg - cum_u[bi_beg])
            v_ends = (c_off[bi_end] << 16) | (g_end - cum_u[bi_end])
            keys = (ref_ids.astype(np.int64) << 34) | (poss.astype(np.int64) + 1)

            if np.any(ref_ids >= n_ref):
                bad = int(ref_ids[ref_ids >= n_ref][0])
                raise ValueError(f"{path}: record ref_id {bad} out of range")
            placed = ref_ids >= 0
            n_no_coor += int((~placed).sum())
            pidx = np.nonzero(placed)[0]
            if not len(pidx):
                continue
            pk = keys[pidx]
            mono = np.r_[pk[0] >= last_key, np.diff(pk) >= 0]
            if not mono.all():
                k = pidx[int(np.nonzero(~mono)[0][0])]
                raise ValueError(
                    f"{path}: not coordinate-sorted (ref {int(ref_ids[k])} "
                    f"pos {int(poss[k])} after a later record) — BAI "
                    f"requires SO:coordinate"
                )
            last_key = int(pk[-1])

            # reference-consumed length per record: one flat gather of
            # every CIGAR op in the batch, reduced back per record
            pn_cig = n_cigs[pidx]
            ref_len = np.zeros(len(pidx), np.int64)
            tot = int(pn_cig.sum())
            if tot:
                rec_of = np.repeat(np.arange(len(pidx)), pn_cig)
                within = np.arange(tot, dtype=np.int64) - np.repeat(
                    np.cumsum(pn_cig) - pn_cig, pn_cig
                )
                op_off = (offs + 36 + l_names)[pidx][rec_of] + 4 * within
                ops = (
                    b8[op_off].astype(np.uint32)
                    | (b8[op_off + 1].astype(np.uint32) << 8)
                    | (b8[op_off + 2].astype(np.uint32) << 16)
                    | (b8[op_off + 3].astype(np.uint32) << 24)
                )
                consume = (_REF_CONSUME_MASK >> (ops & 0xF).astype(np.int64)) & 1
                ref_len = np.bincount(
                    rec_of, weights=((ops >> 4).astype(np.int64) * consume),
                    minlength=len(pidx),
                ).astype(np.int64)

            # spec-legal placed-but-positionless records (ref_id set,
            # pos -1) clamp to 0, matching the serializers' own bin
            # computation (io/bam.py max(pos, 0))
            begs = np.maximum(poss[pidx].astype(np.int64), 0)
            ends = begs + np.maximum(ref_len, 1)
            bins_ = binner(begs, ends).astype(np.int64)
            pv_begs, pv_ends = v_begs[pidx], v_ends[pidx]
            punm = unm[pidx]
            pref = ref_ids[pidx]
            # coordinate order => refs appear as runs within the batch
            run = np.r_[0, np.nonzero(pref[1:] != pref[:-1])[0] + 1, len(pref)]
            for s, e in zip(run[:-1], run[1:]):
                refs[int(pref[s])].add_batch(
                    begs[s:e], ends[s:e], bins_[s:e],
                    pv_begs[s:e], pv_ends[s:e], punm[s:e],
                )
    finally:
        reader.close()
    return refs, n_ref, n_no_coor


def build_bai(path: str, bai_path: str | None = None) -> str:
    """Index a coordinate-sorted BAM; returns the .bai path written."""
    from duplexumiconsensusreads_torch.io.bam import _reg2bin_vec

    refs, n_ref, n_no_coor = _build_refs(
        path, _reg2bin_vec, 1 << 29, "BAI"
    )

    out = bytearray()
    out += BAI_MAGIC
    out += struct.pack("<i", n_ref)
    for r in refs:
        meta = r.off_beg >= 0
        out += struct.pack("<i", len(r.bins) + (1 if meta else 0))
        for bin_ in sorted(r.bins):
            chunks = r.bins[bin_]
            out += struct.pack("<Ii", bin_, len(chunks))
            for beg_v, end_v in chunks:
                out += struct.pack("<QQ", beg_v, end_v)
        if meta:
            out += struct.pack("<Ii", METADATA_BIN, 2)
            out += struct.pack("<QQ", r.off_beg, r.off_end)
            out += struct.pack("<QQ", r.n_mapped, r.n_unmapped)
        # backfill linear-index holes with the previous window's offset
        # (htslib convention; readers expect monotone non-zero runs):
        # forward-fill via a running max of last-nonzero indices
        lin = r.linear
        if len(lin):
            idxs = np.where(lin != 0, np.arange(len(lin)), 0)
            np.maximum.accumulate(idxs, out=idxs)
            lin = lin[idxs]
        out += struct.pack("<i", len(lin))
        out += lin.astype("<u8").tobytes()
    out += struct.pack("<Q", n_no_coor)

    import os

    from duplexumiconsensusreads_torch.io.durable import write_durable

    bai_path = bai_path or path + ".bai"
    # per-writer tmp: no shared-tmp races
    return write_durable(bai_path, bytes(out), tmp=f"{bai_path}.tmp.{os.getpid()}")


def reg2bins(beg: int, end: int) -> list[int]:
    """All bins that MAY hold alignments overlapping [beg, end) — the
    SAM spec §5.3 candidate-bin enumeration (the query-side dual of
    reg2bin)."""
    end -= 1
    bins = [0]
    for shift, off in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
        bins.extend(range(off + (beg >> shift), off + (end >> shift) + 1))
    return bins


def query_start_voffset(idx: dict, ref_id: int, beg: int, end: int) -> int | None:
    """The virtual offset to start scanning for alignments overlapping
    [beg, end) on ref_id, from a read_bai() index: the minimum chunk
    begin across candidate bins, floored by the linear-index window
    (htslib's query strategy). None when the reference holds nothing
    relevant. The file is coordinate-sorted, so ONE seek + a forward
    scan that stops at the first record starting >= end is a complete
    query."""
    if ref_id < 0 or ref_id >= idx["n_ref"]:
        return None
    ref = idx["refs"][ref_id]
    if ref["meta"] is None and not ref["bins"]:
        return None
    lin = ref["linear"]
    w = beg >> LINEAR_SHIFT
    min_lin = lin[min(w, len(lin) - 1)] if lin else 0
    # every overlapping alignment lives in a candidate bin (reg2bins is
    # the dual of reg2bin), so no candidate chunks => nothing to find.
    # The linear floor CLAMPS the start (a candidate chunk may begin
    # before it, holding earlier irrelevant records) — skipping such
    # chunks instead of clamping would jump past relevant records.
    best = None
    for b in reg2bins(beg, end):
        for beg_v, _end_v in ref["bins"].get(b, ()):
            if best is None or beg_v < best:
                best = beg_v
    if best is None:
        return None
    return max(best, min_lin)


def read_bai(path: str) -> dict:
    """Parse a .bai into {n_ref, refs: [{bins: {bin: [(beg, end), ...]},
    linear: [...], meta: (off_beg, off_end, n_mapped, n_unmapped) | None}],
    n_no_coor} — the test-side inverse of build_bai, also usable to
    sanity-check third-party indexes."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != BAI_MAGIC:
        raise ValueError(f"{path}: not a BAI file")
    try:
        return _parse_bai(path, data)
    except (struct.error, IndexError) as e:
        # truncated/corrupt index must fail loudly with the path, never
        # leak a bare struct.error (or an IndexError from a malformed
        # chunk list) — the repo-wide truncation discipline
        raise ValueError(f"{path}: truncated or corrupt BAI: {e}") from e


def _parse_bai(path: str, data: bytes) -> dict:
    off = 4
    (n_ref,) = struct.unpack_from("<i", data, off)
    off += 4
    refs = []
    for _ in range(n_ref):
        (n_bin,) = struct.unpack_from("<i", data, off)
        off += 4
        bins: dict[int, list[tuple[int, int]]] = {}
        meta = None
        for _ in range(n_bin):
            bin_, n_chunk = struct.unpack_from("<Ii", data, off)
            off += 8
            chunks = []
            for _ in range(n_chunk):
                beg_v, end_v = struct.unpack_from("<QQ", data, off)
                off += 16
                chunks.append((beg_v, end_v))
            if bin_ == METADATA_BIN:
                # exactly 2 chunks by construction (file range +
                # mapped/unmapped counts); see the CSI twin
                if n_chunk != 2:
                    raise ValueError(
                        f"{path}: truncated or corrupt BAI: metadata "
                        f"pseudo-bin has {n_chunk} chunks (expected 2)"
                    )
                meta = (*chunks[0], *chunks[1])
            else:
                bins[bin_] = chunks
        (n_intv,) = struct.unpack_from("<i", data, off)
        off += 4
        linear = list(struct.unpack_from(f"<{n_intv}Q", data, off))
        off += 8 * n_intv
        refs.append({"bins": bins, "linear": linear, "meta": meta})
    n_no_coor = struct.unpack_from("<Q", data, off)[0] if off + 8 <= len(data) else 0
    return {"n_ref": n_ref, "refs": refs, "n_no_coor": n_no_coor}
