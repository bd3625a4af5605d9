"""Standard CSI (coordinate-sorted index) writer/reader — SAM spec §5.

The BAI format's R-tree addresses coordinates below 2^29 (512 Mbp);
longer contigs (some plant/amphibian genomes) need the CSI
generalization: the same binning scheme parameterized by ``min_shift``
(smallest bin width, 2^min_shift) and ``depth`` (tree levels), with the
linear index folded into a per-bin ``loffset``. This module writes and
queries CSI with depth sized automatically so any contig in the header
fits, sharing the batched scan core (``io/bai.py:_build_refs``) with
the BAI writer — one vectorised pass, no per-record Python.

Layout (little-endian), per the published spec / htslib:

    magic "CSI\\1"
    int32 min_shift, int32 depth, int32 l_aux, uint8 aux[l_aux]
    int32 n_ref
    per ref:  int32 n_bin
      per bin: uint32 bin, uint64 loffset, int32 n_chunk,
               { uint64 chunk_beg, uint64 chunk_end } * n_chunk
    uint64 n_no_coor

The metadata pseudo-bin is ``n_bins + 1`` where
``n_bins = ((1 << 3*(depth+1)) - 1) // 7`` (37450 at depth 5 —
consistent with BAI's fixed constant).

The layout authority is the published SAM/BAM specification. A copy
of the JAX package's io/csi.py, importing this package's modules.
"""

from __future__ import annotations

import struct

import numpy as np

CSI_MAGIC = b"CSI\x01"
DEFAULT_MIN_SHIFT = 14


def _n_bins(depth: int) -> int:
    return ((1 << (3 * (depth + 1))) - 1) // 7


def _level_offset(level: int) -> int:
    """First bin number of a tree level (level 0 = root)."""
    return ((1 << (3 * level)) - 1) // 7


def depth_for(max_len: int, min_shift: int = DEFAULT_MIN_SHIFT) -> int:
    """Smallest depth whose address space 2^(min_shift + 3*depth) covers
    max_len, floored at the BAI-equivalent 5."""
    depth = 5
    while max_len > (1 << (min_shift + 3 * depth)):
        depth += 1
    return depth


def reg2bin_vec(
    begs: np.ndarray, ends: np.ndarray, min_shift: int, depth: int
) -> np.ndarray:
    """Vectorised generalized reg2bin: the smallest bin fully containing
    each [beg, end). Mirrors htslib's hts_reg2bin level walk."""
    b = np.asarray(begs, np.int64)
    e = np.maximum(np.asarray(ends, np.int64) - 1, b)
    out = np.zeros(len(b), np.int64)  # root bin when no level contains
    done = np.zeros(len(b), bool)
    s = min_shift
    t = _level_offset(depth)
    for level in range(depth, 0, -1):
        hit = ~done & ((b >> s) == (e >> s))
        out[hit] = t + (b[hit] >> s)
        done |= hit
        s += 3
        t -= 1 << (3 * (level - 1))
    return out


def reg2bins(beg: int, end: int, min_shift: int, depth: int) -> list[int]:
    """All bins that MAY hold alignments overlapping [beg, end) — the
    query-side dual of reg2bin, generalized."""
    end -= 1
    bins = []
    for level in range(depth + 1):
        t = _level_offset(level)
        s = min_shift + 3 * (depth - level)
        bins.extend(range(t + (beg >> s), t + (end >> s) + 1))
    return bins


def build_csi(
    path: str,
    csi_path: str | None = None,
    min_shift: int = DEFAULT_MIN_SHIFT,
    depth: int | None = None,
) -> str:
    """Index a coordinate-sorted BAM as CSI; returns the path written.

    depth=None sizes the tree from the longest header contig (>= 5, the
    BAI-equivalent). The builder shares io/bai.py's scan core, so the
    sortedness and ref_id validations are identical.
    """
    from duplexumiconsensusreads_torch.io.bai import LINEAR_SHIFT, _build_refs
    from duplexumiconsensusreads_torch.runtime.stream import BamStreamReader

    if depth is None:
        rdr = BamStreamReader(path)
        try:
            max_len = max(
                [int(x) for x in rdr.header.ref_lengths], default=0
            )
        finally:
            rdr.close()
        depth = depth_for(max_len, min_shift)
    max_coord = 1 << (min_shift + 3 * depth)

    refs, n_ref, n_no_coor = _build_refs(
        path,
        lambda b, e: reg2bin_vec(b, e, min_shift, depth),
        max_coord,
        "CSI",
    )
    meta_bin = _n_bins(depth) + 1

    out = bytearray()
    out += CSI_MAGIC
    out += struct.pack("<iii", min_shift, depth, 0)  # no aux payload
    out += struct.pack("<i", n_ref)
    for r in refs:
        meta = r.off_beg >= 0
        out += struct.pack("<i", len(r.bins) + (1 if meta else 0))
        # loffset per bin from the shared linear accumulation: the bin's
        # first min_shift window, forward-filled the BAI way. The scan
        # core accumulates linear at LINEAR_SHIFT windows; CSI folds
        # that into bins instead of a separate array.
        lin = r.linear
        if len(lin):
            idxs = np.where(lin != 0, np.arange(len(lin)), 0)
            np.maximum.accumulate(idxs, out=idxs)
            lin = lin[idxs]
        for bin_ in sorted(r.bins):
            # bin -> its level (largest with level_offset <= bin), then
            # its first coordinate window
            level = depth
            while _level_offset(level) > bin_:
                level -= 1
            k = bin_ - _level_offset(level)
            first_coord = k << (min_shift + 3 * (depth - level))
            w = first_coord >> LINEAR_SHIFT
            loffset = int(lin[min(w, len(lin) - 1)]) if len(lin) else 0
            chunks = r.bins[bin_]
            out += struct.pack("<IQi", bin_, loffset, len(chunks))
            for beg_v, end_v in chunks:
                out += struct.pack("<QQ", beg_v, end_v)
        if meta:
            out += struct.pack("<IQi", meta_bin, 0, 2)
            out += struct.pack("<QQ", r.off_beg, r.off_end)
            out += struct.pack("<QQ", r.n_mapped, r.n_unmapped)
    out += struct.pack("<Q", n_no_coor)

    import os

    from duplexumiconsensusreads_torch.io.durable import write_durable

    csi_path = csi_path or path + ".csi"
    # per-writer tmp: no shared-tmp races
    return write_durable(csi_path, bytes(out), tmp=f"{csi_path}.tmp.{os.getpid()}")


def read_csi(path: str) -> dict:
    """Parse a .csi into {min_shift, depth, n_ref, refs: [{bins:
    {bin: [(beg, end), ...]}, loffsets: {bin: loffset}, meta}],
    n_no_coor} — the query/test-side inverse of build_csi."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != CSI_MAGIC:
        raise ValueError(f"{path}: not a CSI file")
    try:
        return _parse_csi(path, data)
    except (struct.error, IndexError) as e:
        # truncated/corrupt index must fail loudly with the path, never
        # leak a bare struct.error (or an IndexError from a malformed
        # chunk list) — the repo-wide truncation discipline
        raise ValueError(f"{path}: truncated or corrupt CSI: {e}") from e


def _parse_csi(path: str, data: bytes) -> dict:
    min_shift, depth, l_aux = struct.unpack_from("<iii", data, 4)
    off = 16 + l_aux
    (n_ref,) = struct.unpack_from("<i", data, off)
    off += 4
    meta_bin = _n_bins(depth) + 1
    refs = []
    for _ in range(n_ref):
        (n_bin,) = struct.unpack_from("<i", data, off)
        off += 4
        bins: dict[int, list[tuple[int, int]]] = {}
        loffsets: dict[int, int] = {}
        meta = None
        for _ in range(n_bin):
            bin_, loffset, n_chunk = struct.unpack_from("<IQi", data, off)
            off += 16
            chunks = []
            for _ in range(n_chunk):
                beg_v, end_v = struct.unpack_from("<QQ", data, off)
                off += 16
                chunks.append((beg_v, end_v))
            if bin_ == meta_bin:
                # the htslib metadata pseudo-bin carries exactly 2
                # chunks (file range + mapped/unmapped counts); any
                # other count is corruption, and chunks[1] below would
                # otherwise escape as a bare IndexError
                if n_chunk != 2:
                    raise ValueError(
                        f"{path}: truncated or corrupt CSI: metadata "
                        f"pseudo-bin has {n_chunk} chunks (expected 2)"
                    )
                meta = (*chunks[0], *chunks[1])
            else:
                bins[bin_] = chunks
                loffsets[bin_] = loffset
        refs.append({"bins": bins, "loffsets": loffsets, "meta": meta})
    n_no_coor = (
        struct.unpack_from("<Q", data, off)[0] if off + 8 <= len(data) else 0
    )
    return {
        "min_shift": min_shift,
        "depth": depth,
        "n_ref": n_ref,
        "refs": refs,
        "n_no_coor": n_no_coor,
    }


def query_start_voffset_csi(
    idx: dict, ref_id: int, beg: int, end: int
) -> int | None:
    """Virtual offset to start scanning for alignments overlapping
    [beg, end) from a read_csi() index — the CSI analogue of
    io/bai.py:query_start_voffset: minimum candidate-chunk begin,
    floored by the deepest existing containing bin's loffset (which is
    the linear value of beg's window, or an ancestor's — always <= the
    first overlapping record's offset, so the one-seek forward scan
    stays complete)."""
    if ref_id < 0 or ref_id >= idx["n_ref"]:
        return None
    ref = idx["refs"][ref_id]
    if ref["meta"] is None and not ref["bins"]:
        return None
    min_shift, depth = idx["min_shift"], idx["depth"]
    best = None
    for b in reg2bins(beg, end, min_shift, depth):
        for beg_v, _end_v in ref["bins"].get(b, ()):
            if best is None or beg_v < best:
                best = beg_v
    if best is None:
        return None
    floor = 0
    for level in range(depth, -1, -1):
        b = _level_offset(level) + (
            beg >> (min_shift + 3 * (depth - level))
        )
        if b in ref["loffsets"]:
            floor = ref["loffsets"][b]
            break
    return max(best, floor)
