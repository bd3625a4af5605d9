"""Fast BAM → ReadBatch path using the native loader (native/).

The C++ library decompresses BGZF blocks in parallel and extracts
record fields straight into preallocated NumPy buffers; this module
does only vectorised post-processing (UMI char→code mapping, duplex
strand derivation + canonical pair swap, pos_key packing — the same
contract io/convert.py documents). A copy of the JAX package's
io/native_reader.py; here the library comes from this package's
native/ and a failed build raises (io.load_input picks the portable
codec only under DUT_NO_NATIVE=1).

The native path intentionally skips read names / cigars / full aux
blobs — it feeds the compute pipeline, which needs none of them. Use
io.read_bam for full-fidelity parsing.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from duplexumiconsensusreads_torch.io.bam import (
    FLAG_PAIRED,
    FLAG_READ1,
    FLAG_READ2,
    FLAG_REVERSE,
    BamHeader,
    consensus_excluded,
)
from duplexumiconsensusreads_torch.io.convert import pack_pos_key
from duplexumiconsensusreads_torch.types import ReadBatch

_CHAR_CODE = np.full(256, 255, np.uint8)
for _i, _c in enumerate(b"ACGT"):
    _CHAR_CODE[_c] = _i
for _i, _c in enumerate(b"acgt"):  # Python codec upper()s, so must we
    _CHAR_CODE[_c] = _i
_SEP = ord("-")


def _parse_header_region(data: bytes, header_end: int) -> BamHeader:
    (l_text,) = struct.unpack_from("<i", data, 4)
    text = data[8 : 8 + l_text].split(b"\x00", 1)[0].decode("utf-8")
    off = 8 + l_text
    (n_ref,) = struct.unpack_from("<i", data, off)
    off += 4
    names, lengths = [], []
    for _ in range(n_ref):
        (l_name,) = struct.unpack_from("<i", data, off)
        off += 4
        names.append(data[off : off + l_name - 1].decode("ascii"))
        off += l_name
        (l_ref,) = struct.unpack_from("<i", data, off)
        off += 4
        lengths.append(l_ref)
    return BamHeader(text=text, ref_names=names, ref_lengths=lengths)


def scan_region(lib, data: np.ndarray, what: str = "BAM"):
    """One native scan pass over an uncompressed BAM byte region.

    Returns (header_end, l_max, rx_max, rec_off). The offsets buffer is
    sized at the minimum-record-size upper bound (block_size field 4B +
    fixed fields 32B + 1 name byte) so counting and offset collection
    don't walk the region twice.
    """
    header_end = ctypes.c_long()
    l_max = ctypes.c_int()
    rx_max = ctypes.c_int()
    rec_off = np.empty(max(len(data) // 37, 1), np.int64)
    n_rec = lib.dut_bam_scan(
        data, len(data), ctypes.byref(header_end),
        ctypes.byref(l_max), ctypes.byref(rx_max),
        rec_off.ctypes.data_as(ctypes.c_void_p),
    )
    if n_rec < 0:
        raise ValueError(f"{what}: malformed BAM")
    return (
        int(header_end.value),
        int(l_max.value),
        int(rx_max.value),
        rec_off[:n_rec],
    )


def _gather_i32(data: np.ndarray, starts: np.ndarray, field_off: int) -> np.ndarray:
    """Vectorised little-endian i32 reads at starts+field_off (unaligned)."""
    idx = starts[:, None] + (field_off + np.arange(4))[None, :]
    return np.ascontiguousarray(data[idx]).view("<i4")[:, 0]


def region_pos_keys(data: np.ndarray, rec_off: np.ndarray) -> np.ndarray:
    """Canonical fragment pos_key per record, straight from raw record
    bytes — byte-identical to io.convert.records_pos_keys (the grouping
    key the streaming chunker's family-integrity guarantee rides on)."""
    if len(rec_off) == 0:
        return np.zeros(0, np.int64)
    body = rec_off + 4  # skip the block_size field
    ref_id = _gather_i32(data, body, 0)
    pos = _gather_i32(data, body, 4)
    flag_word = _gather_i32(data, body, 12)  # n_cigar_op(16) | flag(16)
    flags = (flag_word >> 16) & 0xFFFF
    next_ref = _gather_i32(data, body, 20)
    next_pos = _gather_i32(data, body, 24)
    from duplexumiconsensusreads_torch.io.bam import FLAG_PAIRED as _FP

    paired_ok = ((flags & _FP) != 0) & (next_ref == ref_id) & (next_pos >= 0)
    coord = np.where(paired_ok, np.minimum(pos, next_pos), pos)
    return pack_pos_key(ref_id, coord)


def read_bam_native(
    path: str,
    duplex: bool = True,
    n_threads: int | None = None,
    warn_mixed: bool = True,
) -> tuple[BamHeader, ReadBatch, dict]:
    """Parse a BAM file via the native loader (built at first use;
    raises if it cannot be)."""
    from duplexumiconsensusreads_torch.native import N_THREADS, get_lib

    lib = get_lib()
    nt = n_threads or N_THREADS

    with open(path, "rb") as f:
        raw = np.frombuffer(f.read(), np.uint8)

    if len(raw) >= 2 and raw[0] == 0x1F and raw[1] == 0x8B:
        usize = lib.dut_bgzf_usize(raw, len(raw))
        if usize < 0:
            raise ValueError(f"{path}: malformed BGZF")
        data = np.empty(usize, np.uint8)
        if lib.dut_bgzf_decompress(raw, len(raw), data, usize, nt) != usize:
            raise ValueError(f"{path}: BGZF decompression failed")
    else:
        data = raw.copy()

    header_end, l_max, rx_max, rec_off = scan_region(lib, data, path)
    header = _parse_header_region(data[:header_end].tobytes(), header_end)
    batch, info = batch_from_offsets(
        lib, data, rec_off, l_max, rx_max, duplex=duplex, n_threads=nt,
        warn_mixed=warn_mixed,
    )
    return header, batch, info


def _cigar_at(data: np.ndarray, off: int):
    """Parse ONE record's CIGAR ops from the raw uncompressed bytes —
    used only for the few modal-vote minority reads the soft-clip
    rescue inspects, so a per-record Python parse is fine (the bulk
    path never touches cigars, by design)."""
    import struct as _struct

    from duplexumiconsensusreads_torch.io.bam import _CIGAR_OPS

    # operate on the ndarray through the buffer protocol — no copy of
    # the (large) decompressed chunk
    l_rn = int(data[off + 12])
    (n_cig,) = _struct.unpack_from("<H", data, off + 16)
    if not n_cig:
        return []
    ops = np.frombuffer(data, "<u4", n_cig, off + 36 + l_rn)
    return [(int(v) >> 4, _CIGAR_OPS[int(v) & 0xF]) for v in ops]


def batch_from_offsets(
    lib,
    data: np.ndarray,
    rec_off: np.ndarray,
    l_max: int,
    rx_max: int,
    duplex: bool,
    n_threads: int,
    warn_mixed: bool = True,
) -> tuple[ReadBatch, dict]:
    """Native fill + vectorised ReadBatch assembly for the records at
    ``rec_off`` within ``data`` (uncompressed BAM bytes). l_max/rx_max
    are capacity hints from scan_region (may cover a superset of the
    records; widths are sliced back to the actual maxima below)."""
    nt = n_threads
    # Allocation width stays >=1 so the ctypes buffers have real
    # storage; seq/qual are sliced back to the true l_max below so a
    # record-less / sequence-less file matches the Python codec's
    # zero-width batch exactly.
    n, l, rx_cap = len(rec_off), max(int(l_max), 1), max(int(rx_max), 1)
    flags = np.empty(n, np.uint16)
    ref_id = np.empty(n, np.int32)
    pos = np.empty(n, np.int32)
    next_ref = np.empty(n, np.int32)
    next_pos = np.empty(n, np.int32)
    lseq = np.empty(n, np.int32)
    seq = np.empty((n, l), np.uint8)
    qual = np.empty((n, l), np.uint8)
    rx = np.empty((n, rx_cap), np.uint8)
    cig_hash = np.empty(n, np.uint64)
    rec_off = np.ascontiguousarray(rec_off)
    rc = lib.dut_bam_fill(
        data, len(data), rec_off, n, l, rx_cap, nt,
        flags, ref_id, pos, next_ref, next_pos, lseq, seq, qual, rx,
        cig_hash,
    )
    if rc != 0:
        raise ValueError("BAM record fill failed")

    # width = the actual max over THESE records (a superset capacity
    # hint from scan_region must not widen the batch)
    actual_l = int(lseq.max()) if n else 0
    if actual_l < l:
        seq = seq[:, :actual_l]
        qual = qual[:, :actual_l]

    # --- vectorised ReadBatch assembly (contract: io/convert.py) ---
    # Mirror the Python codec's semantics exactly: flag-excluded reads
    # (unmapped/secondary/supplementary/qcfail) are invalid and touch
    # nothing else; a read is "parseable" iff it has a non-empty RX
    # whose non-separator chars are all ACGT (case-insensitive);
    # umi_len is the max over PARSEABLE NON-EXCLUDED reads only (an
    # unparseable long RX must not inflate it); parseable reads of a
    # different length are dropped as length-inconsistent. An RX of
    # only separators gives n_umi_chars == 0 — such reads are valid
    # exactly when umi_len == 0, as in the Python codec.
    excluded = consensus_excluded(flags, ref_id)
    codes_all = _CHAR_CODE[rx]
    has_char = rx != 0
    is_umi_char = (rx != _SEP) & has_char
    n_umi_chars = is_umi_char.sum(axis=1)
    has_rx = has_char.any(axis=1)
    bad_char = ((codes_all == 255) & is_umi_char).any(axis=1)
    parseable = has_rx & ~bad_char
    counted = parseable & ~excluded
    umi_len = int(n_umi_chars[counted].max()) if counted.any() else 0
    valid = counted & (n_umi_chars == umi_len)

    umi_codes = np.zeros((n, umi_len), np.uint8)
    if umi_len:
        vidx = np.nonzero(valid)[0]
        layout = is_umi_char[vidx]
        if len(layout) and (layout == layout[0]).all():
            # fast path: identical RX layout on every valid read
            cols = np.nonzero(layout[0])[0]
            umi_codes[vidx] = codes_all[np.ix_(vidx, cols)]
        else:
            for i in vidx:
                umi_codes[i] = codes_all[i][is_umi_char[i]]

    f = flags.astype(np.int64)
    paired = (f & FLAG_PAIRED) != 0
    rev = (f & FLAG_REVERSE) != 0
    r1 = (f & FLAG_READ1) != 0
    r2 = (f & FLAG_READ2) != 0
    top = np.where(paired, r1 != rev, ~rev)
    # fragment-end bit — must mirror records_to_readbatch exactly
    frag_end = paired & (r2 == top)

    if duplex and umi_len:
        h = umi_len // 2
        ba = ~top & valid
        umi_codes[ba] = np.concatenate(
            [umi_codes[ba][:, h:], umi_codes[ba][:, :h]], axis=1
        )

    paired_ok = paired & (next_ref == ref_id) & (next_pos >= 0)
    coord = np.where(paired_ok, np.minimum(pos, next_pos), pos)
    pos_key = pack_pos_key(ref_id, coord)

    # CIGAR/indel policy — must mirror records_to_readbatch exactly
    from duplexumiconsensusreads_torch.io.convert import modal_cigar_keep

    # mixed-mate detection BEFORE the CIGAR filter (mates often differ
    # in soft-clips; the modal filter would hide exactly these)
    from duplexumiconsensusreads_torch.io.convert import warn_mixed_mates

    n_mixed, mixed_present = warn_mixed_mates(
        flags, pos_key, umi_codes, top & valid, valid, warn=warn_mixed
    )

    valid_pre = valid  # pre-CIGAR mask: keeps the drop counters disjoint
    keep = modal_cigar_keep(pos_key, umi_codes, valid, cig_hash, top)
    from duplexumiconsensusreads_torch.io.convert import softclip_rescue

    rescue_info = softclip_rescue(
        seq, qual, keep, valid, pos_key, umi_codes, top, pos,
        lambda i: _cigar_at(data, int(rec_off[i])),
    )
    valid = valid & keep
    n_cigar = int(valid_pre.sum()) - int(valid.sum())

    batch = ReadBatch(
        bases=seq,
        quals=qual,
        umi=umi_codes,
        pos_key=pos_key,
        strand_ab=top & valid,  # invalid rows keep the codec's False default
        frag_end=frag_end & valid,
        valid=valid,
    )
    info = {
        "n_records": n,
        "n_valid": int(valid.sum()),
        "n_dropped_no_umi": int((~parseable & ~excluded).sum()),
        "n_dropped_umi_len": int((counted & ~valid_pre).sum()),
        "n_dropped_flag": int(excluded.sum()),
        "n_dropped_cigar": n_cigar,
        **rescue_info,
        "n_mixed_mate_families": n_mixed,
        "mixed_mates": mixed_present,
        "umi_len": umi_len,
        "native": True,
    }
    return batch, info
