"""Minimal BAM reader/writer over the BGZF codec.

Implements the BAM binary layout (SAM spec §4) directly — magic,
header text, reference dictionary, and alignment records — producing a
struct-of-arrays ``BamRecords`` that converts losslessly into the
framework's padded ``ReadBatch`` tensors (io/convert.py).

Scope notes (deliberate, documented):
- CIGAR ops are parsed and preserved round-trip but consensus math
  operates on raw cycles for same-length family members, the fgbio-style
  default chosen in SURVEY.md §7 ("Hard parts" item 4 — the reference
  mount is empty, so cycle-space consensus is the contract default).
- Aux tags: RX (UMI) is interpreted; all other tags are preserved as
  raw bytes per record so nothing is lost on passthrough.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

from duplexumiconsensusreads_torch.io import bgzf

BAM_MAGIC = b"BAM\x01"

# BAM 4-bit base codes "=ACMGRSVTWYHKDBN" → framework codes (A=0 C=1
# G=2 T=3, everything ambiguous → N=4).
_NIBBLE_TO_CODE = np.full(16, 4, np.uint8)
_NIBBLE_TO_CODE[1] = 0  # A
_NIBBLE_TO_CODE[2] = 1  # C
_NIBBLE_TO_CODE[4] = 2  # G
_NIBBLE_TO_CODE[8] = 3  # T
_CODE_TO_NIBBLE = np.array([1, 2, 4, 8, 15, 15], np.uint8)  # A C G T N PAD→N

FLAG_PAIRED = 0x1
FLAG_PROPER_PAIR = 0x2
FLAG_UNMAPPED = 0x4
FLAG_MATE_UNMAPPED = 0x8
FLAG_REVERSE = 0x10
FLAG_MATE_REVERSE = 0x20
FLAG_READ1 = 0x40
FLAG_READ2 = 0x80
FLAG_SECONDARY = 0x100
FLAG_QCFAIL = 0x200
FLAG_DUP = 0x400
FLAG_SUPPLEMENTARY = 0x800

# Records carrying any of these flags never enter UMI families:
# unmapped reads have no coordinate; secondary/supplementary alignments
# re-observe a primary record (counting them inflates family depth and
# shifts consensus); QC-fail reads are untrusted. This mirrors the
# conventional fgbio-style input filter. PCR/optical duplicates (0x400)
# are deliberately NOT excluded — duplicate collapse is this tool's job.
FLAG_CONSENSUS_EXCLUDE = FLAG_UNMAPPED | FLAG_SECONDARY | FLAG_QCFAIL | FLAG_SUPPLEMENTARY


def consensus_excluded(flags, ref_id):
    """Exclusion mask shared by BOTH codecs (io/convert.py and
    io/native_reader.py must stay bit-identical — the streaming
    chunker's sentinel flush assumes no excluded record can ever form a
    family). ref_id < 0 is excluded unconditionally, not just via
    FLAG_UNMAPPED: such records map to the UNMAPPED_POS_KEY sentinel."""
    return ((np.asarray(flags).astype(np.int64) & FLAG_CONSENSUS_EXCLUDE) != 0) | (
        np.asarray(ref_id) < 0
    )


@dataclasses.dataclass
class BamHeader:
    text: str
    ref_names: list[str]
    ref_lengths: list[int]

    @staticmethod
    def synthetic(
        ref_names=("chr1",),
        ref_lengths=(10_000_000,),
        extra: str = "",
        sort_order: str = "unsorted",
    ):
        lines = [f"@HD\tVN:1.6\tSO:{sort_order}"]
        for n, l in zip(ref_names, ref_lengths):
            lines.append(f"@SQ\tSN:{n}\tLN:{l}")
        lines.append("@PG\tID:duplexumi\tPN:duplexumiconsensusreads_torch")
        if extra:
            lines.append(extra)
        return BamHeader(
            text="\n".join(lines) + "\n",
            ref_names=list(ref_names),
            ref_lengths=list(ref_lengths),
        )


def set_sort_order(text: str, so: str) -> str:
    """Rewrite (or insert) the @HD line's SO: field."""
    lines = text.rstrip("\n").split("\n") if text.strip() else []
    for i, line in enumerate(lines):
        if line.startswith("@HD"):
            fields = [f for f in line.split("\t") if not f.startswith("SO:")]
            lines[i] = "\t".join(fields + [f"SO:{so}"])
            break
    else:
        lines.insert(0, f"@HD\tVN:1.6\tSO:{so}")
    return "\n".join(lines) + "\n"



def _header_ids(text: str, tag: str) -> tuple[set, str | None]:
    """(all ID: values of @<tag> lines, the LAST one seen) — shared by
    the @PG and @RG uniquification so the parse/suffix logic cannot
    diverge between them."""
    ids: set = set()
    last = None
    for line in (text.rstrip("\n").split("\n") if text.strip() else []):
        if line.startswith(tag):
            for f in line.split("\t")[1:]:
                if f.startswith("ID:"):
                    ids.add(f[3:])
                    last = f[3:]
    return ids, last


def _uniquify(base: str, ids: set) -> str:
    out, k = base, 0
    while out in ids:
        k += 1
        out = f"{base}.{k}"
    return out


def chain_pg(text: str, pn: str = "duplexumiconsensusreads_torch", cl: str | None = None) -> str:
    """Append a new @PG entry chained (PP:) to the last program in the
    existing chain, with a collision-free ID — real pipelines key
    provenance on the @PG chain, so reruns must never clobber it."""
    lines = text.rstrip("\n").split("\n") if text.strip() else []
    ids, last_id = _header_ids(text, "@PG")
    new_id = _uniquify("duplexumi", ids)
    entry = f"@PG\tID:{new_id}\tPN:{pn}"
    if last_id is not None:
        entry += f"\tPP:{last_id}"
    if cl:
        entry += "\tCL:" + cl.replace("\t", " ").replace("\n", " ")
    lines.append(entry)
    return "\n".join(lines) + "\n"


def unique_read_group_id(text: str, rg_id: str) -> str:
    """Collision-free consensus read-group id: if the input header
    already carries @RG ID:<rg_id> (e.g. an fgbio-produced input whose
    consensus group is also 'A'), attributing our consensus records to
    that EXISTING group would silently inherit its SM/LB/PL — so
    uniquify with the same helper chain_pg uses for @PG IDs. Must be
    resolved BEFORE records are built (the RG:Z tags must match the
    final id)."""
    ids, _last = _header_ids(text, "@RG")
    return _uniquify(rg_id, ids)


def add_read_group(text: str, rg_id: str, sample: str | None = None) -> str:
    """Append a consensus @RG line (fgbio-style: one NEW output read
    group; input @RG lines are preserved above it for provenance). The
    sample defaults to the union of input SM values, else the rg id."""
    lines = text.rstrip("\n").split("\n") if text.strip() else []
    sms = []
    for line in lines:
        if line.startswith("@RG"):
            for f in line.split("\t")[1:]:
                if f.startswith("ID:") and f[3:] == rg_id:
                    return "\n".join(lines) + "\n"  # already present
                if f.startswith("SM:") and f[3:] not in sms:
                    sms.append(f[3:])
    sm = sample or (",".join(sms) if sms else rg_id)
    lines.append(f"@RG\tID:{rg_id}\tSM:{sm}")
    return "\n".join(lines) + "\n"


def derive_output_header(
    header: "BamHeader",
    sort_order: str | None = "coordinate",
    rg_id: str | None = None,
    cl: str | None = None,
) -> "BamHeader":
    """The consensus-output header: input text preserved verbatim
    (@SQ/@RG/@CO and the existing @PG chain survive), @HD SO: set to
    the true output order, a new @PG chained, and optionally the
    consensus @RG appended. cl defaults to this process's command line
    (what the @PG CL: field records by convention)."""
    import sys as _sys

    text = header.text
    if sort_order:
        text = set_sort_order(text, sort_order)
    text = chain_pg(text, cl=cl if cl is not None else " ".join(_sys.argv))
    if rg_id:
        text = add_read_group(text, rg_id)
    return BamHeader(
        text=text, ref_names=header.ref_names, ref_lengths=header.ref_lengths
    )


@dataclasses.dataclass
class BamRecords:
    """Struct-of-arrays of N alignment records (host NumPy).

    seq/qual are padded to the max read length; lengths[i] gives the
    real length. umi holds the RX tag string per record ("" if absent).
    aux_raw preserves every record's full aux-tag byte blob.
    """

    names: list[str]
    flags: np.ndarray      # u16 (N,)
    ref_id: np.ndarray     # i32 (N,)
    pos: np.ndarray        # i32 (N,) 0-based
    mapq: np.ndarray       # u8  (N,)
    next_ref_id: np.ndarray  # i32 (N,)
    next_pos: np.ndarray   # i32 (N,)
    tlen: np.ndarray       # i32 (N,)
    lengths: np.ndarray    # i32 (N,)
    seq: np.ndarray        # u8 (N, L) framework base codes, PAD beyond length
    qual: np.ndarray       # u8 (N, L)
    cigars: list[list[tuple[int, str]]]
    umi: list[str]
    aux_raw: list[bytes]

    def __len__(self) -> int:
        return len(self.names)


def reorder_records(recs: "BamRecords", order) -> "BamRecords":
    """Row-permute a BamRecords (e.g. restore coordinate order after
    ref-projected emission moves POS values)."""
    o = np.asarray(order)
    ol = o.tolist()
    return BamRecords(
        names=[recs.names[i] for i in ol],
        flags=np.asarray(recs.flags)[o],
        ref_id=np.asarray(recs.ref_id)[o],
        pos=np.asarray(recs.pos)[o],
        mapq=np.asarray(recs.mapq)[o],
        next_ref_id=np.asarray(recs.next_ref_id)[o],
        next_pos=np.asarray(recs.next_pos)[o],
        tlen=np.asarray(recs.tlen)[o],
        lengths=np.asarray(recs.lengths)[o],
        seq=np.asarray(recs.seq)[o],
        qual=np.asarray(recs.qual)[o],
        cigars=[recs.cigars[i] for i in ol],
        umi=[recs.umi[i] for i in ol],
        aux_raw=[recs.aux_raw[i] for i in ol],
    )


_CIGAR_OPS = "MIDNSHP=X"


def iter_aux_fields(aux: bytes):
    """Yield (field_start, tag, typ, value_start, field_end) for each
    aux field — the ONE walker parse/strip/filter code shares, so a
    type-handling fix can never apply to one consumer and miss another.

    Raises ValueError on any malformation it VISITS (unknown type/
    subtype, any truncation including 1-2 stray trailing bytes).
    Consumers that early-exit once they find their tag (RX extraction,
    the filter's tag reads) deliberately do not visit — hence do not
    validate — fields after it; only full walks (strip_aux_tag, a
    search for an absent tag) check the whole blob."""
    pos, n = 0, len(aux)
    while pos + 3 <= n:
        start = pos
        tag = aux[pos : pos + 2]
        typ = aux[pos + 2 : pos + 3]
        pos += 3
        vstart = pos
        if typ in b"AcC":
            size = 1
        elif typ in b"sS":
            size = 2
        elif typ in b"iIf":
            size = 4
        elif typ in b"ZH":
            try:
                size = aux.index(b"\x00", pos) - pos + 1
            except ValueError:
                raise ValueError(
                    f"unterminated Z/H aux field {tag!r} (no NUL before "
                    f"end of aux block)"
                ) from None
        elif typ == b"B":
            if pos + 5 > n:
                raise ValueError(f"truncated B-array header for tag {tag!r}")
            sub = aux[pos : pos + 1]
            cnt = struct.unpack_from("<I", aux, pos + 1)[0]
            sub_size = {b"c": 1, b"C": 1, b"s": 2, b"S": 2, b"i": 4, b"I": 4, b"f": 4}.get(sub)
            if sub_size is None:
                raise ValueError(f"unknown B-array subtype {sub!r} for tag {tag!r}")
            size = 5 + cnt * sub_size
        else:
            raise ValueError(f"unknown aux tag type {typ!r}")
        pos += size
        if pos > n:
            raise ValueError(
                f"truncated aux field {tag!r}:{typ!r} (needs {pos - n} more bytes)"
            )
        yield start, tag, typ, vstart, pos
    if pos != n:
        # 1-2 stray trailing bytes: a truncated next-field tag, not a
        # valid stream tail — reject like every other truncation point
        raise ValueError(f"trailing {n - pos} stray aux bytes (truncated field)")


def _parse_aux_rx(aux: bytes) -> str:
    """Extract the RX:Z tag from an aux blob (empty string if absent)."""
    for _, tag, typ, vstart, end in iter_aux_fields(aux):
        if tag == b"RX" and typ == b"Z":
            return aux[vstart : end - 1].decode("ascii")
    return ""


def parse_bam(data: bytes) -> tuple[BamHeader, BamRecords]:
    """Parse a BAM byte string (BGZF-compressed or raw) fully."""
    if bgzf.is_bgzf(data):
        data = bgzf.decompress(data)
    if data[:4] != BAM_MAGIC:
        raise ValueError("not a BAM file (bad magic)")
    off = 4
    (l_text,) = struct.unpack_from("<i", data, off)
    off += 4
    text = data[off : off + l_text].split(b"\x00", 1)[0].decode("utf-8")
    off += l_text
    (n_ref,) = struct.unpack_from("<i", data, off)
    off += 4
    ref_names, ref_lengths = [], []
    for _ in range(n_ref):
        (l_name,) = struct.unpack_from("<i", data, off)
        off += 4
        ref_names.append(data[off : off + l_name - 1].decode("ascii"))
        off += l_name
        (l_ref,) = struct.unpack_from("<i", data, off)
        off += 4
        ref_lengths.append(l_ref)
    header = BamHeader(text=text, ref_names=ref_names, ref_lengths=ref_lengths)

    names: list[str] = []
    flags, ref_id, pos_, mapq = [], [], [], []
    next_ref, next_pos, tlen, lengths = [], [], [], []
    seqs: list[np.ndarray] = []
    quals: list[np.ndarray] = []
    cigars: list[list[tuple[int, str]]] = []
    umis: list[str] = []
    aux_raws: list[bytes] = []

    n_total = len(data)
    while off < n_total:
        if off + 4 > n_total:
            raise ValueError("truncated BAM: partial record length field")
        (block_size,) = struct.unpack_from("<i", data, off)
        off += 4
        rec_end = off + block_size
        if block_size < 32 or rec_end > n_total:
            raise ValueError(
                f"truncated/corrupt BAM record at byte {off - 4} "
                f"(block_size={block_size}, {n_total - off} bytes left)"
            )
        (rid, p, l_rn, mq, _bin, n_cig, flag, l_seq, nrid, npos, tl) = struct.unpack_from(
            "<iiBBHHHiiii", data, off
        )
        # l_rn >= 1: the spec's NUL terminator — l_read_name=0 would
        # shift every later field onto garbage instead of failing here
        if l_rn < 1 or l_seq < 0 or 32 + l_rn + 4 * n_cig + (l_seq + 1) // 2 + l_seq > block_size:
            raise ValueError(
                f"corrupt BAM record at byte {off - 4}: fixed fields "
                f"(name {l_rn} + cigar {n_cig} ops + seq {l_seq}) overrun "
                f"block_size {block_size}"
            )
        off += 32
        names.append(data[off : off + l_rn - 1].decode("ascii"))
        off += l_rn
        cig = []
        for _ in range(n_cig):
            (v,) = struct.unpack_from("<I", data, off)
            off += 4
            cig.append((v >> 4, _CIGAR_OPS[v & 0xF]))
        packed = np.frombuffer(data, np.uint8, (l_seq + 1) // 2, off)
        off += (l_seq + 1) // 2
        nib = np.empty(2 * len(packed), np.uint8)
        nib[0::2] = packed >> 4
        nib[1::2] = packed & 0xF
        seqs.append(_NIBBLE_TO_CODE[nib[:l_seq]])
        q = np.frombuffer(data, np.uint8, l_seq, off).copy()
        off += l_seq
        if l_seq and q[0] == 0xFF:
            q[:] = 0
        quals.append(q)
        aux = data[off:rec_end]
        off = rec_end
        flags.append(flag)
        ref_id.append(rid)
        pos_.append(p)
        mapq.append(mq)
        next_ref.append(nrid)
        next_pos.append(npos)
        tlen.append(tl)
        lengths.append(l_seq)
        cigars.append(cig)
        umis.append(_parse_aux_rx(aux))
        aux_raws.append(bytes(aux))

    n = len(names)
    lmax = int(max(lengths, default=0))
    from duplexumiconsensusreads_torch.constants import BASE_PAD

    seq_arr = np.full((n, lmax), BASE_PAD, np.uint8)
    qual_arr = np.zeros((n, lmax), np.uint8)
    for i, (s, q) in enumerate(zip(seqs, quals)):
        seq_arr[i, : len(s)] = s
        qual_arr[i, : len(q)] = q

    recs = BamRecords(
        names=names,
        flags=np.asarray(flags, np.uint16),
        ref_id=np.asarray(ref_id, np.int32),
        pos=np.asarray(pos_, np.int32),
        mapq=np.asarray(mapq, np.uint8),
        next_ref_id=np.asarray(next_ref, np.int32),
        next_pos=np.asarray(next_pos, np.int32),
        tlen=np.asarray(tlen, np.int32),
        lengths=np.asarray(lengths, np.int32),
        seq=seq_arr,
        qual=qual_arr,
        cigars=cigars,
        umi=umis,
        aux_raw=aux_raws,
    )
    return header, recs


def read_bam(path: str) -> tuple[BamHeader, BamRecords]:
    with open(path, "rb") as f:
        return parse_bam(f.read())


def _reg2bin(beg: int, end: int) -> int:
    """SAM spec §5.3 bin computation."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def _reg2bin_vec(beg: np.ndarray, end: np.ndarray) -> np.ndarray:
    """Vectorised _reg2bin (SAM spec §5.3)."""
    end = end - 1
    out = np.zeros(len(beg), np.int64)
    done = np.zeros(len(beg), bool)
    for shift, base in ((14, 4681), (17, 585), (20, 73), (23, 9), (26, 1)):
        hit = ~done & ((beg >> shift) == (end >> shift))
        out[hit] = base + (beg[hit] >> shift)
        done |= hit
    return out


def _scatter_runs(buf, dst_starts, lengths, payload_flat):
    """buf[dst_starts[i] : dst_starts[i]+lengths[i]] = consecutive runs
    of payload_flat — the variable-length scatter at the heart of the
    vectorised serializer."""
    total = int(lengths.sum())
    if total == 0:
        return
    cum = np.concatenate(([0], np.cumsum(lengths)[:-1]))
    idx = np.repeat(dst_starts - cum, lengths) + np.arange(total)
    buf[idx] = payload_flat[:total]


def _slice_recs(recs: BamRecords, a: int, b: int) -> BamRecords:
    return BamRecords(
        **{
            f.name: getattr(recs, f.name)[a:b]
            for f in dataclasses.fields(BamRecords)
        }
    )


def _serialize_records_fast(recs: BamRecords) -> bytes | None:
    """Vectorised record serialization for the dominant shape — every
    record has exactly one CIGAR op 'M' covering its whole sequence
    (all simulator and consensus output records). Returns None when the
    records don't fit that shape (caller falls back to the general
    per-record path). A 30x+ speedup at 10M-read scale."""
    n = len(recs)
    if n == 0:
        return b""
    lengths = np.asarray(recs.lengths, np.int64)
    for c, l in zip(recs.cigars, recs.lengths):
        if len(c) != 1 or c[0][1] != "M" or c[0][0] != l:
            return None
    name_bytes = [s.encode("ascii") + b"\x00" for s in recs.names]
    name_len = np.fromiter((len(b) for b in name_bytes), np.int64, n)
    aux_len = np.fromiter((len(a) for a in recs.aux_raw), np.int64, n)
    seq_b = (lengths + 1) // 2
    if (
        (lengths == lengths[0]).all()
        and (name_len == name_len[0]).all()
        and (aux_len == aux_len[0]).all()
    ):
        return _serialize_uniform(recs, name_bytes, int(name_len[0]), int(aux_len[0]))
    body_len = 32 + name_len + 4 + seq_b + lengths + aux_len
    starts = np.concatenate(([0], np.cumsum(4 + body_len)[:-1]))
    buf = np.zeros(int(starts[-1] + 4 + body_len[-1]), np.uint8)

    def put_i32(off_arr, values):
        idx = off_arr[:, None] + np.arange(4)[None, :]
        buf[idx] = values.astype("<i4").view(np.uint8).reshape(n, 4)

    pos = np.asarray(recs.pos, np.int64)
    put_i32(starts, body_len)
    b = starts + 4
    put_i32(b, np.asarray(recs.ref_id, np.int64))
    put_i32(b + 4, pos)
    b0 = np.maximum(pos, 0)
    e0 = b0 + np.maximum(lengths, 1)
    # BAI reg2bin is only DEFINED below 2^29: past it the leaf formula
    # yields invalid-but-u16-fitting bins (e.g. 41305 at 600 Mbp) that
    # strict validators flag. Write bin=0 for any record touching the
    # out-of-scheme range (htslib convention for CSI-indexed files —
    # no reader trusts the field there).
    bin_ = np.where(e0 > (1 << 29), 0, _reg2bin_vec(b0, e0))
    # l_read_name(u8) mapq(u8) bin(u16) packed little-endian as one i32
    put_i32(b + 8, name_len | (np.asarray(recs.mapq, np.int64) << 8) | (bin_ << 16))
    # n_cigar_op(u16)=1 | flag(u16)
    put_i32(b + 12, 1 | (np.asarray(recs.flags, np.int64) << 16))
    put_i32(b + 16, lengths)
    put_i32(b + 20, np.asarray(recs.next_ref_id, np.int64))
    put_i32(b + 24, np.asarray(recs.next_pos, np.int64))
    put_i32(b + 28, np.asarray(recs.tlen, np.int64))
    name_dst = b + 32
    _scatter_runs(buf, name_dst, name_len, np.frombuffer(b"".join(name_bytes), np.uint8))
    put_i32(name_dst + name_len, (lengths << 4) | 0)  # one M op
    # packed 4-bit seq: framework codes -> BAM nibbles, padded rows
    l_max = recs.seq.shape[1]
    nib = _CODE_TO_NIBBLE[np.minimum(recs.seq, len(_CODE_TO_NIBBLE) - 1)]
    # zero nibbles past each row's length so odd-length padding is 0
    col = np.arange(l_max)[None, :]
    nib = np.where(col < lengths[:, None], nib, 0)
    if l_max % 2:
        nib = np.concatenate([nib, np.zeros((n, 1), np.uint8)], axis=1)
    packed = (nib[:, 0::2] << 4) | nib[:, 1::2]
    w = packed.shape[1]
    pk_idx = (np.repeat(np.arange(n), seq_b) * w) + (
        np.arange(int(seq_b.sum())) - np.repeat(np.concatenate(([0], np.cumsum(seq_b)[:-1])), seq_b)
    )
    _scatter_runs(buf, name_dst + name_len + 4, seq_b, packed.reshape(-1)[pk_idx])
    q_idx = (np.repeat(np.arange(n), lengths) * l_max) + (
        np.arange(int(lengths.sum())) - np.repeat(np.concatenate(([0], np.cumsum(lengths)[:-1])), lengths)
    )
    _scatter_runs(
        buf, name_dst + name_len + 4 + seq_b, lengths,
        np.asarray(recs.qual, np.uint8).reshape(-1)[q_idx],
    )
    _scatter_runs(
        buf, name_dst + name_len + 4 + seq_b + lengths, aux_len,
        np.frombuffer(b"".join(recs.aux_raw), np.uint8),
    )
    return buf.tobytes()


def _serialize_uniform(
    recs: BamRecords, name_bytes: list[bytes], nl: int, al: int
) -> bytes:
    """Fully-uniform record layout (same read length, name width, aux
    width, one M CIGAR op): the whole batch serializes as one (n,
    rec_len) matrix of pure column writes — no per-byte index arrays.
    This is the shape every simulator/consensus writer emits."""
    n = len(recs)
    l = int(recs.lengths[0])
    sb = (l + 1) // 2
    body = 32 + nl + 4 + sb + l + al
    rec_len = 4 + body
    buf = np.empty((n, rec_len), np.uint8)

    def col_i32(off, values):
        buf[:, off : off + 4] = (
            np.ascontiguousarray(values.astype("<i4")).view(np.uint8).reshape(n, 4)
        )

    pos = np.asarray(recs.pos, np.int64)
    col_i32(0, np.full(n, body, np.int64))
    col_i32(4, np.asarray(recs.ref_id, np.int64))
    col_i32(8, pos)
    b0 = np.maximum(pos, 0)
    # past-BAI coords (end > 2^29): bin=0 — see _serialize_records_fast
    bin_ = np.where(
        b0 + max(l, 1) > (1 << 29), 0, _reg2bin_vec(b0, b0 + max(l, 1))
    )
    col_i32(12, nl | (np.asarray(recs.mapq, np.int64) << 8) | (bin_ << 16))
    col_i32(16, 1 | (np.asarray(recs.flags, np.int64) << 16))
    col_i32(20, np.full(n, l, np.int64))
    col_i32(24, np.asarray(recs.next_ref_id, np.int64))
    col_i32(28, np.asarray(recs.next_pos, np.int64))
    col_i32(32, np.asarray(recs.tlen, np.int64))
    buf[:, 36 : 36 + nl] = np.frombuffer(b"".join(name_bytes), np.uint8).reshape(n, nl)
    col_i32(36 + nl, np.full(n, (l << 4) | 0, np.int64))
    o = 40 + nl
    nib = _CODE_TO_NIBBLE[np.minimum(recs.seq[:, :l], len(_CODE_TO_NIBBLE) - 1)]
    if l % 2:
        nib = np.concatenate([nib, np.zeros((n, 1), np.uint8)], axis=1)
    buf[:, o : o + sb] = (nib[:, 0::2] << 4) | nib[:, 1::2]
    buf[:, o + sb : o + sb + l] = np.asarray(recs.qual, np.uint8)[:, :l]
    if al:
        buf[:, o + sb + l :] = np.frombuffer(b"".join(recs.aux_raw), np.uint8).reshape(n, al)
    return buf.tobytes()


def serialize_bam(header: BamHeader, recs: BamRecords) -> bytes:
    """Serialize header + records to uncompressed BAM bytes."""
    out = bytearray()
    out += BAM_MAGIC
    text = header.text.encode("utf-8")
    out += struct.pack("<i", len(text))
    out += text
    out += struct.pack("<i", len(header.ref_names))
    for name, length in zip(header.ref_names, header.ref_lengths):
        nb = name.encode("ascii") + b"\x00"
        out += struct.pack("<i", len(nb)) + nb + struct.pack("<i", length)

    # vectorised path, in row blocks so the scatter index arrays stay
    # bounded (~8 bytes of index per output byte)
    block = 65536
    fast_parts = []
    for s in range(0, max(len(recs), 1), block):
        part = _serialize_records_fast(_slice_recs(recs, s, min(s + block, len(recs))))
        if part is None:
            fast_parts = None
            break
        fast_parts.append(part)
    if fast_parts is not None:
        return bytes(out) + b"".join(fast_parts)

    op_idx = {c: i for i, c in enumerate(_CIGAR_OPS)}
    for i in range(len(recs)):
        name_b = recs.names[i].encode("ascii") + b"\x00"
        l_seq = int(recs.lengths[i])
        cig = recs.cigars[i]
        seq_codes = recs.seq[i, :l_seq]
        nib = _CODE_TO_NIBBLE[seq_codes]
        if l_seq % 2:
            nib = np.append(nib, 0)
        packed = ((nib[0::2] << 4) | nib[1::2]).astype(np.uint8).tobytes()
        qual = recs.qual[i, :l_seq].tobytes()
        aux = recs.aux_raw[i]
        p = int(recs.pos[i])
        # bin covers the record's REFERENCE span (CIGAR M/D/N/=/X
        # total), not l_seq: a ref-projected consensus with D ops spans
        # more reference than it has bases, and strict validators check
        # bin == reg2bin(pos, pos + ref_span). CIGAR-less records keep
        # the l_seq-based placeholder span (matches the fast path).
        # past-BAI coords (end > 2^29): bin=0 — see _serialize_records_fast
        span = sum(n_op for n_op, op in cig if op in "MDN=X") if cig else l_seq
        end = max(p, 0) + max(span, 1)
        rbin = 0 if end > (1 << 29) else _reg2bin(max(p, 0), end)
        body = struct.pack(
            "<iiBBHHHiiii",
            int(recs.ref_id[i]),
            p,
            len(name_b),
            int(recs.mapq[i]),
            rbin,
            len(cig),
            int(recs.flags[i]),
            l_seq,
            int(recs.next_ref_id[i]),
            int(recs.next_pos[i]),
            int(recs.tlen[i]),
        )
        body += name_b
        for n_op, op in cig:
            body += struct.pack("<I", (n_op << 4) | op_idx[op])
        body += packed + qual + aux
        out += struct.pack("<i", len(body)) + body
    return bytes(out)


def write_bam(path: str, header: BamHeader, recs: BamRecords, level: int = 6) -> None:
    with open(path, "wb") as f:
        f.write(bgzf.compress_fast(serialize_bam(header, recs), level=level))


def strip_aux_tag(aux: bytes, tag: str) -> bytes:
    """Return ``aux`` with every field named ``tag`` removed (any value
    type) — re-annotators must replace, not duplicate, their tags."""
    t = tag.encode("ascii")
    out = bytearray()
    for start, name, _typ, _vstart, end in iter_aux_fields(aux):
        if name != t:
            out += aux[start:end]
    return bytes(out)


def make_aux_z(tag: str, value: str) -> bytes:
    return tag.encode("ascii") + b"Z" + value.encode("ascii") + b"\x00"


def make_aux_i(tag: str, value: int) -> bytes:
    return tag.encode("ascii") + b"i" + struct.pack("<i", value)
