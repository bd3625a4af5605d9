"""BGZF block codec (pure Python + zlib).

BGZF is the blocked-gzip container BAM files live in: a series of
standard gzip members, each carrying an extra "BC" subfield with the
compressed block size, terminated by a fixed 28-byte empty EOF block.
Because each member is independently decompressible, the format
supports random access and parallel decompression — the property the
native C++ loader (duplexumiconsensusreads_torch.native) exploits; this
module is the portable implementation.

No pysam/htslib exists in this environment (SURVEY.md §7 "Hard parts"
item 4), so the codec is built from the BGZF spec directly.
"""

from __future__ import annotations

import functools
import io as _io
import struct
import zlib

# Fixed empty gzip member marking end-of-file (BGZF spec appendix).
BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)


def has_eof_block(buf: bytes) -> bool:
    """True iff ``buf`` ends with the 28-byte BGZF EOF marker.

    The single definition of "this BGZF stream is finished" — the
    stream reader, the shard merger, and the live tailer all route
    their EOF comparisons through here so the answer cannot drift
    between consumers.
    """
    return len(buf) >= len(BGZF_EOF) and buf[-len(BGZF_EOF):] == BGZF_EOF

# Max uncompressed payload per block. The format caps the *compressed*
# block at 65536; 65280 uncompressed leaves headroom like htslib does.
MAX_BLOCK_UNCOMPRESSED = 65280

_HEADER = struct.Struct("<BBBBIBBH")  # magic1 magic2 CM FLG MTIME XFL OS XLEN
# Precompiled scalar codecs for the hot header scan: read_block_size
# runs once per 18-byte BGZF header on the streaming ingest path, and
# struct.unpack_from("<H", ...) re-parses the format string each call.
_U16 = struct.Struct("<H")
_U32X2 = struct.Struct("<II")


def read_block_size(data: bytes, offset: int) -> int:
    """Total compressed size of the block starting at ``offset``.

    Parses the gzip FEXTRA subfields looking for BC (SI1=66, SI2=67).
    """
    if data[offset : offset + 2] != b"\x1f\x8b":
        raise ValueError(f"not a gzip member at offset {offset}")
    flg = data[offset + 3]
    if not flg & 4:  # FEXTRA
        raise ValueError("gzip member without FEXTRA: not BGZF")
    xlen = _U16.unpack_from(data, offset + 10)[0]
    pos = offset + 12
    end = pos + xlen
    while pos + 4 <= end:
        si1, si2, slen = data[pos], data[pos + 1], _U16.unpack_from(data, pos + 2)[0]
        if si1 == 66 and si2 == 67:
            if slen != 2:
                raise ValueError("BC subfield with SLEN != 2")
            return _U16.unpack_from(data, pos + 4)[0] + 1
        pos += 4 + slen
    raise ValueError("no BC subfield: not BGZF")


def iter_block_offsets(data: bytes):
    """Yield (offset, size) for every BGZF block in ``data``."""
    off = 0
    n = len(data)
    while off < n:
        size = read_block_size(data, off)
        yield off, size
        off += size
    if off != n:
        raise ValueError("trailing garbage after last BGZF block")


def decompress_block(data: bytes, offset: int, size: int) -> bytes:
    """Decompress one block given its offset and compressed size."""
    xlen = _U16.unpack_from(data, offset + 10)[0]
    start = offset + 12 + xlen
    # last 8 bytes are CRC32 + ISIZE
    payload = data[start : offset + size - 8]
    out = zlib.decompress(payload, wbits=-15)
    crc, isize = _U32X2.unpack_from(data, offset + size - 8)
    if len(out) != isize or zlib.crc32(out) != crc:
        raise ValueError(f"BGZF block at {offset}: CRC/size mismatch")
    return out


def decompress(data: bytes) -> bytes:
    """Decompress a whole BGZF byte string block by block. Linear in the
    input: gzip.decompress re-slices the remaining input once per member,
    which is quadratic over the thousands of blocks of a real BAM."""
    return b"".join(
        decompress_block(data, off, size) for off, size in iter_block_offsets(data)
    )


def compress_block(payload: bytes, level: int = 6) -> bytes:
    """Compress one ≤MAX_BLOCK_UNCOMPRESSED payload into a BGZF block."""
    if len(payload) > MAX_BLOCK_UNCOMPRESSED:
        raise ValueError("payload too large for one BGZF block")
    c = zlib.compressobj(level, zlib.DEFLATED, -15)
    body = c.compress(payload) + c.flush()
    bsize = len(body) + 12 + 6 + 8  # header(12) + xtra(6) + body + tail(8)
    header = _HEADER.pack(0x1F, 0x8B, 8, 4, 0, 0, 0xFF, 6)
    xtra = struct.pack("<BBHH", 66, 67, 2, bsize - 1)
    tail = struct.pack("<II", zlib.crc32(payload), len(payload))
    return header + xtra + body + tail


def compress(data: bytes, level: int = 6, eof: bool = True) -> bytes:
    """Compress bytes into a BGZF stream (with EOF block by default)."""
    out = _io.BytesIO()
    for i in range(0, len(data), MAX_BLOCK_UNCOMPRESSED):
        out.write(compress_block(data[i : i + MAX_BLOCK_UNCOMPRESSED], level))
    if eof:
        out.write(BGZF_EOF)
    return out.getvalue()


def compress_fast(data: bytes, level: int = 6, eof: bool = True) -> bytes:
    """BGZF-compress via the native multithreaded library
    (duplexumiconsensusreads_torch.native), or the portable codec under
    DUT_NO_NATIVE=1 (the same switch as the native reader)."""
    return compress_fast_tagged(data, level=level, eof=eof)[0]


def compress_fast_tagged(
    data: bytes, level: int = 6, eof: bool = True
) -> tuple[bytes, str]:
    """``compress_fast`` plus the codec used: (bytes, "native"|"python").
    Native and pure-Python deflate produce different — both valid —
    bytes for the same records, so the streaming executor persists the
    tag per checkpoint shard and a resume never splices shards deflated
    by another codec. A native failure raises: unlike the JAX package,
    nothing falls back to the portable codec per shard."""
    from duplexumiconsensusreads_torch import native

    if not native.native_enabled():
        return compress(data, level=level, eof=eof), "python"
    out = native.bgzf_compress_native(data, level=level)
    return out + (BGZF_EOF if eof else b""), "native"


@functools.cache
def _native_probe() -> bool:
    from duplexumiconsensusreads_torch.native import bgzf_compress_native

    return len(bgzf_compress_native(b"dut-probe")) > 0


def native_compress_capable() -> bool:
    """True when the native deflate is selected and works, probed by
    compressing a tiny payload (once per process). A library that does
    not build or whose compress entry point fails raises instead of
    reading as incapable: there is no quiet fallback."""
    from duplexumiconsensusreads_torch.native import native_enabled

    return native_enabled() and _native_probe()


def deflate_flavor() -> str:
    """The deflate codec ``compress_fast`` uses right now: "native" or
    "python". Joins the streaming checkpoint fingerprint; per-shard
    truth is ``compress_fast_tagged``'s return."""
    return "native" if native_compress_capable() else "python"


def is_bgzf(data: bytes) -> bool:
    if len(data) < 18 or data[:2] != b"\x1f\x8b":
        return False
    try:
        read_block_size(data, 0)
        return True
    except ValueError:
        return False
