"""Linear BGZF/BAM index: the multi-host input-partitioning consumer.

A coordinate-sorted BAM is divided by sampled record boundaries: every
``every`` records the index stores (pos_key, compressed block offset,
offset within that block's decompressed payload). Because BGZF blocks
are independently decompressible, a host can open the file AT an index
entry (seek + skip) and stream only its genomic key range: each
host's share of the key space maps to a byte region it can read
without touching the rest of the file. A copy of the JAX package's
io/index.py (its multi-host partitioner is not ported yet; ``index``
writes the same .dlix bytes).

Range semantics: a host owns pos_keys in [key_lo, key_hi) (None = open
end). Since families never span pos_keys, any such partition preserves
family integrity; reading starts at the last entry strictly BEFORE
key_lo so a position group that straddles a sampled boundary is always
seen from its first record (leading records below key_lo are skipped).
"""

from __future__ import annotations

import dataclasses
import os
import struct

import numpy as np

from duplexumiconsensusreads_torch.io import bgzf

INDEX_SUFFIX = ".dlix"
_MAGIC = "duplexumi-linear-index-v1"


@dataclasses.dataclass
class BamLinearIndex:
    """Sampled record boundaries of a coordinate-sorted BAM.

    pos_key[i]  pos_key of the i-th sampled record
    coffset[i]  compressed file offset of the BGZF block holding it
    uoffset[i]  offset of the record within that block's decompressed
                payload
    every       sampling stride in records (entry i = record i*every)
    n_records   total records in the file
    """

    pos_key: np.ndarray
    coffset: np.ndarray
    uoffset: np.ndarray
    every: int
    n_records: int

    def save(self, path: str) -> None:
        # file handle, not path: savez would append ".npz" to the
        # conventional ".dlix" suffix and break exists()/load() lookups.
        # tmp + atomic replace: concurrent hosts on shared storage must
        # never observe (or interleave into) a torn index — a reader
        # whose exists() check lands mid-write would load a corrupt npz
        import os as _os

        from duplexumiconsensusreads_torch.io.durable import (
            fsync_file,
            replace_durable,
        )

        # per-writer tmp name: two uncoordinated hosts saving the same
        # index must never interleave into one tmp file
        tmp = f"{path}.tmp.{_os.getpid()}"
        with open(tmp, "wb") as f:
            np.savez_compressed(
                f,
                magic=_MAGIC,
                pos_key=self.pos_key,
                coffset=self.coffset,
                uoffset=self.uoffset,
                every=self.every,
                n_records=self.n_records,
            )
            fsync_file(f)
        replace_durable(tmp, path)

    @staticmethod
    def load(path: str) -> "BamLinearIndex":
        with np.load(path, allow_pickle=False) as z:
            if str(z["magic"]) != _MAGIC:
                raise ValueError(f"{path}: not a duplexumi linear index")
            return BamLinearIndex(
                pos_key=z["pos_key"],
                coffset=z["coffset"],
                uoffset=z["uoffset"],
                every=int(z["every"]),
                n_records=int(z["n_records"]),
            )

    def start_voffset(self, key_lo) -> tuple[int, int] | None:
        """(coffset, uoffset) to start reading so that every record with
        pos_key >= key_lo is seen; None = no seek (record-less file).
        An open start (key_lo None) seeks to entry 0 — the first
        record — never to byte 0, which would replay the header bytes
        as records."""
        if len(self.pos_key) == 0:
            return None
        if key_lo is None:
            return (int(self.coffset[0]), int(self.uoffset[0]))
        # last entry strictly below key_lo (entries are non-decreasing);
        # an entry AT key_lo may sit mid-position-group, so it is not a
        # safe entry point for that group's first records
        j = int(np.searchsorted(self.pos_key, key_lo, side="left")) - 1
        if j < 0:
            return (int(self.coffset[0]), int(self.uoffset[0]))
        return (int(self.coffset[j]), int(self.uoffset[j]))


def build_linear_index(path: str, every: int = 100_000) -> BamLinearIndex:
    """One sequential pass: block table from the compressed stream,
    record boundaries from the decompressed stream (native chain walk
    unless DUT_NO_NATIVE=1), sampled every ``every`` records."""
    from duplexumiconsensusreads_torch.io.native_reader import region_pos_keys
    from duplexumiconsensusreads_torch.runtime.stream import BamStreamReader

    c_off, cum_u = _scan_blocks(path)

    reader = BamStreamReader(path)
    entries_key, entries_c, entries_u = [], [], []
    n_records = 0
    try:
        while True:
            raw = reader.read_raw_records(8192)
            if raw is None:
                break
            offs = _record_offsets(raw)
            base = reader._consumed - len(raw)
            first = (-n_records) % every
            sel = np.arange(first, len(offs), every)
            if len(sel):
                keys = region_pos_keys(np.frombuffer(raw, np.uint8), offs[sel])
                for key, o in zip(keys.tolist(), offs[sel].tolist()):
                    g = base + o  # global decompressed offset
                    bi = int(np.searchsorted(cum_u, g, side="right")) - 1
                    entries_key.append(key)
                    entries_c.append(int(c_off[bi]))
                    entries_u.append(g - int(cum_u[bi]))
            n_records += len(offs)
    finally:
        reader.close()
    return BamLinearIndex(
        pos_key=np.array(entries_key, np.int64),
        coffset=np.array(entries_c, np.int64),
        uoffset=np.array(entries_u, np.int64),
        every=every,
        n_records=n_records,
    )


def _scan_blocks(path: str, read_size: int = 8 << 20, progress=None):
    """Streaming BGZF block table: (compressed offsets, cumulative
    decompressed offsets). Header-only scan in bounded memory — the
    index targets files far larger than RAM. ``progress`` (optional
    callable) fires once per ``read_size`` batch: long walks under a
    lease (the shard planner) stamp liveness through it."""
    c_off, u_sizes = [], []
    base = 0
    buf = b""
    with open(path, "rb") as f:
        head = f.read(2)
        if head[:2] != b"\x1f\x8b":
            raise ValueError(f"{path}: linear index requires BGZF input")
        f.seek(0)
        while True:
            data = f.read(read_size)
            if progress is not None:
                progress()
            if data:
                buf += data
            off = 0
            while off + 18 <= len(buf):
                size = bgzf.read_block_size(buf, off)
                if off + size > len(buf):
                    break
                c_off.append(base + off)
                u_sizes.append(struct.unpack_from("<I", buf, off + size - 4)[0])
                off += size
            base += off
            buf = buf[off:]
            if not data:
                if buf:
                    raise ValueError(f"{path}: trailing truncated BGZF block")
                break
    return (
        np.array(c_off, np.int64),
        np.concatenate(([0], np.cumsum(np.array(u_sizes, np.int64)))),
    )


def _record_offsets(raw: bytes) -> np.ndarray:
    """Offsets of each record within a whole-records byte run (the
    native chain walk; a Python walk under DUT_NO_NATIVE=1)."""
    import ctypes

    from duplexumiconsensusreads_torch.native import active_lib

    lib = active_lib()
    if lib is not None:
        arr = np.frombuffer(raw, np.uint8)
        # whole-record runs: record count <= len/37 (min record size)
        offs = np.empty(max(len(raw) // 37, 1), np.int64)
        end = ctypes.c_long()
        n = lib.dut_bam_chain_offsets(
            arr, len(arr), 0, len(offs), ctypes.byref(end),
            offs.ctypes.data_as(ctypes.c_void_p),
        )
        if n >= 0:
            return offs[:n]
    offs_l = []
    off = 0
    n = len(raw)
    while off + 4 <= n:
        (bsz,) = struct.unpack_from("<i", raw, off)
        offs_l.append(off)
        off += 4 + bsz
    return np.array(offs_l, np.int64)
