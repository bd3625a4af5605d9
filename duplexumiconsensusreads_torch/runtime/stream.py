"""Streaming executor: consensus-call BAMs far larger than host RAM.

The counterpart of the JAX package's runtime/stream.py, on one CUDA
device (or the CPU when the caller asks for it). A coordinate-sorted
BAM runs as a pipeline of chunks:

  BGZF blocks -> rolling inflate and native record parse (the C++
  loader of native/; the portable Python codec under DUT_NO_NATIVE=1)
  -> record chunks (the trailing pos_key group held back so no family
  straddles a boundary) -> buckets ->
  dispatch classes, each with its H2D wire rung (sub-byte, byte or
  off) -> transfer workers (H2D copy, the batched fused pipeline, the
  packed-D2H compaction on the device, pinned D2H copies — all on the
  worker's own CUDA stream, closed by an event) -> a pool of drain
  workers (wait on that event -> unpack -> scatter -> serialize -> BGZF
  deflate -> durable shard write) -> an ordered commit frontier
  (checkpoint marks and incremental finalise appends strictly in chunk
  order) -> one atomic fsync+rename of the consensus BAM [-> .bai/.csi].

Concurrency comes from the transfer threads: the pipeline blocks its
calling thread (the grouping fixpoint syncs its stream once per
sweep), so each of the XFER_WORKERS threads drives one dispatch class
at a time on a stream of its own. A drain worker waits on the event
recorded after its class's D2H copies, never on a device-wide
synchronize, so other chunks stay in flight.

Checkpoint/resume: a JSON manifest records finished chunk shards keyed
by a parameter fingerprint; ``resume=True`` skips completed chunks.
The fingerprint names the engine, so a manifest of the JAX package is
never resumed here (nor the reverse): the two engines' quals may differ
by one at the Phred floor, and output bytes must stay a pure function
of (input, config).

Input contract: records ordered so that equal pos_keys are contiguous
and pos_keys non-decreasing (template-coordinate order for paired
data); violations raise.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import itertools
import json
import os
import queue as _queue
import struct
import sys
import threading
import time
import warnings
import zlib
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from duplexumiconsensusreads_torch.io import bgzf
from duplexumiconsensusreads_torch.io.bam import BamHeader, BamRecords, parse_bam
from duplexumiconsensusreads_torch.io.convert import (
    UNMAPPED_POS_KEY,
    consensus_to_records,
    downsample_families,
    records_to_readbatch,
)

# chunk-boundary key MUST be the grouping key: one shared implementation
from duplexumiconsensusreads_torch.io.convert import records_pos_keys as _rec_pos_keys
from duplexumiconsensusreads_torch.io.durable import (
    fsync_file,
    replace_durable,
    rewrite_from,
    unique_tmp,
    write_durable,
)
from duplexumiconsensusreads_torch.ops.pipeline import (
    SUBBYTE_QBITS,
    analytic_flops,
    pack_stacked,
    qual_alphabet,
)
from duplexumiconsensusreads_torch.runtime.executor import (
    DRAIN_PHASES,
    IDS16_FETCH_KEYS,
    PACKED_FETCH_KEYS,
    PER_BASE_KEYS,
    XFER_WORKERS,
    D2hCompactionOverflow,
    RunReport,
    d2h_k_pad,
    d2h_logical_nbytes,
    d2h_pack_ok,
    d2h_rung_for_class,
    fetch_outputs,
    pack_fetch_outputs,
    pack_ids_u16,
    partition_buckets,
    resolve_device,
    scatter_bucket_outputs,
    sort_consensus_outputs,
    start_fetch,
    unpack_fetch_outputs,
    write_bam_index,
)
from duplexumiconsensusreads_torch.runtime.faults import (
    InjectedFault,
    fault_point,
    install_from_env,
)
from duplexumiconsensusreads_torch.telemetry import trace as telemetry
from duplexumiconsensusreads_torch.telemetry.trace import Heartbeat, TraceRecorder
from duplexumiconsensusreads_torch.types import ConsensusParams, GroupingParams

# largest qual alphabet any sub-byte dictionary width can hold; past
# this the run-level union can never fit again and the per-chunk
# alphabet scan stops
_ALPHA_CAP = (1 << max(SUBBYTE_QBITS)) - 1

# the checkpoint fingerprint's engine element (see the module docstring)
ENGINE = "engine:torch"


# ------------------------------------------------------- host I/O retry

# Transient HOST I/O failures get bounded exponential backoff. Each
# attempt passes the step's named fault site first, so chaos schedules
# (runtime/faults.py) exercise exactly this ladder.
_HOST_IO_RETRIES = 3


def _io_retry(site: str, fn, what: str, *args):
    """Run ``fn(*args)`` behind fault site ``site``, retrying OSErrors
    with bounded backoff; every retry is a trace event."""
    last: OSError | None = None
    for attempt in range(_HOST_IO_RETRIES + 1):
        try:
            fault_point(site)
            return fn(*args)
        except OSError as e:
            last = e
            if attempt == _HOST_IO_RETRIES:
                break
            delay = min(0.05 * (2 ** attempt), 2.0)
            telemetry.emit_event(
                "retry", site=site, attempt=attempt + 1,
                max_attempts=_HOST_IO_RETRIES, backoff_s=round(delay, 3),
                error=repr(e)[:200],
            )
            print(
                f"[duplexumi] transient {what} failure ({e!r}); retry "
                f"{attempt + 1}/{_HOST_IO_RETRIES} in {delay:.2f}s",
                file=sys.stderr,
            )
            time.sleep(delay)
    raise last


def _seek_read(f, pos: int, n: int) -> bytes:
    # re-seek per attempt: a transient error can fire after the offset
    # already advanced past partially-read bytes
    f.seek(pos)
    return f.read(n)


def _read_ingest(f, n: int) -> bytes:
    return _io_retry("ingest.read", _seek_read, "ingest read", f, f.tell(), n)


def _noop():
    # the ingest.queue fault probe: the handoff itself is an in-memory
    # enqueue, so the chaos site wraps a no-op
    return None


class _IngestAbort(BaseException):
    """Unwind signal for the ingest producer thread: the run is going
    down (the main loop already owns the error), so the producer exits
    its blocked handoff without another sentinel. BaseException so no
    retry ladder can absorb it."""


# --------------------------------------------------------------- input

def _complete_prefix(buf: bytes) -> int:
    """Byte length of the complete-BGZF-block prefix of ``buf`` (a
    header-only scan; the inflate happens elsewhere)."""
    off = 0
    while off + 18 <= len(buf):
        size = bgzf.read_block_size(buf, off)
        if off + size > len(buf):
            break
        off += size
    return off


def _inflate_native(lib, buf: bytes, n_threads: int) -> bytes:
    """Parallel-inflate a byte string of complete BGZF blocks."""
    src = np.frombuffer(buf, np.uint8)
    usize = lib.dut_bgzf_usize(src, len(src))
    if usize < 0:
        raise ValueError("malformed BGZF block batch")
    out = np.empty(max(usize, 1), np.uint8)
    if lib.dut_bgzf_decompress(src, len(src), out, usize, n_threads) != usize:
        raise ValueError("BGZF decompression failed")
    return out[:usize].tobytes()


def _inflate_python(block: bytes) -> bytes:
    """Per-block inflate of a batch of complete blocks."""
    return b"".join(
        bgzf.decompress_block(block, o, s)
        for o, s in bgzf.iter_block_offsets(block)
    )


def _iter_bgzf_stream(f, read_size=4 << 20, native_lib=None, n_threads=0):
    """Yield decompressed byte chunks from a BGZF (or raw BAM) file
    object, inflating each batch of complete blocks as it arrives: in
    one multithreaded call of ``native_lib`` (the ctypes-bound loader),
    else block by block in Python."""
    head = _read_ingest(f, 18)
    if head[:2] == b"\x1f\x8b":
        buf = head
        while True:
            data = _read_ingest(f, read_size)
            if data:
                buf += data
            off = _complete_prefix(buf)
            if off:
                if native_lib is not None:
                    yield _io_retry(
                        "bgzf.inflate", _inflate_native, "BGZF inflate",
                        native_lib, buf[:off], n_threads,
                    )
                else:
                    yield _io_retry(
                        "bgzf.inflate", _inflate_python, "BGZF inflate", buf[:off]
                    )
            buf = buf[off:]
            if not data:
                if buf:
                    raise ValueError("trailing truncated BGZF block")
                return
    else:
        yield head
        while True:
            data = _read_ingest(f, read_size)
            if not data:
                return
            yield data


class BamStreamReader:
    """Incremental BAM record reader over a rolling decompressed buffer."""

    def __init__(
        self,
        path: str,
        read_size: int = 8 << 20,
        use_native: bool | None = None,
        start: tuple[int, int] | None = None,
    ):
        """use_native: inflate and walk records with the native loader
        (None = unless DUT_NO_NATIVE is set; a build failure raises).

        start=(coffset, uoffset): begin the record stream at that BGZF
        virtual offset (from a BAI/CSI query or a BamLinearIndex entry)
        instead of the first record; the header is still parsed from
        the file start."""
        from duplexumiconsensusreads_torch import native

        if use_native is None:
            use_native = native.native_enabled()
        native_lib = native.get_lib() if use_native else None
        self._native_lib = native_lib
        self._f = open(path, "rb")
        self._buf = bytearray()
        self._eof = False
        self._consumed = 0  # decompressed bytes consumed (header incl.)
        if start is None:
            self._gen = _iter_bgzf_stream(
                self._f, read_size, native_lib=native_lib, n_threads=native.N_THREADS
            )
            self.header = self._read_header()
        else:
            tmp = BamStreamReader(path, read_size, use_native)
            self.header = tmp.header
            tmp.close()
            coff, uoff = start
            self._f.seek(coff)
            self._gen = _iter_bgzf_stream(
                self._f, read_size, native_lib=native_lib, n_threads=native.N_THREADS
            )
            if uoff:
                if not self._fill(uoff):
                    raise ValueError("index start offset past EOF")
                del self._buf[:uoff]

    def close(self):
        self._f.close()

    def _fill(self, need: int) -> bool:
        while len(self._buf) < need and not self._eof:
            try:
                self._buf += next(self._gen)
            except StopIteration:
                self._eof = True
        return len(self._buf) >= need

    def _need(self, n: int, what: str) -> None:
        if not self._fill(n):
            raise ValueError(f"truncated BAM: incomplete {what}")

    def _read_header(self) -> BamHeader:
        self._need(12, "magic")
        if bytes(self._buf[:4]) != b"BAM\x01":
            raise ValueError("not a BAM file")
        (l_text,) = struct.unpack_from("<i", self._buf, 4)
        if l_text < 0:
            raise ValueError("malformed BAM: negative l_text")
        self._need(8 + l_text + 4, "header text")
        text = bytes(self._buf[8 : 8 + l_text]).split(b"\x00", 1)[0].decode()
        off = 8 + l_text
        (n_ref,) = struct.unpack_from("<i", self._buf, off)
        if n_ref < 0:
            raise ValueError("malformed BAM: negative n_ref")
        off += 4
        names, lengths = [], []
        for _ in range(n_ref):
            self._need(off + 4, "reference entry")
            (l_name,) = struct.unpack_from("<i", self._buf, off)
            if l_name < 1:
                raise ValueError("malformed BAM: bad reference name length")
            off += 4
            self._need(off + l_name + 4, "reference entry")
            names.append(bytes(self._buf[off : off + l_name - 1]).decode())
            off += l_name
            (l_ref,) = struct.unpack_from("<i", self._buf, off)
            off += 4
            lengths.append(l_ref)
        del self._buf[:off]
        self._consumed += off
        return BamHeader(text=text, ref_names=names, ref_lengths=lengths)

    def read_raw_records(self, n: int) -> bytes | None:
        """Raw bytes of up to n whole records; None at EOF."""
        if self._native_lib is not None:
            return self._read_raw_records_native(n)
        count = 0
        off = 0
        while count < n:
            if not self._fill(off + 4):
                break
            (bsz,) = struct.unpack_from("<i", self._buf, off)
            # 32 fixed bytes + >=1 read-name byte is the smallest record
            if bsz < 33:
                raise ValueError(f"malformed BAM: record block_size {bsz}")
            self._need(off + 4 + bsz, "record")
            off += 4 + bsz
            count += 1
        if count == 0:
            if self._buf and self._eof:
                raise ValueError("truncated BAM: trailing partial record at EOF")
            return None
        out = bytes(self._buf[:off])
        del self._buf[:off]
        self._consumed += off
        return out

    def _read_raw_records_native(self, n: int) -> bytes | None:
        """read_raw_records via the C record-chain walker: no per-record
        Python loop."""
        import ctypes

        lib = self._native_lib
        count = 0
        off = 0
        while count < n:
            # the frombuffer view must not outlive the iteration: a live
            # export would block the bytearray resize below
            buf_arr = np.frombuffer(self._buf, np.uint8)
            end = ctypes.c_long()
            c = lib.dut_bam_chain(buf_arr, len(buf_arr), off, n - count, ctypes.byref(end))
            del buf_arr
            if c < 0:
                bad = int(end.value)  # the chain reports the offending record
                bsz = (struct.unpack_from("<i", self._buf, bad)[0]
                       if len(self._buf) >= bad + 4 else -1)
                raise ValueError(f"malformed BAM: record block_size {bsz}")
            count += c
            off = int(end.value)
            if count >= n:
                break
            if not self._fill(len(self._buf) + 1):
                break  # EOF: return what there is; a partial tail errors next call
        if count == 0:
            if self._buf and self._eof:
                raise ValueError("truncated BAM: trailing partial record at EOF")
            return None
        # one copy: memoryview slices are zero-copy views
        mv = memoryview(self._buf)
        out = bytes(mv[:off])
        mv.release()
        del self._buf[:off]
        self._consumed += off
        return out


def _header_shell(header: BamHeader) -> bytes:
    shell = bytearray()
    shell += b"BAM\x01"
    text = header.text.encode()
    shell += struct.pack("<i", len(text)) + text
    shell += struct.pack("<i", len(header.ref_names))
    for name, length in zip(header.ref_names, header.ref_lengths):
        nb = name.encode() + b"\x00"
        shell += struct.pack("<i", len(nb)) + nb + struct.pack("<i", length)
    return bytes(shell)


def _records_from_raw(header: BamHeader, raw: bytes) -> BamRecords:
    """Parse a raw record stream by prepending a minimal header."""
    _, recs = parse_bam(_header_shell(header) + raw)
    return recs


def _validate_sort_contract(keys: np.ndarray, prev_last) -> None:
    """Raise on a streaming sort-contract violation."""
    if len(keys) > 1 and (np.diff(keys) < 0).any():
        i = int(np.nonzero(np.diff(keys) < 0)[0][0])
        raise ValueError(
            "input violates the streaming sort contract: pos_key "
            f"decreases at record ~{i} ({keys[i]} -> "
            f"{keys[i+1]}). Streaming needs non-decreasing "
            "fragment keys (template-coordinate order for paired "
            "data); use whole-file mode (--chunk-reads 0) for "
            "unsorted input."
        )
    if prev_last is not None and len(keys) and keys[0] <= prev_last:
        raise ValueError(
            "input violates the streaming sort contract across a "
            "chunk boundary (pos_key repeats after being flushed)"
        )


def _resolve_chunk_boundary(keys: np.ndarray, prev_last):
    """THE chunk-boundary rule (the JAX package's, so both engines cut
    the same chunks). On the combined buffer's pos_keys, returns
    (cut, new_prev_last):

      cut == 0         entire buffer is one position group: keep growing
      cut == len(keys) unmapped sentinel tail: flush everything, no
                       hold-back (sentinel keys are never groupable)
      otherwise        yield records [:cut], hold back the final group
    """
    _validate_sort_contract(keys, prev_last)
    if keys[-1] == UNMAPPED_POS_KEY:
        return len(keys), UNMAPPED_POS_KEY - 1
    last = keys[-1]
    keep = np.nonzero(keys != last)[0]
    if len(keep) == 0:
        return 0, prev_last
    cut = int(keep[-1]) + 1
    return cut, keys[cut - 1]


def iter_record_chunks(path: str, chunk_reads: int):
    """Yield (header, BamRecords) chunks; the trailing pos_key group of
    each chunk is held back and prepended to the next so no molecule's
    reads are split across chunks. The sort contract is validated on
    every chunk."""
    reader = BamStreamReader(path)
    header = reader.header
    carry: BamRecords | None = None
    prev_last = None
    try:
        while True:
            raw = reader.read_raw_records(chunk_reads)
            if raw is None:
                if carry is not None and len(carry):
                    yield header, carry
                return
            recs = _records_from_raw(header, raw)
            if carry is not None and len(carry):
                recs = _concat_records(carry, recs)
            cut, prev_last = _resolve_chunk_boundary(_rec_pos_keys(recs), prev_last)
            if cut == 0:
                carry = recs  # entire chunk is one group; keep growing
                continue
            if cut == len(recs):  # sentinel tail: flush, no hold-back
                carry = None
                yield header, recs
                continue
            carry = _slice_records(recs, cut, len(recs))
            yield header, _slice_records(recs, 0, cut)
    finally:
        reader.close()


def iter_batch_chunks(path: str, chunk_reads: int, duplex: bool, warn_mixed: bool = True):
    """Yield (header, ReadBatch, info) chunks with the family-integrity
    hold-back of iter_record_chunks, parsed NATIVELY: record fields go
    straight from raw BAM bytes into NumPy arrays (io/native_reader),
    with no per-record Python loop.

    Chunk boundaries are byte-identical to iter_record_chunks' (the same
    hold-back and sentinel-flush rule on the same pos_keys), so
    checkpoint manifests stay valid whichever path wrote them. Under
    DUT_NO_NATIVE=1 this is the portable iterator. The JAX package's
    range arguments (start/key_lo/key_hi/first_read, open_fn) belong to
    the serve and live slices and are not ported."""
    from duplexumiconsensusreads_torch import native

    if not native.native_enabled():
        for header, recs in iter_record_chunks(path, chunk_reads):
            batch, info = records_to_readbatch(recs, duplex=duplex, warn_mixed=warn_mixed)
            yield header, batch, info
        return

    from duplexumiconsensusreads_torch.io.native_reader import (
        batch_from_offsets,
        region_pos_keys,
        scan_region,
    )

    lib = native.get_lib()
    reader = BamStreamReader(path, use_native=True)
    header = reader.header
    shell = _header_shell(header)
    carry = b""
    prev_last = None

    def emit(data, offs, lm, rm):
        return (
            header,
            *batch_from_offsets(
                lib, data, offs, lm, rm, duplex=duplex, n_threads=native.N_THREADS,
                warn_mixed=warn_mixed,
            ),
        )

    try:
        while True:
            raw = reader.read_raw_records(chunk_reads)
            if raw is None:
                if carry:
                    data = np.frombuffer(shell + carry, np.uint8)
                    _, lm, rm, off = scan_region(lib, data, path)
                    if len(off):
                        yield emit(data, off, lm, rm)
                return
            # one join: shell + carry + raw; the carry slices index this
            # blob directly (offsets are absolute)
            blob = b"".join((shell, carry, raw))
            data = np.frombuffer(blob, np.uint8)
            _, lm, rm, rec_off = scan_region(lib, data, path)
            keys = region_pos_keys(data, rec_off)
            cut, prev_last = _resolve_chunk_boundary(keys, prev_last)
            if cut == 0:
                carry = blob[int(rec_off[0]):]  # one group: keep growing
                continue
            if cut == len(keys):  # sentinel tail: flush, no hold-back
                carry = b""
                yield emit(data, rec_off, lm, rm)
                continue
            carry = blob[int(rec_off[cut]):]
            yield emit(data, rec_off[:cut], lm, rm)
    finally:
        reader.close()


def _slice_records(recs: BamRecords, a: int, b: int) -> BamRecords:
    from duplexumiconsensusreads_torch.io.bam import _slice_recs

    return _slice_recs(recs, a, b)


def _concat_records(a: BamRecords, b: BamRecords) -> BamRecords:
    from duplexumiconsensusreads_torch.constants import BASE_PAD

    lmax = max(a.seq.shape[1], b.seq.shape[1])

    def padseq(x, fill):
        out = np.full((x.shape[0], lmax), fill, np.uint8)
        out[:, : x.shape[1]] = x
        return out

    return BamRecords(
        names=a.names + b.names,
        flags=np.concatenate([a.flags, b.flags]),
        ref_id=np.concatenate([a.ref_id, b.ref_id]),
        pos=np.concatenate([a.pos, b.pos]),
        mapq=np.concatenate([a.mapq, b.mapq]),
        next_ref_id=np.concatenate([a.next_ref_id, b.next_ref_id]),
        next_pos=np.concatenate([a.next_pos, b.next_pos]),
        tlen=np.concatenate([a.tlen, b.tlen]),
        lengths=np.concatenate([a.lengths, b.lengths]),
        seq=np.concatenate([padseq(a.seq, BASE_PAD), padseq(b.seq, BASE_PAD)]),
        qual=np.concatenate([padseq(a.qual, 0), padseq(b.qual, 0)]),
        cigars=a.cigars + b.cigars,
        umi=a.umi + b.umi,
        aux_raw=a.aux_raw + b.aux_raw,
    )


# ------------------------------------------------------------ checkpoint

def _verify_shard(entry, expect_codec: str | None = None) -> bool:
    """Trust a manifest entry only when the shard's bytes still match
    the size + CRC32 recorded at write time (and were deflated by the
    codec this run uses); a failure means the chunk is recomputed."""
    if not isinstance(entry, dict):
        return False
    if not isinstance(entry.get("n_records"), int) or not isinstance(
        entry.get("n_pairs"), int
    ):
        return False
    if expect_codec is not None and entry.get("codec") != expect_codec:
        return False
    path = entry.get("path")
    try:
        if not path or os.path.getsize(path) != entry.get("size"):
            return False
        crc = 0
        with open(path, "rb") as f:
            while True:
                block = f.read(1 << 20)
                if not block:
                    break
                crc = zlib.crc32(block, crc)
    except OSError:
        return False
    return crc == entry.get("crc32")


@dataclasses.dataclass
class Checkpoint:
    path: str
    fingerprint: str
    # chunk index (str) -> {"path", "size", "crc32", "n_records",
    # "n_pairs", "codec"}
    done: dict

    @staticmethod
    def load_or_create(
        path: str, fingerprint: str, verify: bool = True,
        expect_codec: str | None = None,
    ) -> "Checkpoint":
        """Load the manifest, pruning entries that no longer apply, and
        persist the result at once if it differs from the disk: a
        diverging manifest (another fingerprint, dead or CRC-failing
        shards, torn JSON) must not survive on disk. ``verify=False``
        skips the per-shard re-read (for callers about to discard
        ``done``)."""
        done: dict = {}
        on_disk = None
        torn = False
        if os.path.exists(path):
            try:
                with open(path) as f:
                    on_disk = json.load(f)
                if not isinstance(on_disk, dict) or not isinstance(
                    on_disk.get("done", {}), dict
                ):
                    raise ValueError("manifest is not a JSON object")
            except (OSError, ValueError) as e:
                print(
                    f"[duplexumi] discarding unreadable checkpoint "
                    f"manifest {path} ({e})",
                    file=sys.stderr,
                )
                on_disk, torn = None, True
            else:
                if on_disk.get("fingerprint") == fingerprint:
                    done = {
                        k: v
                        for k, v in on_disk.get("done", {}).items()
                        if not verify or _verify_shard(v, expect_codec)
                    }
        ckpt = Checkpoint(path, fingerprint, done)
        if torn or (
            on_disk is not None
            and on_disk != {"fingerprint": fingerprint, "done": done}
        ):
            ckpt.save()
        return ckpt

    def save(self) -> None:
        payload = json.dumps(
            {"fingerprint": self.fingerprint, "done": self.done}
        ).encode()
        _io_retry(
            "ckpt.save",
            lambda: write_durable(self.path, payload, tmp=unique_tmp(self.path)),
            "checkpoint save",
        )

    def mark(
        self, chunk: int, shard_path: str, size: int, crc: int,
        n_records: int, n_pairs: int, codec: str,
    ) -> None:
        self.done[str(chunk)] = {
            "path": shard_path, "size": size, "crc32": crc,
            "n_records": n_records, "n_pairs": n_pairs, "codec": codec,
        }
        self.save()


def _fingerprint(
    in_path: str, grouping, consensus, capacity, chunk_reads,
    mate_aware: str = "auto", max_reads: int = 0, per_base_tags: bool = False,
    read_group: str = "A",
) -> str:
    """The checkpoint key: everything that changes output bytes, in the
    JAX package's order (no input range), plus the engine. Scheduling knobs (workers, depths, wire rungs) stay out, so
    a resume may change them. The mate_aware SETTING joins rather than
    its resolution, so the manifest can be initialised before any input
    byte is read."""
    st = os.stat(in_path)
    key = json.dumps(
        [
            os.path.abspath(in_path),
            st.st_size,
            int(st.st_mtime),
            dataclasses.asdict(grouping),
            dataclasses.asdict(consensus),
            capacity,
            chunk_reads,
            mate_aware,
            max_reads,
            per_base_tags,
            read_group,
            [],  # input range
            "any",  # iterator flavor of a run without a range
            "shard:bgzf1",
            "deflate:" + bgzf.deflate_flavor(),
            ENGINE,
        ],
        sort_keys=True,
    )
    return hashlib.sha256(key.encode()).hexdigest()[:16]


# -------------------------------------------------------------- executor

# options of the JAX package's stream_call_consensus that this package
# does not implement, each with the only value it accepts
_UNPORTED = {
    "input_range": None,  # multi-host / serve shard partitions
    "chunk_base": 0,  # serve shard chunk grid
    "first_read": None,
    "bucket_ladder": "off",  # tuning/
    "follow": False,  # live/ follow-mode ingest
    "finalize_on": "eof",
    "live_poll_s": 0.25,
    "snapshot_chunks": 0,
    "devices": None,  # multi-GPU dispatch
    "cycle_shards": 1,
}


def stream_call_consensus(
    in_path: str,
    out_path: str,
    grouping: GroupingParams,
    consensus: ConsensusParams,
    capacity: int = 2048,
    chunk_reads: int = 500_000,
    n_devices: int | None = None,
    max_inflight: int = 4,
    drain_workers: int = 2,
    checkpoint_path: str | None = None,
    resume: bool = False,
    report_path: str | None = None,
    profile_dir: str | None = None,
    progress=None,
    commit_guard=None,
    max_retries: int = 3,
    name_tag: str = "",
    mate_aware: str = "auto",
    max_reads: int = 0,
    per_base_tags: bool = False,
    read_group: str = "A",
    write_index: bool = False,
    packed: str = "auto",
    d2h_packed: str = "auto",
    prefetch_depth: int = 2,
    ingest_overlap: str = "auto",
    trace_path: str | None = None,
    heartbeat_s: float = 0.0,
    trace_max_events: int = 1_000_000,
    provenance_cl: str | None = None,
    device="cuda",
    **unported,
) -> RunReport:
    """Chunked, pipelined consensus calling on one device.

    The options are the JAX package's (see its stream_call_consensus),
    with ``device`` ("cuda" unless the caller asks for "cpu"; no card
    raises, nothing falls back). ``n_devices`` other than None/1 and
    every option in ``_UNPORTED`` set to another value than its default
    raise NotImplementedError naming the option.

    A telemetry wrapper around :func:`_stream_call`: the trace recorder
    and heartbeat are owned here, so they are torn down on every exit
    path, and a crashed run still leaves a valid (summary-less) capture.
    The recorder is also installed as the process-global hook, so the
    fault switchboard and the durable-write layer emit into it."""
    for name, value in unported.items():
        if name not in _UNPORTED:
            raise TypeError(f"stream_call_consensus() got an unexpected keyword argument {name!r}")
        if value != _UNPORTED[name]:
            raise NotImplementedError(
                f"{name}={value!r} is not ported to the torch package "
                f"(only {_UNPORTED[name]!r})"
            )
    if n_devices not in (None, 1):
        raise NotImplementedError(
            f"n_devices={n_devices!r} is not ported to the torch package "
            "(one device per run)"
        )
    dev = resolve_device(device)
    tr: TraceRecorder | None = None
    hb_box: list = []
    hooked = False
    if trace_path:
        tr = TraceRecorder(trace_path, max_events=trace_max_events)
        if telemetry.get_active() is None:
            telemetry.install(tr)
            hooked = True
        else:
            print(
                "[duplexumi] another trace recorder is active in this "
                "process; fault/retry/durable events will be recorded "
                "by that run, not this capture",
                file=sys.stderr,
            )
    try:
        return _stream_call(
            in_path, out_path, grouping, consensus,
            capacity=capacity, chunk_reads=chunk_reads,
            max_inflight=max_inflight, drain_workers=drain_workers,
            checkpoint_path=checkpoint_path, resume=resume,
            report_path=report_path, profile_dir=profile_dir,
            progress=progress, commit_guard=commit_guard,
            max_retries=max_retries, name_tag=name_tag,
            mate_aware=mate_aware, max_reads=max_reads,
            per_base_tags=per_base_tags, read_group=read_group,
            write_index=write_index, packed=packed, d2h_packed=d2h_packed,
            prefetch_depth=prefetch_depth, ingest_overlap=ingest_overlap,
            tr=tr, heartbeat_s=heartbeat_s, hb_box=hb_box,
            provenance_cl=provenance_cl, dev=dev,
        )
    finally:
        for hb in hb_box:
            hb.stop()
        if tr is not None:
            if hooked:
                telemetry.uninstall()
            tr.close()


def _retryable(e: BaseException) -> bool:
    """What a re-dispatch can cure: an injected transient fault, or a
    device out-of-memory (after the cache is emptied). Any other device
    error may have poisoned the CUDA context (an illegal address is
    sticky), so it is re-raised at once; nothing falls back to the CPU."""
    return isinstance(e, (InjectedFault, torch.OutOfMemoryError))


def _stream_call(
    in_path: str,
    out_path: str,
    grouping: GroupingParams,
    consensus: ConsensusParams,
    capacity: int,
    chunk_reads: int,
    max_inflight: int,
    drain_workers: int,
    checkpoint_path: str | None,
    resume: bool,
    report_path: str | None,
    profile_dir: str | None,
    progress,
    commit_guard,
    max_retries: int,
    name_tag: str,
    mate_aware: str,
    max_reads: int,
    per_base_tags: bool,
    read_group: str,
    write_index: bool,
    packed: str,
    d2h_packed: str,
    prefetch_depth: int,
    ingest_overlap: str,
    tr: TraceRecorder | None,
    heartbeat_s: float,
    hb_box: list,
    provenance_cl: str | None,
    dev: torch.device,
) -> RunReport:
    """The executor body. Writes per-chunk shards next to out_path and
    finalises one consensus BAM incrementally: drain workers run fetch
    -> scatter -> serialize -> deflate -> durable shard write off the
    main loop, and an ordered frontier on the main thread commits
    checkpoint marks and appends shards into ``out_path + ".tmp"``
    strictly in chunk order. Chunked runs checkpoint by default to
    ``out_path + ".ckpt"``; an explicit checkpoint_path also keeps the
    shards after a successful finalise. Retryable device failures
    (``_retryable``) re-dispatch with backoff, then bucket by bucket.

    mate_aware="auto" resolves against the FIRST chunk (mates share a
    canonical fragment pos_key, so any chunk with paired templates holds
    both their mates); the resolved mode holds for the whole run.

    per_base_tags=True emits the cd/ce per-base arrays on every record
    (the full ssc pass reduces the err columns too, and the return path
    fetches the two (F, L) matrices, so the packed-D2H rung is off);
    write_index=True writes the .bai (or .csi past 2^29) after the
    atomic rename, inside the finalise stage."""
    from duplexumiconsensusreads_torch.bucketing import build_buckets, stack_buckets
    from duplexumiconsensusreads_torch.interop import ARRAY_KEYS, stacked_from_numpy
    from duplexumiconsensusreads_torch.io.bam import serialize_bam
    from duplexumiconsensusreads_torch.ops.pipeline import fused_pipeline
    from duplexumiconsensusreads_torch.parallel.sharded import stacked_nbytes
    from duplexumiconsensusreads_torch.runtime.executor import resolve_mate_aware

    if chunk_reads < 1:
        raise ValueError(f"chunk_reads must be >= 1 (got {chunk_reads})")
    if max_inflight < 1:
        raise ValueError(f"max_inflight must be >= 1 (got {max_inflight})")
    if drain_workers < 1:
        raise ValueError(f"drain_workers must be >= 1 (got {drain_workers})")
    if prefetch_depth < 1:
        raise ValueError(f"prefetch_depth must be >= 1 (got {prefetch_depth})")
    if packed not in ("auto", "byte", "off"):
        raise ValueError(f"packed must be auto/byte/off, got {packed!r}")
    if d2h_packed not in ("auto", "off"):
        raise ValueError(f"d2h_packed must be auto/off, got {d2h_packed!r}")
    if ingest_overlap not in ("auto", "on", "off"):
        raise ValueError(
            f"ingest_overlap must be auto/on/off, got {ingest_overlap!r}"
        )
    # auto == on: the producer is pure scheduling (byte-identical output)
    overlap_on = ingest_overlap != "off"
    on_cuda = dev.type == "cuda"
    rep = RunReport(backend="torch-stream", device=str(dev))
    rep.n_drain_workers = drain_workers
    rep.ingest_overlap = overlap_on
    duplex = consensus.mode == "duplex"
    t_start = time.monotonic()
    # chaos harness: a DUT_FAULTS schedule gets fresh hit counters
    install_from_env()

    # auto-checkpoint, initialised BEFORE any input is read so a stale
    # manifest can never survive an early crash
    auto_ckpt = checkpoint_path is None
    if auto_ckpt:
        checkpoint_path = out_path + ".ckpt"
    fp = _fingerprint(
        in_path, grouping, consensus, capacity, chunk_reads,
        mate_aware=mate_aware, max_reads=max_reads,
        per_base_tags=per_base_tags, read_group=read_group,
    )
    ckpt = Checkpoint.load_or_create(
        checkpoint_path, fp, verify=resume, expect_codec=bgzf.deflate_flavor(),
    )
    if not resume:
        # persist a fresh manifest NOW: this run is about to overwrite
        # the shard files an old manifest points at
        ckpt.done = {}
        ckpt.save()

    chunk_iter = iter_batch_chunks(
        in_path, chunk_reads, duplex,
        warn_mixed=False,  # the chunk loop owns the warning
    )
    first = next(chunk_iter, None)
    grouping = resolve_mate_aware(
        grouping, first[2] if first is not None else {}, mate_aware
    )
    rep.mate_aware = grouping.mate_aware
    chunk_iter = itertools.chain([] if first is None else [first], chunk_iter)

    prof = None
    if profile_dir:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_cuda else [])
        prof = profile(activities=acts)
        prof.start()

    header_out: BamHeader | None = None
    shard_dir = out_path + ".shards"
    os.makedirs(shard_dir, exist_ok=True)
    shards: dict[int, str] = {}
    inflight: deque = deque()  # (chunk idx, drain future), chunk order
    spec_cache: dict = {}
    # the dut-* thread-name prefixes name the trace lanes
    xfer = ThreadPoolExecutor(max_workers=XFER_WORKERS, thread_name_prefix="dut-xfer")
    drain = ThreadPoolExecutor(max_workers=drain_workers, thread_name_prefix="dut-drain")
    phase_lock = threading.Lock()
    # set when the run is going down: drain workers stop their retry
    # ladders instead of grinding through backoff the shutdown waits on
    aborting = threading.Event()
    # one CUDA stream per thread that dispatches (transfer workers, and
    # drain workers on the retry path): a class's H2D, pipeline,
    # compaction and D2H all run on it, in order, so no tensor crosses
    # streams and the caching allocator reuses a block only after the
    # stream's earlier work on it
    streams = threading.local()

    def _stream_ctx():
        if not on_cuda:
            return contextlib.nullcontext()
        s = getattr(streams, "s", None)
        if s is None:
            s = streams.s = torch.cuda.Stream(dev)
        return torch.cuda.stream(s)

    # per-stage BUSY seconds accrued on whichever thread runs the stage
    # (they overlap, so they do not sum to the wall); every += pairs
    # with a trace span of the SAME (t0, dt), so a capture's per-stage
    # sums reproduce these totals (the trace sum-check)
    phase = {
        "ingest": 0.0, "bucketing": 0.0, "dispatch": 0.0,
        "device_wait_fetch": 0.0, "scatter": 0.0, "deflate": 0.0,
        "shard_write": 0.0, "ckpt": 0.0, "finalise": 0.0,
        "main_loop_stall": 0.0, "prefetch_stall": 0.0,
        "ingest_stall": 0.0, "ingest_backpressure": 0.0,
    }
    # byte ledger (while tracing): every += pairs with a tr.xfer record
    # of the same increment. Guarded by phase_lock.
    led = {
        "h2d_logical": 0, "h2d_wire": 0, "d2h_logical": 0, "d2h_wire": 0,
        "shard_logical": 0, "shard_wire": 0, "output_overhead_bytes": 0,
    }
    # device-ledger side table (while tracing): one entry per (chunk,
    # class), folded by dispatch, popped by the drain into ONE dev
    # record. Guarded by phase_lock.
    dev_pending: dict = {}
    # classes whose first pipeline call was timed (jit_compile event)
    dev_compiled: set = set()

    # the packed return path: one run-level decision (the per-class
    # capacity is re-checked at dispatch); per-base tags fetch the full
    # (F, L) depth/err matrices, which the compact layout does not carry
    d2h_on = (
        packed != "off" and d2h_packed != "off"
        and d2h_pack_ok(capacity, per_base_tags)
    )
    ids16_want = packed != "off" and d2h_packed != "off"
    if ids16_want and not d2h_on:
        telemetry.emit_event(
            "packed_fallback", scope="d2h",
            reason=(
                "per-base-tags-fetch-full-matrices" if per_base_tags
                else "ids-overflow-u16"
            ),
            capacity=capacity,
        )
    fetch_extra = PER_BASE_KEYS if per_base_tags else ()
    # bounded H2D prefetch window: one permit per dispatched chunk,
    # taken by the main loop before its transfers are submitted and
    # returned by the drain worker once the chunk's device results are
    # on the host (finally-backstopped, so a plain acquire cannot
    # deadlock)
    prefetch_sem = threading.Semaphore(prefetch_depth)
    # run-level qual-alphabet union for the sub-byte rung: it only
    # grows, so a rare qual bin cannot flip the rung chunk to chunk
    # (None = overflowed every dictionary width; scanning stopped)
    alpha_seen: set | None = set()

    def dispatch(buckets, spec, chunk=None):
        """Stack + pack one class on the host, then on this thread's
        stream: H2D, the fused pipeline, the packed-D2H compaction and
        the D2H copies into pinned buffers. Returns the Fetch whose
        event closes the class's device work."""
        t0 = time.monotonic()
        fault_point("dispatch.device_put")
        stacked = stack_buckets(buckets, multiple_of=1)
        logical = stacked_nbytes(stacked) if tr is not None else 0
        fault_point("dispatch.pack")
        if spec.packed_io:
            pack_stacked(stacked, spec)
        h2d = stacked_nbytes(stacked)
        n_stacked = int(stacked["pos"].shape[0])
        rows_pad = n_stacked * buckets[0].capacity
        rows_real = sum(int(bk.valid.sum()) for bk in buckets)
        l_cyc = int(buckets[0].bases.shape[1])
        flops_d = analytic_flops(
            spec, buckets[0].capacity, l_cyc, int(buckets[0].umi.shape[1])
        ) * n_stacked
        first_call = False
        if tr is not None:
            with phase_lock:
                first_call = spec not in dev_compiled
                if first_call:
                    dev_compiled.add(spec)
        rung, fallback = d2h_rung_for_class(
            d2h_on, ids16_want, buckets[0].capacity, per_base_tags
        )
        if fallback is not None:
            telemetry.emit_event(
                "packed_fallback", scope="d2h",
                reason=fallback, capacity=buckets[0].capacity,
            )
        with _stream_ctx():
            staging: list = []
            args = stacked_from_numpy(stacked, dev, pin=on_cuda, keep=staging)
            t_pipe = time.monotonic()
            out = fused_pipeline(*(args[k] for k in ARRAY_KEYS), spec)
            del args
            if tr is not None and first_call:
                # the first call of a fresh class on this engine: host
                # wall of an eager call that pays lazy CUDA module
                # loading and allocator growth (nothing is compiled)
                tr.event(
                    "jit_compile", chunk=chunk,
                    compile_s=round(time.monotonic() - t_pipe, 6),
                    cap=int(buckets[0].capacity), cycles=l_cyc,
                    method=spec.ssc_method,
                )
            if rung == "packed":
                out = start_fetch(
                    pack_fetch_outputs(out, spec, d2h_k_pad(buckets, spec)),
                    keys=PACKED_FETCH_KEYS, staging=staging,
                )
            elif rung == "ids16":
                out = start_fetch(
                    pack_ids_u16(out, duplex), keys=IDS16_FETCH_KEYS,
                    staging=staging, extra=fetch_extra,
                )
            else:
                out = start_fetch(out, staging=staging, extra=fetch_extra)
        disp_dt = time.monotonic() - t0
        with phase_lock:
            phase["dispatch"] += disp_dt
            rep.bytes_h2d += h2d
            rep.device_flops += flops_d
            rep.n_rows_real += rows_real
            rep.n_rows_padded += rows_pad
            if tr is not None:
                led["h2d_logical"] += logical
                led["h2d_wire"] += h2d
                ent = dev_pending.setdefault((chunk, spec), {
                    "cap": int(buckets[0].capacity), "cycles": l_cyc,
                    "method": spec.ssc_method, "buckets": 0,
                    "flops": 0.0, "h2d_wire": 0, "disp_s": 0.0,
                })
                ent["buckets"] += n_stacked
                ent["flops"] += flops_d
                ent["h2d_wire"] += h2d
                ent["disp_s"] += disp_dt
        if tr is not None:
            tr.span("dispatch", t0, disp_dt, chunk=chunk, n_buckets=len(buckets))
            # bpc = wire bits per base/qual cycle of this class's rung
            bpc = (
                2 + spec.packed_qbits if spec.packed_qbits
                else 8 if spec.packed_io else 16
            )
            tr.xfer(
                "h2d", logical, h2d, t0, disp_dt, chunk=chunk,
                bpc=bpc, rows_real=rows_real, rows_pad=rows_pad,
                cap=buckets[0].capacity, mesh_pad=0,
            )
        return out

    def unpack(raw, cbuckets, cspec):
        """Exact unpacked FETCH_KEYS arrays from a fetched dict (identity
        when the rung is off). Returns (full dict, wire bytes moved,
        logical bytes the unpacked fetch would have moved)."""
        wire = sum(v.nbytes for v in raw.values() if hasattr(v, "nbytes"))
        full = _io_retry(
            "fetch.unpack",
            lambda: unpack_fetch_outputs(raw, cbuckets, cspec),
            "packed d2h unpack",
        )
        return full, wire, d2h_logical_nbytes(raw, cbuckets, cspec)

    def _backoff(err, attempt, k, **attrs):
        delay = min(0.5 * (2 ** attempt), 8.0)
        with phase_lock:
            rep.n_retries += 1
        if isinstance(err, torch.OutOfMemoryError) and on_cuda:
            torch.cuda.empty_cache()
        if tr is not None:
            tr.event(
                "retry", chunk=k, site="device.execute",
                attempt=attempt + 1, max_attempts=max_retries,
                backoff_s=round(delay, 3), error=repr(err)[:200], **attrs,
            )
        print(
            f"[duplexumi] chunk {k} device execution failed ({err!r}); "
            f"retry {attempt + 1}/{max_retries} in {delay:.1f}s",
            file=sys.stderr,
        )
        time.sleep(delay)

    def materialize(out, cbuckets, cspec, k):
        """Device results -> host arrays, with recovery for retryable
        failures: bounded backoff class retries, then bucket-by-bucket
        re-dispatch to isolate a poisoned bucket. Returns (outputs,
        wire_bytes, logical_bytes)."""
        try:
            return unpack(fetch_outputs(out.result()), cbuckets, cspec)
        except D2hCompactionOverflow:
            raise  # deterministic invariant violation: no retry
        except Exception as e:
            if not _retryable(e):
                raise
            err = e
        for attempt in range(max_retries):
            if aborting.is_set():
                raise err
            _backoff(err, attempt, k)
            try:
                return unpack(
                    fetch_outputs(dispatch(cbuckets, cspec, chunk=k)),
                    cbuckets, cspec,
                )
            except D2hCompactionOverflow:
                raise
            except Exception as e:
                if not _retryable(e):
                    raise
                err = e
        if tr is not None:
            tr.event("bucket_isolation", chunk=k, n_buckets=len(cbuckets))
        print(
            f"[duplexumi] chunk {k}: class retries exhausted; "
            f"re-dispatching {len(cbuckets)} buckets individually",
            file=sys.stderr,
        )
        rows: dict[str, list] = {}
        wire_total = logical_total = 0
        for bi, bk in enumerate(cbuckets):
            last = None
            for attempt in range(max_retries):
                if aborting.is_set():
                    raise RuntimeError(
                        f"chunk {k} bucket {bi}: run aborting"
                    ) from (last or err)
                try:
                    raw = fetch_outputs(dispatch([bk], cspec, chunk=k))
                    single, w1, l1 = unpack(raw, [bk], cspec)
                    single = {key: np.asarray(v)[0] for key, v in single.items()}
                    break
                except D2hCompactionOverflow:
                    raise
                except Exception as e:
                    if not _retryable(e):
                        raise
                    last = e
                    _backoff(e, attempt, k, bucket=bi)
            else:
                raise RuntimeError(
                    f"chunk {k} bucket {bi} failed {max_retries} "
                    f"re-dispatches; giving up"
                ) from last
            wire_total += w1
            logical_total += l1
            for key, v in single.items():
                rows.setdefault(key, []).append(v)
        return (
            {key: np.stack(v) for key, v in rows.items()},
            wire_total, logical_total,
        )

    def drain_chunk(k, entries, batch):
        """Consumer side of the pipeline for ONE chunk, on a drain
        worker: materialize, scatter, serialize + deflate + durably
        write the shard. Returns the commit payload (committing stays
        on the main thread, in chunk order). Releases the chunk's
        prefetch permit once its device results are on the host."""
        released = [False]

        def release_prefetch():
            if not released[0]:
                released[0] = True
                prefetch_sem.release()

        def on_stage(stage, t0, dt):
            with phase_lock:
                phase[stage] += dt
            if tr is not None:
                tr.span(stage, t0, dt, chunk=k)

        try:
            return _drain_chunk_body(k, entries, batch, on_stage, release_prefetch)
        finally:
            release_prefetch()

    def _drain_chunk_body(k, entries, batch, on_stage, release_prefetch):
        parts = []
        pair_base = 0
        for i, (fut, cbuckets, cspec) in enumerate(entries):
            t0 = time.monotonic()
            out, d2h_wire, d2h_logical = materialize(fut, cbuckets, cspec, k)
            if i == len(entries) - 1:
                # every class of this chunk is off the device: open the
                # prefetch window before the host-heavy tail
                release_prefetch()
            dt = time.monotonic() - t0
            dent = None
            with phase_lock:
                phase["device_wait_fetch"] += dt
                rep.device_seconds += dt
                rep.bytes_d2h += d2h_wire
                rep.n_families += int(out["n_families"].sum())
                rep.n_molecules += int(out["n_molecules"].sum())
                if tr is not None:
                    led["d2h_wire"] += d2h_wire
                    led["d2h_logical"] += d2h_logical
                    dent = dev_pending.pop((k, cspec), None)
            if tr is not None:
                tr.span("device_wait_fetch", t0, dt, chunk=k)
                if dent is not None:
                    tr.dev(
                        t0, dt, chunk=k,
                        cap=dent["cap"], cycles=dent["cycles"],
                        buckets=dent["buckets"], method=dent["method"],
                        flops=round(dent["flops"], 3),
                        h2d_wire=dent["h2d_wire"], d2h_wire=d2h_wire,
                        disp_s=round(dent["disp_s"], 6),
                    )
                tr.xfer("d2h", d2h_logical, d2h_wire, t0, dt, chunk=k)
            t0 = time.monotonic()
            parts.append(
                _io_retry(
                    "drain.scatter",
                    lambda: scatter_bucket_outputs(
                        out, cbuckets, batch, duplex, pair_base=pair_base,
                        want_depth=per_base_tags,
                    ),
                    f"chunk {k} scatter",
                )
            )
            dt = time.monotonic() - t0
            with phase_lock:
                phase["scatter"] += dt
            if tr is not None:
                tr.span("scatter", t0, dt, chunk=k)
            pair_base += len(cbuckets)
        on_xfer = None
        if tr is not None:

            def on_xfer(logical, wire, t0, dt):
                with phase_lock:
                    led["shard_logical"] += logical
                    led["shard_wire"] += wire
                tr.xfer("shard", logical, wire, t0, dt, chunk=k)

        res = _finish_chunk(
            k, parts, duplex, shard_dir, serialize_bam, header_out, name_tag,
            paired_out=grouping.mate_aware, read_group=read_group,
            on_stage=on_stage, on_xfer=on_xfer,
        )
        return res + (False,)  # marked=False: commit still owes the mark

    # ---- ordered-completion frontier: chunk k is committed (mark +
    # finalise append) only when every chunk < k is durable, so resume
    # never splices around a hole. done_q buffers chunks that finished
    # early (<= max_inflight entries).
    done_q: dict[int, tuple] = {}
    fin: dict = {"f": None}
    frontier = 0
    tmp_path = out_path + ".tmp"

    def _fin_open():
        # first commit: create the tmp and write the derived header
        # (opened lazily: read_group/header_out resolve on chunk 0)
        from duplexumiconsensusreads_torch.io.bam import derive_output_header

        hdr = derive_output_header(
            header_out, sort_order="coordinate", rg_id=read_group,
            cl=provenance_cl,
        )
        shell_c = bgzf.compress_fast(serialize_bam(hdr, _empty_records()), eof=False)
        f = open(tmp_path, "wb")
        try:
            _io_retry("finalise.write", lambda: rewrite_from(f, 0, shell_c),
                      "finalise header")
        except BaseException:
            try:
                f.close()
            except OSError:
                pass
            raise
        fin["f"] = f
        if tr is not None:
            with phase_lock:
                led["output_overhead_bytes"] += len(shell_c)

    def _commit(k, payload):
        """Main-thread commit of a drained chunk: durable mark first,
        then the idempotent append into the tmp assembly."""
        if commit_guard is not None:
            commit_guard(k)
        shard, size, crc, n_rec, n_pairs, codec, data, marked = payload
        shards[k] = shard
        if not marked:
            t0 = time.monotonic()
            ckpt.mark(k, shard, size, crc, n_rec, n_pairs, codec)
            dt = time.monotonic() - t0
            phase["ckpt"] += dt
            if tr is not None:
                tr.span("ckpt", t0, dt, chunk=k)
        t0 = time.monotonic()
        if fin["f"] is None:
            _fin_open()
        if data is None:
            # resume-skipped chunk: the shard bytes live only on disk
            def _read():
                with open(shard, "rb") as s:
                    return s.read()

            data = _io_retry("finalise.write", _read, f"shard {k} read")
        if data:
            f = fin["f"]
            off = f.tell()
            _io_retry("finalise.write", lambda: rewrite_from(f, off, data),
                      "finalise append")
        rep.n_consensus += n_rec
        rep.n_consensus_pairs += n_pairs
        dt = time.monotonic() - t0
        phase["finalise"] += dt
        if tr is not None:
            tr.span("finalise", t0, dt, chunk=k)
        if progress:
            progress(k, rep)

    def _advance_frontier():
        nonlocal frontier
        while frontier in done_q:
            _commit(frontier, done_q.pop(frontier))
            frontier += 1

    def _wait_oldest():
        """Back-pressure: block on the OLDEST outstanding chunk. Worker
        exceptions (InjectedKill included) re-raise here."""
        k, fut = inflight.popleft()
        t0 = time.monotonic()
        res = fut.result()
        dt = time.monotonic() - t0
        phase["main_loop_stall"] += dt
        if tr is not None:
            tr.span("main_loop_stall", t0, dt, chunk=k)
        done_q[k] = res
        _advance_frontier()

    def _prep_chunk(k, batch):
        """Per-chunk host prep: family downsample -> build_buckets ->
        qual-alphabet union. One caller at a time, in chunk order
        (inline on the main thread, or the ingest producer), so the
        alphabet decisions — and the bytes — match across modes."""
        nonlocal alpha_seen
        n_down = downsample_families(batch, max_reads) if max_reads > 0 else 0
        fb: dict = {}
        t0 = time.monotonic()
        buckets = build_buckets(batch, capacity=capacity, grouping=grouping, counters=fb)
        alpha = None
        if packed == "auto" and buckets and alpha_seen is not None:
            alpha_seen.update(qual_alphabet(buckets))
            if len(alpha_seen) > _ALPHA_CAP:
                alpha_seen = None  # the byte rung owns the rest of the run
            else:
                alpha = tuple(sorted(alpha_seen))
        dt = time.monotonic() - t0
        with phase_lock:
            phase["bucketing"] += dt
        if tr is not None:
            tr.span("bucketing", t0, dt, chunk=k, n_buckets=len(buckets))
        return buckets, alpha, fb, n_down

    def timed_chunks(it):
        i = 0
        while True:
            t0 = time.monotonic()
            item = next(it, None)
            dt = time.monotonic() - t0
            phase["ingest"] += dt
            if tr is not None:
                tr.span("ingest", t0, dt, chunk=i if item is not None else None)
            if item is None:
                return
            i += 1
            yield item

    if heartbeat_s and heartbeat_s > 0:

        def _hb_stats():
            elapsed = max(time.monotonic() - t_start, 1e-9)
            with phase_lock:
                stall = phase["main_loop_stall"]
                drain_busy = sum(phase[k] for k in DRAIN_PHASES)
                retries = rep.n_retries
            return {
                "elapsed_s": round(elapsed, 1),
                "chunks_done": frontier,
                "chunks_inflight": len(inflight),
                "stall_frac": round(stall / elapsed, 3),
                "retries": retries,
                "drain_util": round(min(drain_busy / (drain_workers * elapsed), 1.0), 3),
            }

        hb_box.append(Heartbeat(heartbeat_s, _hb_stats, recorder=tr).start())

    # ---- bounded background producer (ingest_overlap): BGZF read +
    # decode + bucketing run on one "dut-ingest" thread up to
    # prefetch_depth chunks ahead of the main loop, in chunk order, so
    # the consumer sees exactly the sequence the sync path would.
    # Producer errors forward through the queue and re-raise on the
    # main loop.
    ingest_thread: threading.Thread | None = None
    if overlap_on:
        ingest_q: _queue.Queue = _queue.Queue(maxsize=prefetch_depth)
        # ckpt.done only grows with marks of chunks the frontier already
        # committed, so this snapshot equals the sync path's live check
        done_set = frozenset(int(s) for s in ckpt.done)

        def _q_put(item, chunk):
            _io_retry("ingest.queue", _noop, "ingest queue handoff")
            t0 = time.monotonic()
            while True:
                if aborting.is_set():
                    raise _IngestAbort()
                try:
                    ingest_q.put(item, timeout=0.05)
                    break
                except _queue.Full:
                    continue
            dt = time.monotonic() - t0
            with phase_lock:
                phase["ingest_backpressure"] += dt
            if tr is not None:
                tr.span("ingest_backpressure", t0, dt, chunk=chunk)

        def _ingest_producer():
            try:
                it = iter(chunk_iter)
                k = 0
                while True:
                    t0 = time.monotonic()
                    item = next(it, None)
                    dt = time.monotonic() - t0
                    with phase_lock:
                        phase["ingest"] += dt
                    if tr is not None:
                        tr.span("ingest", t0, dt, chunk=k if item is not None else None)
                    if item is None:
                        _q_put(("done", None), None)
                        return
                    # resume-skipped chunks splice from disk unprepped
                    prep = None if k in done_set else _prep_chunk(k, item[1])
                    _q_put(("item", (k, item, prep)), k)
                    k += 1
            except _IngestAbort:
                pass  # the main loop owns the error
            except BaseException as e:
                while not aborting.is_set():
                    try:
                        ingest_q.put(("err", e), timeout=0.05)
                        break
                    except _queue.Full:
                        continue

        ingest_thread = threading.Thread(
            target=_ingest_producer, name="dut-ingest", daemon=True
        )

        def _overlap_chunks():
            while True:
                t0 = time.monotonic()
                while True:
                    try:
                        kind, payload = ingest_q.get(timeout=0.05)
                        break
                    except _queue.Empty:
                        if not ingest_thread.is_alive() and ingest_q.empty():
                            raise RuntimeError("ingest producer died without a result")
                dt = time.monotonic() - t0
                phase["ingest_stall"] += dt
                if tr is not None:
                    tr.span(
                        "ingest_stall", t0, dt,
                        chunk=payload[0] if kind == "item" else None,
                    )
                if kind == "done":
                    return
                if kind == "err":
                    raise payload
                yield payload

        chunk_stream = _overlap_chunks()
    else:

        def _sync_chunks():
            for k, item in enumerate(timed_chunks(iter(chunk_iter))):
                yield k, item, None

        chunk_stream = _sync_chunks()

    n_skipped = 0
    try:
        if ingest_thread is not None:
            ingest_thread.start()
        for k, (header, batch, info), prep in chunk_stream:
            if header_out is None:
                header_out = header
                from duplexumiconsensusreads_torch.io.bam import unique_read_group_id

                read_group = unique_read_group_id(header.text, read_group)
            rep.n_chunks += 1
            if str(k) in ckpt.done:
                # verified (size + CRC) by load_or_create; the commit
                # still flows through the frontier to keep chunk order
                e = ckpt.done[str(k)]
                if tr is not None:
                    tr.event("resume", chunk=k, decision="reused")
                    tr.xfer("shard", None, e["size"], time.monotonic(), 0.0,
                            chunk=k, resumed=True)
                    with phase_lock:
                        led["shard_wire"] += e["size"]
                done_q[k] = (
                    e["path"], e["size"], e["crc32"],
                    e["n_records"], e["n_pairs"], e["codec"], None, True,
                )
                n_skipped += 1
                _advance_frontier()
                continue
            if tr is not None and resume:
                tr.event("resume", chunk=k, decision="recomputed")
            # per-read counters cover FRESH work only
            rep.n_records += info["n_records"]
            rep.n_valid_reads += info["n_valid"]
            rep.n_dropped += (
                info["n_dropped_no_umi"]
                + info["n_dropped_umi_len"]
                + info.get("n_dropped_flag", 0)
                + info.get("n_dropped_cigar", 0)
            )
            rep.n_rescued_cigar += info.get("n_rescued_cigar", 0)
            rep.n_dropped_cigar_ab += info.get("n_dropped_cigar_ab", 0)
            rep.n_dropped_cigar_ba += info.get("n_dropped_cigar_ba", 0)
            rep.n_mixed_mate_families += info.get("n_mixed_mate_families", 0)
            if info.get("n_mixed_mate_families") and not grouping.mate_aware:
                from duplexumiconsensusreads_torch.io.convert import MIXED_MATE_WARNING

                warnings.warn(MIXED_MATE_WARNING)
            if prep is None:
                prep = _prep_chunk(k, batch)
            buckets, alpha, fb, n_down = prep
            rep.n_downsampled_reads += n_down
            for fk, fv in fb.items():
                setattr(rep, fk, getattr(rep, fk) + fv)
            rep.n_buckets += len(buckets)
            if not buckets:
                spath, ssize, scrc = _write_shard(shard_dir, k, b"")
                if tr is not None:
                    tr.xfer("shard", 0, ssize, time.monotonic(), 0.0, chunk=k)
                    with phase_lock:
                        led["shard_wire"] += ssize
                done_q[k] = (
                    spath, ssize, scrc, 0, 0, bgzf.deflate_flavor(), b"", False,
                )
                _advance_frontier()
                continue
            t0 = time.monotonic()
            prefetch_sem.acquire()
            dt = time.monotonic() - t0
            phase["prefetch_stall"] += dt
            if tr is not None:
                tr.span("prefetch_stall", t0, dt, chunk=k)
            entries = []
            for cbuckets, cspec in partition_buckets(
                buckets, grouping, consensus,
                packed_io=(packed != "off"), per_base_counts=per_base_tags,
                qual_alphabet=alpha,
            ):
                spec_cache[cspec] = True
                # submit never raises: failures surface in materialize
                entries.append((xfer.submit(dispatch, cbuckets, cspec, k), cbuckets, cspec))
            inflight.append((k, drain.submit(drain_chunk, k, entries, batch)))
            while len(inflight) >= max_inflight:
                _wait_oldest()
        while inflight:
            _wait_oldest()
    except BaseException:
        # stop surviving workers' retry ladders and release the tmp
        # handle (the tmp stays on disk, never visible at out_path)
        aborting.set()
        if fin["f"] is not None:
            try:
                fin["f"].close()
            except OSError:
                pass
        raise
    finally:
        if ingest_thread is not None and ingest_thread.is_alive():
            ingest_thread.join(timeout=30.0)
        drain.shutdown(wait=True, cancel_futures=True)
        xfer.shutdown(wait=True, cancel_futures=True)
        if prof is not None:
            # a teardown failure must never mask the run's own error
            try:
                prof.stop()
                os.makedirs(profile_dir, exist_ok=True)
                prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
            except Exception as e:  # noqa: BLE001 — telemetry teardown
                print(f"[duplexumi] torch.profiler teardown failed: {e!r}",
                      file=sys.stderr)
            else:
                if tr is not None:
                    tr.event("profile_written", profile_dir=os.path.abspath(profile_dir))

    # ---- terminal finalise: EOF block + fsync + the one atomic rename
    t_fin = time.monotonic()
    try:
        if fin["f"] is None:
            # record-less input: the header is still authoritative
            if header_out is None:
                _r = BamStreamReader(in_path)
                header_out = _r.header
                _r.close()
            _fin_open()
        f = fin["f"]
        end = f.tell()

        def _publish():
            rewrite_from(f, end, bgzf.BGZF_EOF)
            fsync_file(f)

        _io_retry("finalise.write", _publish, "finalise")
        if tr is not None:
            led["output_overhead_bytes"] += len(bgzf.BGZF_EOF)
        f.close()
    except BaseException:
        if fin["f"] is not None:
            try:
                fin["f"].close()
            except OSError:
                pass
        raise
    _io_retry("finalise.write", lambda: replace_durable(tmp_path, out_path),
              "finalise rename")
    if auto_ckpt:
        # the implicit checkpoint has served its purpose
        for path in shards.values():
            try:
                os.remove(path)
            except OSError:
                pass
        for rm in (lambda: os.rmdir(shard_dir), lambda: os.remove(checkpoint_path)):
            try:
                rm()
            except OSError:
                pass
    if write_index:
        write_bam_index(out_path, header_out.ref_lengths)
    dt_fin = time.monotonic() - t_fin
    phase["finalise"] += dt_fin
    if tr is not None:
        # terminal EOF/fsync/rename (+ optional index): chunkless span
        tr.span("finalise", t_fin, dt_fin)
    rep.n_chunks_skipped = n_skipped
    rep.n_pipeline_compiles = len(spec_cache)
    total = time.monotonic() - t_start
    for pk, pv in phase.items():
        rep.seconds[pk] = round(pv, 3)
    # drain busy seconds over the pool's capacity: ~1.0 means the drain
    # pool, not the device, bounds the run
    drain_busy = sum(phase[k] for k in DRAIN_PHASES)
    rep.seconds["drain_utilization"] = round(
        min(drain_busy / max(drain_workers * total, 1e-9), 1.0), 3
    )
    rep.seconds["total"] = round(total, 3)
    if tr is not None:
        # stop the heartbeat BEFORE the summary: the summary must be the
        # capture's last record
        for _hb in hb_box:
            _hb.stop()
        try:
            out_bytes = os.path.getsize(out_path)
        except OSError:
            out_bytes = 0
        tr.write_summary(
            seconds=dict(rep.seconds),
            counters={
                "n_chunks": rep.n_chunks,
                "n_chunks_skipped": rep.n_chunks_skipped,
                "n_retries": rep.n_retries,
                "n_drain_workers": rep.n_drain_workers,
                "n_records": rep.n_records,
                "n_rows_real": rep.n_rows_real,
                "n_rows_padded": rep.n_rows_padded,
                "n_mesh_pad_buckets": rep.n_mesh_pad_buckets,
                "n_devices": rep.n_devices,
            },
            bytes={
                **led,
                "output_bytes": int(out_bytes),
                "output_path": os.path.abspath(out_path),
            },
        )
    if report_path:
        from duplexumiconsensusreads_torch.runtime.executor import write_report

        write_report(rep, report_path)
    return rep


def _empty_records() -> BamRecords:
    return BamRecords(
        names=[],
        flags=np.zeros(0, np.uint16),
        ref_id=np.zeros(0, np.int32),
        pos=np.zeros(0, np.int32),
        mapq=np.zeros(0, np.uint8),
        next_ref_id=np.zeros(0, np.int32),
        next_pos=np.zeros(0, np.int32),
        tlen=np.zeros(0, np.int32),
        lengths=np.zeros(0, np.int32),
        seq=np.zeros((0, 0), np.uint8),
        qual=np.zeros((0, 0), np.uint8),
        cigars=[],
        umi=[],
        aux_raw=[],
    )


def _write_shard(shard_dir: str, k: int, payload: bytes) -> tuple[str, int, int]:
    """Durable shard write (tmp + fsync + atomic rename + dir fsync)
    inside the bounded transient-I/O retry. Returns (path, size,
    crc32) — the manifest triple resume verification re-checks."""
    path = os.path.join(shard_dir, f"chunk{k:06d}.recs")
    crc = zlib.crc32(payload)

    def _once():
        write_durable(path, payload, tmp=unique_tmp(path))
        return path, len(payload), crc

    return _io_retry("shard.write", _once, f"shard {k} write")


def _count_records(data: bytes) -> tuple[int, int]:
    """(record count, complete consensus R1+R2 pairs) of a raw record
    stream — pairs by PAIRED|PROPER_PAIR|READ1, as
    runtime.executor.count_consensus_pairs counts them."""
    from duplexumiconsensusreads_torch.io.bam import (
        FLAG_PAIRED,
        FLAG_PROPER_PAIR,
        FLAG_READ1,
    )

    want = FLAG_PAIRED | FLAG_PROPER_PAIR | FLAG_READ1
    n = n_pairs = 0
    off = 0
    while off < len(data):
        (bsz,) = struct.unpack_from("<i", data, off)
        # flag = high 16 bits of the flag_nc word at body offset 12
        (flag,) = struct.unpack_from("<H", data, off + 4 + 14)
        if (flag & want) == want:
            n_pairs += 1
        off += 4 + bsz
        n += 1
    return n, n_pairs


def _finish_chunk(
    k, parts, duplex, shard_dir, serialize_bam, header, name_tag="",
    paired_out=False, read_group="A", on_stage=None, on_xfer=None,
) -> tuple[str, int, int, int, int, str, bytes]:
    """Merge one chunk's per-class scattered outputs and write its
    shard: the BGZF-compressed record stream (header stripped, so
    shards concatenate). Returns (path, size, crc32, n_records,
    n_pairs, codec, shard_bytes) — the commit payload. ``on_stage(stage,
    t0, dt)`` accounts "shard_write" and "deflate"; ``on_xfer(logical,
    wire, t0, dt)`` is the byte-ledger hook."""
    t0 = time.monotonic()
    cols = sort_consensus_outputs(*(np.concatenate(x) for x in zip(*parts)))
    cb, cq, cd, fp, fu, mate, pair, end = cols[:8]
    recs = consensus_to_records(
        cb, cq, cd, np.ones(len(cb), bool), fp, fu,
        duplex=duplex,
        name_prefix=f"cons{name_tag}{k}",
        cons_mate=mate,
        cons_pair=pair,
        paired_out=paired_out,
        cons_pdepth=cols[8] if len(cols) > 8 else None,
        cons_perr=cols[9] if len(cols) > 9 else None,
        read_group=read_group,
        cons_end=end,
    )
    full = serialize_bam(header, recs)
    shell = serialize_bam(header, _empty_records())
    raw = full[len(shell):]
    n_rec, n_pairs = _count_records(raw)
    if on_stage:
        on_stage("shard_write", t0, time.monotonic() - t0)
    t0 = time.monotonic()
    comp, codec = bgzf.compress_fast_tagged(raw, eof=False)
    dt = time.monotonic() - t0
    if on_stage:
        on_stage("deflate", t0, dt)
    if on_xfer:
        on_xfer(len(raw), len(comp), t0, dt)
    t0 = time.monotonic()
    path, size, crc = _write_shard(shard_dir, k, comp)
    if on_stage:
        on_stage("shard_write", t0, time.monotonic() - t0)
    return path, size, crc, n_rec, n_pairs, codec, comp
