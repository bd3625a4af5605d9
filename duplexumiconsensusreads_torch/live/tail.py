"""The tailing producer: a file-like follower of a growing BGZF stream.

The JAX package's live/tail.py, copied; only the imports name the
port. The tailer never touches the card: its bytes reach the stream's
reader, whose native inflate and ingest producer run as in a batch run.

``TailSource`` sits between the growing input and ``BamStreamReader``.
The reader calls plain ``read``/``tell``/``seek`` and cannot tell it is
not holding a finished file; the tailing thread behind those calls
polls the input, admits only complete-BGZF-block byte runs, and decides
when the stream is finished. Admission is the whole trick: the stream
reader's contract is "``read()`` returns b'' only at true EOF, and the
bytes before it form whole BGZF blocks" — a growing file violates both
(it has a perpetually torn tail and a perpetually moving end), so the
tailer buffers the torn tail privately and releases bytes only up to
the last complete block boundary (``_complete_prefix``, the same rule
the batch reader applies to its rolling buffer).

Thread model (declared as the ``live-tail`` row in
``runtime/knobs.py`` THREAD_ROLES): the tailer performs pure host I/O
against the input — no device calls, no durable state moves (the
admission watermark is persisted by the main loop at commit time) —
and its only output seam is the bounded admission queue ``_q``.
Failures, including injected kills at fault site ``live.poll``, are
forwarded through the queue as an error sentinel and re-raised on the
consumer side, mirroring the overlap-mode ingest producer.

Timing is split across the seam: the tailer accumulates its idle-poll
seconds, the consumer accumulates its blocked-on-tailer seconds, both
under the source's own lock; the executor drains them into the phase
ledger (``live_poll`` / ``live_wait``) at chunk boundaries so the
tailer never touches stream.py's shared state.
"""

from __future__ import annotations

import os
import queue
import stat
import threading
import time

from duplexumiconsensusreads_torch.io import bgzf

# bounded admission queue depth, in admitted slabs (not bytes): deep
# enough to decouple poll cadence from chunk cadence, shallow enough
# that a stalled consumer stops the tailer from buffering the whole
# growing file in memory
_QUEUE_SLABS = 8

# granularity of interruptible blocking on the queue: close() must be
# able to unstick either side without poisoning the queue
_BLOCK_TICK_S = 0.1


def parse_finalize_on(spec: str):
    """``(mode, idle_s)`` from ``eof`` | ``idle:<seconds>`` | ``marker``.

    ``eof``      finish when the admitted stream ends with the 28-byte
                 BGZF EOF block (the BAM spec's own terminator — the
                 default, and what any htslib-family writer emits);
    ``idle:N``   finish when the input has not grown for N seconds
                 (writers that die without an EOF block);
    ``marker``   finish when ``<input>.done`` exists (pipelines that
                 signal completion out-of-band).
    """
    if spec == "eof":
        return "eof", None
    if spec == "marker":
        return "marker", None
    if isinstance(spec, str) and spec.startswith("idle:"):
        try:
            idle = float(spec[len("idle:"):])
        except ValueError:
            idle = -1.0
        if idle > 0:
            return "idle", idle
    raise ValueError(
        f"finalize_on must be 'eof', 'idle:<seconds>' or 'marker' "
        f"(got {spec!r})"
    )


class TailSource:
    """File-like follower of a growing BGZF file or FIFO.

    Forward-only: ``seek`` accepts only the current position (which is
    all the stream reader's retry ladder ever asks for). ``read``
    blocks until the tailer admits bytes or declares the stream
    finished; it returns b"" only at the true end, with every byte
    before it part of a complete BGZF block.
    """

    def __init__(
        self,
        path: str,
        poll_s: float = 0.25,
        finalize_on: str = "eof",
        read_size: int = 1 << 20,
    ):
        self.path = path
        self.mode, self.idle_s = parse_finalize_on(finalize_on)
        self.poll_s = max(float(poll_s), 0.001)
        self.read_size = int(read_size)
        st = os.stat(path)
        self.is_fifo = stat.S_ISFIFO(st.st_mode)
        self.finish_reason = None
        self._q = queue.Queue(maxsize=_QUEUE_SLABS)
        self._closed = threading.Event()
        self._buf = bytearray()
        self._pos = 0  # logical consumed offset (reader-visible)
        self._finished = False
        self._err = None
        self._lock = threading.Lock()
        self._admitted = 0  # bytes admitted by the tailer
        self._poll_seconds = 0.0  # tailer side: idle-poll sleep time
        self._wait_seconds = 0.0  # consumer side: blocked-on-tailer time
        self._thread = threading.Thread(
            target=self._tail_loop, name="dut-live-tail", daemon=True
        )
        self._thread.start()

    # ---------------------------------------------- tailer thread side

    def _read_poll(self, f):
        # one poll cycle: a single incremental read of the growing
        # input. Fault site live.poll wraps this call — transients ride
        # the standard bounded-retry ladder on the tailer itself; kills
        # forward through the queue's error sentinel
        return f.read(self.read_size)

    def _put(self, item) -> None:
        # bounded handoff in interruptible steps: close() (run abort)
        # must unstick a tailer blocked on a full queue
        while not self._closed.is_set():
            try:
                self._q.put(item, timeout=_BLOCK_TICK_S)
                return
            except queue.Full:
                continue

    def _finish_drained(self, pending: bytes, why: str) -> None:
        # idle/marker/writer-close finalisation reached with a torn
        # trailing block: the input ended mid-write. Refuse loudly —
        # silently dropping the partial block would publish an output
        # missing reads with no warning
        if pending:
            self._put(("err", ValueError(
                f"{self.path}: follow input finalised ({why}) with a "
                f"truncated trailing BGZF block ({len(pending)} bytes)"
            )))
        else:
            self._put(("done", why))

    def _tail_loop(self) -> None:
        # function-level import: runtime.stream imports this package
        # lazily for follow runs, and the tailer reuses its retry
        # ladder and block-boundary rule rather than reimplementing
        # either
        from duplexumiconsensusreads_torch.runtime.stream import (
            _complete_prefix,
            _io_retry,
        )

        try:
            with open(self.path, "rb") as f:
                pending = b""
                # rolling last-28-admitted-bytes window: the EOF block
                # is itself a complete BGZF block, so it is admitted
                # like any other and detected here, after the boundary
                # cut (has_eof_block is the single definition of
                # "finished" shared with the batch reader and merger)
                tail = b""
                last_growth = time.monotonic()
                while not self._closed.is_set():
                    data = _io_retry(
                        "live.poll", self._read_poll, "live tail poll", f
                    )
                    if data:
                        pending += data
                        last_growth = time.monotonic()
                        off = _complete_prefix(pending)
                        if off:
                            admit = bytes(pending[:off])
                            pending = pending[off:]
                            tail = (tail + admit)[-len(bgzf.BGZF_EOF):]
                            with self._lock:
                                self._admitted += len(admit)
                            self._put(admit)
                        if (
                            self.mode == "eof"
                            and not pending
                            and bgzf.has_eof_block(tail)
                        ):
                            self._put(("done", "eof"))
                            return
                        continue
                    # the read caught up with the writer
                    if (
                        self.mode == "eof"
                        and not pending
                        and bgzf.has_eof_block(tail)
                    ):
                        self._put(("done", "eof"))
                        return
                    if self.is_fifo:
                        # EOF on a pipe is definitive: the writer closed
                        # its end and the stream can never grow again
                        self._finish_drained(pending, "writer closed pipe")
                        return
                    if self.mode == "marker" and os.path.exists(
                        self.path + ".done"
                    ):
                        self._finish_drained(pending, "marker present")
                        return
                    if (
                        self.mode == "idle"
                        and time.monotonic() - last_growth >= self.idle_s
                    ):
                        self._finish_drained(
                            pending, f"idle {self.idle_s:g}s"
                        )
                        return
                    t0 = time.monotonic()
                    self._closed.wait(self.poll_s)
                    with self._lock:
                        self._poll_seconds += time.monotonic() - t0
        except BaseException as e:  # noqa: BLE001 — forwards InjectedKill
            self._put(("err", e))

    # ------------------------------------------------- consumer side

    def read(self, n: int = -1) -> bytes:
        """Blocking read of up to ``n`` admitted bytes; b"" only at the
        true end of the followed stream."""
        while not self._buf and not self._finished:
            if self._err is not None:
                raise self._err
            t0 = time.monotonic()
            try:
                item = self._q.get(timeout=_BLOCK_TICK_S)
            except queue.Empty:
                item = None
            with self._lock:
                self._wait_seconds += time.monotonic() - t0
            if item is None:
                continue
            if isinstance(item, tuple):
                kind, payload = item
                if kind == "err":
                    # sticky: the reader's own retry ladder re-reads,
                    # and every attempt must see the same failure
                    self._err = payload
                    raise payload
                self._finished = True
                self.finish_reason = payload
            else:
                self._buf += item
        if not self._buf:
            return b""
        if n is None or n < 0:
            n = len(self._buf)
        out = bytes(self._buf[:n])
        del self._buf[:n]
        self._pos += len(out)
        return out

    def tell(self) -> int:
        return self._pos

    def seek(self, pos: int, whence: int = 0) -> int:
        # the stream reader's retry ladder re-seeks to the position it
        # captured before the read — always the current one. Anything
        # else is a logic error: a growing input has no random access
        if whence != 0 or pos != self._pos:
            raise ValueError(
                f"TailSource is forward-only: cannot seek to {pos} "
                f"(at {self._pos})"
            )
        return self._pos

    def admitted_bytes(self) -> int:
        """Bytes released past the complete-block boundary so far."""
        with self._lock:
            return self._admitted

    def take_phase_seconds(self):
        """Drain ``(poll_s, wait_s)`` accumulated since the last call.

        The executor folds these into its phase ledger (``live_poll``,
        ``live_wait``) at chunk boundaries — pull-based on purpose, so
        the tailer thread never touches stream.py's shared state.
        """
        with self._lock:
            p, w = self._poll_seconds, self._wait_seconds
            self._poll_seconds = 0.0
            self._wait_seconds = 0.0
        return p, w

    def close(self) -> None:
        self._closed.set()
        self._thread.join(timeout=5.0)
