"""Follow-mode ingest: consensus as the sequencer runs.

The JAX package's live/ copied to the port unchanged but for the
imports: follow mode is host I/O, so no line of it touches the card.

The streaming executor (runtime/stream.py) normally consumes a
finished, coordinate-sorted BAM. This package turns it into a
*follower* of a growing one — a regular file another process is
appending to, or a FIFO/pipe — so consensus calling overlaps the
instrument run instead of starting after it:

``tail.TailSource``
    A file-like object the stream reader can open instead of the real
    file. A dedicated tailing thread (``dut-live-tail``, a declared
    ``THREAD_ROLES`` row) polls the growing input and admits only
    byte runs that end on a complete-BGZF-block boundary (the stream
    reader's ``_complete_prefix`` rule), so the consumer never sees a
    torn block no matter when the writer is interrupted. Termination
    is the 28-byte BGZF EOF block by default, with ``idle:<seconds>``
    and ``<path>.done`` marker modes for writers that cannot promise
    one (``parse_finalize_on``).

``watermark``
    The durable follow-run identity (``<out>.livemark``): a pinned
    ``stat_sig`` replaces the input's (size, mtime) pair in the
    checkpoint fingerprint — a growing file changes both every poll,
    and without the pin a kill/resume mid-tail would refuse its own
    checkpoint. Snapshot sequencing lives here too, so a resumed
    follower continues the published-snapshot series.

Everything else — chunk grid, hold-back boundary rule, device
pipeline, incremental finalise, checkpoint resume — is the batch
spine, unchanged: a follow run over the finished file must produce
byte-identical output (BAI included) to the batch run, which is why
every knob this package adds is scheduling-class.
"""

from duplexumiconsensusreads_torch.live import watermark
from duplexumiconsensusreads_torch.live.tail import (
    TailSource,
    parse_finalize_on,
)

__all__ = ["TailSource", "parse_finalize_on", "watermark"]
