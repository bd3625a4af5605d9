"""The parts of the JAX package's parallel/sharded.py the streaming
executor reads: the stacked array keys that cross the wire, and their
byte count. One device: stacked bucket counts are padded to a multiple
of 1 (``stack_buckets(..., multiple_of=1)``), so no mesh-pad bucket is
ever shipped."""

from __future__ import annotations

from duplexumiconsensusreads_torch.interop import ARRAY_KEYS as _ARRAY_KEYS


def stacked_nbytes(stacked: dict) -> int:
    """Bytes of the stacked arrays that actually cross the wire (the
    _ARRAY_KEYS set); host-only bookkeeping (read_index,
    n_real_buckets) never leaves the host."""
    return sum(stacked[k].nbytes for k in _ARRAY_KEYS)
