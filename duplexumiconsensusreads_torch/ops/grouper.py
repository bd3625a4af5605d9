"""Host helper of the grouping stage: bucket-local dense position ids."""

from __future__ import annotations

import numpy as np


def dense_pos_ids(pos_key: np.ndarray) -> np.ndarray:
    """Host int64 genomic keys -> bucket-local dense i32 ids (sorted order
    preserving, so device grouping emits ids in the same order as the
    oracle's int64 sort)."""
    _, inv = np.unique(np.asarray(pos_key), return_inverse=True)
    return inv.astype(np.int32)
