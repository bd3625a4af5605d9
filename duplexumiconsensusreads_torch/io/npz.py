"""Packed .npz interchange for ReadBatch tensors.

The testing/benchmark format SURVEY.md §7 calls for ("a simple packed
.npz/Arrow interchange so tests don't need real BAMs"): a ReadBatch is
six named arrays in one compressed npz, loadable straight onto device.
"""

from __future__ import annotations

import numpy as np

from duplexumiconsensusreads_torch.types import ReadBatch

_FIELDS = ("bases", "quals", "umi", "pos_key", "strand_ab", "frag_end", "valid")


def save_readbatch(path: str, batch: ReadBatch) -> None:
    np.savez_compressed(
        path, **{name: np.asarray(getattr(batch, name)) for name in _FIELDS}
    )


def load_readbatch(path: str) -> ReadBatch:
    with np.load(path) as z:
        fields = {}
        for name in _FIELDS:
            if name in z.files:
                fields[name] = z[name]
            elif name == "frag_end":  # pre-mate-aware npz files
                fields[name] = np.zeros(z["valid"].shape, bool)
            else:
                raise KeyError(f"ReadBatch npz missing field {name!r}")
        return ReadBatch(**fields)
