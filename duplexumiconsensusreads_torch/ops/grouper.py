"""UmiGrouper — the operator boundary of the grouping stage.

The JAX package's ops/grouper.py:UmiGrouper, with the same inputs and
outputs on both backends:

backend="cpu": the NumPy oracle (oracle/grouping.py), also the
  correctness reference.
backend="cuda": the port's batched ``group_kernel`` as one call with a
  bucket axis of one, on ``device`` (the GPU unless the caller asks
  for the CPU, where the kernel runs as plain torch). The host presorts
  the batch, as bucketing does for the pipeline, so the kernel runs its
  presorted path.
"""

from __future__ import annotations

import numpy as np
import torch

from duplexumiconsensusreads_torch.kernels.grouping import group_kernel
from duplexumiconsensusreads_torch.oracle.grouping import group_reads as _oracle_group
from duplexumiconsensusreads_torch.runtime.executor import resolve_device
from duplexumiconsensusreads_torch.types import FamilyAssignment, GroupingParams, ReadBatch
from duplexumiconsensusreads_torch.utils.phred import pack_umi_words64

# The directional fixpoint propagates the combined key rank * U + index
# in i32; the JAX kernel states it fits for tables of at most this many
# unique (pos, UMI) keys (its kernels/grouping.py:_directional_cluster).
MAX_DIRECTIONAL_U = 2048


def dense_pos_ids(pos_key: np.ndarray) -> np.ndarray:
    """Host int64 genomic keys -> bucket-local dense i32 ids (sorted order
    preserving, so device grouping emits ids in the same order as the
    oracle's int64 sort)."""
    _, inv = np.unique(np.asarray(pos_key), return_inverse=True)
    return inv.astype(np.int32)


class UmiGrouper:
    def __init__(
        self,
        params: GroupingParams | None = None,
        backend: str = "cuda",
        u_max: int | None = None,
        device=None,
    ):
        self.params = params or GroupingParams()
        if backend not in ("cpu", "cuda"):
            raise ValueError(f"unknown backend {backend!r} (cuda or cpu)")
        self.backend = backend
        self.u_max = u_max
        self.device = device

    def __call__(self, batch: ReadBatch) -> FamilyAssignment:
        if self.backend == "cpu":
            return _oracle_group(batch, self.params)
        dev = resolve_device(self.device)
        p = self.params
        valid_arr = np.asarray(batch.valid, bool)
        if not len(valid_arr):
            return FamilyAssignment.none(0)
        # multi-word packing handles any UMI length; computed once and
        # shared by the u_max sizing and the presort below
        words = pack_umi_words64(np.asarray(batch.umi))
        words[~valid_arr] = 0
        u_max = self.u_max
        directional = p.strategy in ("adjacency", "cluster")
        if u_max is None and directional:
            # size the unique-UMI table from the data (rounded to a power
            # of two) instead of n_reads: the all-pairs grids are U x U
            key = np.column_stack(
                [np.asarray(batch.pos_key)[valid_arr], words[valid_arr]]
            )
            n_unique = max(len(np.unique(key, axis=0)), 1)
            u_max = 1 << (n_unique - 1).bit_length()
        if directional and u_max is not None and u_max > MAX_DIRECTIONAL_U:
            raise ValueError(
                f"UmiGrouper: a table of {u_max} unique (pos, UMI) slots exceeds "
                f"{MAX_DIRECTIONAL_U}, the most the directional key fits in i32; "
                f"group smaller batches (the CLI's `group --capacity N` buckets "
                f"the input by position)"
            )
        # host presort (invalid reads to the tail) so the kernel runs its
        # presorted path — the contract bucketing gives the pipeline
        w = words.shape[1]
        order = np.lexsort(
            (
                *[words[:, i] for i in range(w - 1, -1, -1)],
                np.asarray(batch.pos_key),
                ~valid_arr,
            )
        )
        inv = np.empty_like(order)
        inv[order] = np.arange(len(order))

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)[None]).to(dev)

        fam_s, mol_s, pair_s, n_fam, n_mol, n_over = group_kernel(
            put(dense_pos_ids(batch.pos_key)[order]),
            put(np.asarray(batch.umi)[order]),
            put(np.asarray(batch.strand_ab, bool)[order]),
            put(np.asarray(batch.frag_end, bool)[order]),
            put(valid_arr[order]),
            strategy=p.strategy,
            max_hamming=p.max_hamming,
            count_ratio=p.effective_count_ratio,
            paired=p.paired,
            mate_aware=p.mate_aware,
            u_max=u_max,
            presorted=True,
        )
        n_over = int(n_over[0])
        if n_over:
            import warnings

            warnings.warn(
                f"UmiGrouper: {n_over} reads overflowed the unique-UMI "
                f"table (u_max={self.u_max}); size buckets larger or raise u_max"
            )
        return FamilyAssignment(
            family_id=fam_s[0].cpu().numpy()[inv],
            molecule_id=mol_s[0].cpu().numpy()[inv],
            pair_id=pair_s[0].cpu().numpy()[inv],
            n_families=np.int32(n_fam[0].item()),
            n_molecules=np.int32(n_mol[0].item()),
        )
