"""NumPy oracle for UMI-family grouping (exact + directional adjacency).

This is the semantic reference the TPU kernels are tested against. The
directional adjacency algorithm is the UMI-tools network method
implemented literally: process unique UMIs in descending-count order,
BFS over directed edges ``u -> v`` present iff ``hamming(u, v) <=
max_hamming`` and ``count[u] >= count_ratio*count[v] - 1``, removing
visited nodes. (The TPU kernel computes the provably-equivalent
min-rank-reachability via label propagation; see
kernels/cluster.py for the equivalence argument.)

Determinism: unique UMIs are ranked by (-count, packed_umi); dense
family/molecule ids are assigned in sorted (pos_key, seed_umi[, strand])
order so oracle and kernel agree bit-for-bit.
"""

from __future__ import annotations

from collections import deque

import numpy as np

from duplexumiconsensusreads_torch.constants import NO_FAMILY
from duplexumiconsensusreads_torch.types import FamilyAssignment, GroupingParams, ReadBatch
from duplexumiconsensusreads_torch.utils.phred import pack_umi_words64


def directional_seeds(
    umis: np.ndarray, counts: np.ndarray, max_hamming: int, count_ratio: int
) -> np.ndarray:
    """Cluster unique UMIs (nU, U) with counts (nU,) -> seed index per UMI.

    Returns, for each unique UMI, the index (into ``umis``) of its
    cluster seed (the highest-count UMI of its cluster). Also used by
    the bucketing layer to host-precluster oversized position groups
    (bucketing/buckets.py), so the edge computation is blocked: peak
    memory is O(nU * block * U) instead of O(nU**2 * U).
    """
    n = len(umis)
    words = pack_umi_words64(umis)  # any UMI length
    # rank 0 = highest count, ties by UMI lexicographic order
    order = np.lexsort(
        (*[words[:, i] for i in range(words.shape[1] - 1, -1, -1)], -counts)
    )
    # adjacency: ham[u, v] and counts[u] >= ratio*counts[v] - 1 (directed u->v)
    edge = np.empty((n, n), bool)
    block = max(1, (64 << 20) // max(n * umis.shape[1], 1))
    for s in range(0, n, block):
        e = min(s + block, n)
        ham = (umis[s:e, None, :] != umis[None, :, :]).sum(axis=2)
        edge[s:e] = (ham <= max_hamming) & (
            counts[s:e, None] >= count_ratio * counts[None, :] - 1
        )
    np.fill_diagonal(edge, False)

    seed_of = np.full(n, -1, np.int64)
    for u in order:
        if seed_of[u] >= 0:
            continue
        seed_of[u] = u
        q = deque([u])
        while q:
            a = q.popleft()
            for b in np.nonzero(edge[a])[0]:
                if seed_of[b] < 0:
                    seed_of[b] = u
                    q.append(b)
    return seed_of


def group_reads(batch: ReadBatch, params: GroupingParams) -> FamilyAssignment:
    """Assign family/molecule ids to every valid read in the batch.

    Molecule identity is (pos_key, clustered-UMI); in paired (duplex)
    mode a molecule has up to two single-strand families distinguished
    by strand_ab, ordered AB-before-BA in the dense family numbering.
    In unpaired mode family == molecule and strand is ignored.

    Mate-aware mode (params.mate_aware) additionally splits families by
    the fragment-end bit — a template's R1 and R2 mates cover opposite
    fragment ends, so their cycles must never share a consensus column.
    The reported molecule_id then becomes the dense (molecule,
    frag_end) unit (each unit is one duplex output: its AB family holds
    one mate's top-strand reads, its BA family the OTHER mate's
    bottom-strand reads — the fgbio cross-mate pairing), and pair_id
    keeps the true molecule for R1/R2 mate linking at emission.
    """
    n = batch.n_reads
    valid = np.asarray(batch.valid, bool)
    pos = np.asarray(batch.pos_key, np.int64)
    umi = np.asarray(batch.umi, np.uint8)
    strand = np.asarray(batch.strand_ab, bool)
    e2 = np.asarray(batch.frag_end, bool)

    # Resolved per-read cluster UMI (packed words — any UMI length)
    # after exact/adjacency grouping.
    n_words = pack_umi_words64(umi[:1]).shape[1] if n else 1
    cluster_umi = np.full((n, n_words), -1, np.int64)
    idx_valid = np.nonzero(valid)[0]
    if params.strategy == "exact":
        cluster_umi[idx_valid] = pack_umi_words64(umi[idx_valid])
    elif params.strategy in ("adjacency", "cluster"):
        # "cluster" (UMI-tools cluster method) is adjacency with the
        # count condition removed: effective_count_ratio 0 makes every
        # Hamming-<=h edge bidirectional, so the BFS labels whole
        # connected components by their highest-count member
        for p in np.unique(pos[idx_valid]):
            sel = idx_valid[pos[idx_valid] == p]
            uu, inv, cnt = np.unique(
                umi[sel], axis=0, return_inverse=True, return_counts=True
            )
            seed_of = directional_seeds(
                uu, cnt, params.max_hamming, params.effective_count_ratio
            )
            cluster_umi[sel] = pack_umi_words64(uu)[seed_of][inv]
    else:
        raise ValueError(f"unknown grouping strategy {params.strategy!r}")

    # Dense molecule ids over (pos_key, cluster_umi), sorted.
    mol_key = np.column_stack([pos, cluster_umi])
    molecule_id = np.full(n, NO_FAMILY, np.int32)
    pair_id = np.full(n, NO_FAMILY, np.int32)
    fam_id = np.full(n, NO_FAMILY, np.int32)
    if len(idx_valid):
        _, mol_inv = np.unique(mol_key[idx_valid], axis=0, return_inverse=True)
        pair_id[idx_valid] = mol_inv.astype(np.int32)
        bits = []
        if params.mate_aware:
            bits.append(e2[idx_valid].astype(np.int64))
        if params.paired:
            bits.append((~strand[idx_valid]).astype(np.int64))
        if bits:
            fam_key = np.stack([mol_inv, *bits], axis=1)
            _, fam_inv = np.unique(fam_key, axis=0, return_inverse=True)
            fam_id[idx_valid] = fam_inv.astype(np.int32)
        else:
            fam_id[idx_valid] = mol_inv.astype(np.int32)
        if params.mate_aware and params.paired:
            unit_key = np.stack([mol_inv, e2[idx_valid].astype(np.int64)], axis=1)
            _, unit_inv = np.unique(unit_key, axis=0, return_inverse=True)
            molecule_id[idx_valid] = unit_inv.astype(np.int32)
        else:
            molecule_id[idx_valid] = mol_inv.astype(np.int32)

    n_mol = int(molecule_id.max() + 1) if len(idx_valid) else 0
    n_fam = int(fam_id.max() + 1) if len(idx_valid) else 0
    return FamilyAssignment(
        family_id=fam_id,
        molecule_id=molecule_id,
        pair_id=pair_id,
        n_families=np.int32(n_fam),
        n_molecules=np.int32(n_mol),
    )
