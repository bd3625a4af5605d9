"""UMI grouping, plainly: exact UMIs, or UMI-tools' directional
adjacency (Smith et al., Genome Research 2017) within each position.

Directional adjacency: unique UMIs of a position are visited in order of
falling count (ties by the UMI's codes); each one not yet claimed seeds
a cluster and claims, breadth first, every UMI reachable over directed
edges u -> v, present where the two differ at ``max_hamming`` codes or
fewer and ``count(u) >= count_ratio * count(v) - 1``. A read's molecule
is its position and its cluster's seed UMI.
"""

from __future__ import annotations

from collections import deque

import numpy as np

from portbench.reference.partition import umi_words


def directional_seeds(umis: np.ndarray, counts: np.ndarray, max_hamming: int,
                      count_ratio: int) -> tuple[np.ndarray, int]:
    """(seed index per unique UMI, directed edge count) of one position's
    unique UMIs (nU, U) with their read counts (nU,)."""
    n = len(umis)
    words = umi_words(umis)
    order = np.lexsort((*[words[:, i] for i in range(words.shape[1] - 1, -1, -1)], -counts))
    ham = (umis[:, None, :] != umis[None, :, :]).sum(axis=2)
    edge = (ham <= max_hamming) & (counts[:, None] >= count_ratio * counts[None, :] - 1)
    np.fill_diagonal(edge, False)
    seed = np.full(n, -1, np.int64)
    for u in order:
        if seed[u] >= 0:
            continue
        seed[u] = u
        q = deque([u])
        while q:
            a = q.popleft()
            for b in np.nonzero(edge[a])[0]:
                if seed[b] < 0:
                    seed[b] = u
                    q.append(b)
    return seed, int(edge.sum())


def group_bucket(pos: np.ndarray, umi: np.ndarray, grouping: dict) -> dict:
    """Molecule ids of one bucket's reads (``pos`` (R,), ``umi`` (R, U),
    in any order): dense in (position, seed UMI) order. Also the counts
    the cluster kernel's bound needs: unique UMIs, the pairs of them
    within a position, the pairs of molecules within a position and the
    directed edges."""
    words = umi_words(umi)
    key = np.column_stack([pos, words])
    uniq, inv, cnt = np.unique(key, axis=0, return_inverse=True, return_counts=True)
    inv = inv.reshape(-1)
    seed_of = np.arange(len(uniq))
    stats = {"unique": len(uniq), "pairs": 0, "mol_pairs": 0, "edges": 0}
    gstart = np.nonzero(np.r_[True, uniq[1:, 0] != uniq[:-1, 0]])[0]
    gbounds = np.r_[gstart, len(uniq)]
    first_read = np.zeros(len(uniq), np.int64)
    first_read[inv[::-1]] = np.arange(len(inv))[::-1]
    for s, e in zip(gbounds[:-1], gbounds[1:]):
        n = e - s
        stats["pairs"] += n * (n - 1) // 2
        if grouping["strategy"] == "exact" or n == 1:
            m = n
        else:
            ratio = 0 if grouping["strategy"] == "cluster" else int(grouping["count_ratio"])
            seed, n_edges = directional_seeds(umi[first_read[s:e]], cnt[s:e],
                                              int(grouping["max_hamming"]), ratio)
            seed_of[s:e] = s + seed
            stats["edges"] += n_edges
            m = len(np.unique(seed))
        stats["mol_pairs"] += m * (m - 1) // 2
    mol_key = np.column_stack([uniq[seed_of, 0], uniq[seed_of, 1:]])
    _, mol_of_unique = np.unique(mol_key, axis=0, return_inverse=True)
    return {"molecule": mol_of_unique.reshape(-1)[inv], **stats}
