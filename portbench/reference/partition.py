"""Which reads the program puts together: the streaming executor's chunk
rule and the bucketing rule, worked out again from the reads.

Both are copies of the rules the port documents (the chunk rule of
``runtime/stream.py:_resolve_chunk_boundary`` and the greedy bucket fill
of ``bucketing/buckets.py``), so that the error model, which is fitted
per bucket, can be fitted here on the same reads. A read is named by
its index in file order throughout.
"""

from __future__ import annotations

import numpy as np


def umi_words(umi: np.ndarray) -> np.ndarray:
    """(N, W) big-endian int64 words of up to 31 two-bit codes each:
    comparing them in order compares the code strings."""
    n, u = umi.shape
    w = max(-(-u // 31), 1)
    padded = np.zeros((n, w * 31), np.int64)
    padded[:, :u] = umi
    shifts = np.arange(31, dtype=np.int64)[::-1] * 2
    return (padded.reshape(n, w, 31) << shifts).sum(axis=-1)


def chunk_bounds(pos: np.ndarray, chunk_reads: int) -> list[tuple[int, int]]:
    """[(a, b)] read ranges of the streaming executor's chunks: it reads
    ``chunk_reads`` records at a time and holds back the last position
    group of what it holds, and the held-back group ends the file as a
    chunk of its own; a buffer that is one position group keeps
    growing. ``chunk_reads`` 0: the whole file."""
    n = len(pos)
    if chunk_reads <= 0:
        return [(0, n)] if n else []
    out, start, raw_end = [], 0, 0
    while raw_end < n:
        raw_end = min(raw_end + chunk_reads, n)
        cut = int(np.searchsorted(pos, pos[raw_end - 1], side="left"))
        if cut > start:
            out.append((start, cut))
            start = cut
    if start < n:
        out.append((start, n))
    return out


def _pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def bucket_sets(pos: np.ndarray, umi: np.ndarray, a: int, b: int, capacity: int,
                adjacency: bool) -> list[tuple[np.ndarray, int]]:
    """[(read indices, capacity)] of the buckets of the chunk [a, b):
    reads sorted by (position, UMI) (stable), whole position groups
    packed greedily up to ``capacity`` reads; a position group larger
    than that is split at family (exact UMI) boundaries, whole families
    packed greedily, and a family larger than the capacity gets a bucket
    of its own of the next power of two. Plain buckets come first, the
    split groups' after, as the program lists them."""
    words = umi_words(umi[a:b])
    p = pos[a:b]
    order = np.lexsort((*[words[:, i] for i in range(words.shape[1] - 1, -1, -1)], p))
    idx, p, words = order + a, p[order], words[order]
    n = len(idx)
    new_pos = np.r_[True, p[1:] != p[:-1]]
    pos_start = np.nonzero(new_pos)[0]
    fam_start = np.nonzero(new_pos | np.r_[True, (words[1:] != words[:-1]).any(axis=1)])[0]
    plain, special = [], []
    cur_start = cur_end = 0
    bounds = np.r_[pos_start, n]
    for gi in range(len(pos_start)):
        s, e = int(bounds[gi]), int(bounds[gi + 1])
        if e - s > capacity:
            if cur_end > cur_start:
                plain.append((idx[cur_start:cur_end], capacity))
            if adjacency:
                raise NotImplementedError(
                    "a position group larger than the bucket capacity under adjacency "
                    "grouping (the program preclusters it on the host)")
            fb = fam_start[(fam_start >= s) & (fam_start < e)]
            fb = np.r_[fb, e]
            run_s, run_n = s, 0
            for fi in range(len(fb) - 1):
                fs, fe = int(fb[fi]), int(fb[fi + 1])
                if fe - fs > capacity:
                    if run_n:
                        special.append((idx[run_s:fs], capacity))
                    special.append((idx[fs:fe], _pow2(fe - fs)))
                    run_s, run_n = fe, 0
                    continue
                if run_n + (fe - fs) > capacity:
                    special.append((idx[run_s:fs], capacity))
                    run_s, run_n = fs, 0
                run_n += fe - fs
            if run_n:
                special.append((idx[run_s:e], capacity))
            cur_start = cur_end = e
            continue
        if (cur_end - cur_start) + (e - s) > capacity:
            plain.append((idx[cur_start:cur_end], capacity))
            cur_start = s
        cur_end = e
    if cur_end > cur_start:
        plain.append((idx[cur_start:cur_end], capacity))
    return plain + special


def all_buckets(pos: np.ndarray, umi: np.ndarray, chunk_reads: int, capacity: int,
                adjacency: bool, max_chunks: int = 0) -> list[tuple[np.ndarray, int]]:
    """Every bucket of a run, chunk after chunk (of the first
    ``max_chunks`` chunks, when that is not 0)."""
    out = []
    bounds = chunk_bounds(pos, chunk_reads)
    for a, b in bounds[:max_chunks] if max_chunks else bounds:
        out += bucket_sets(pos, umi, a, b, capacity, adjacency)
    return out
