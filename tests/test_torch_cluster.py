"""Grouping's directional cluster in the torch port against the JAX
package, and a NumPy model of its CUDA kernel's arithmetic.

``kernels/cluster_fixpoint.py:directional_cluster`` maps a dispatch
class's unique-UMI slot table (packed words, positions, read counts) to
each slot's seed, its molecule id and each bucket's molecule count. On a
CPU tensor it runs ``directional_cluster_plain``, which this file holds,
bit for bit, against

- the JAX package's ``_directional_cluster`` (the seeds), and
- the JAX ``group_kernel``'s molecule ids and counts on reads expanded
  from the same table (each slot's read count of copies, presorted),

for u in {8, 64, 512}, max_hamming in {0, 1, 2}, count_ratio in {0, 2}
and the duplex UMI lengths 12 (one word) and 18 (two words), under
``JAX_PLATFORMS=cpu``, with numpy tables made from a seed.

The kernel (csrc/cluster_fixpoint.cu, ``directional_cluster_i32``) runs
only on the card; ``kernel_model`` below is its schedule in NumPy: the
group ranges from one scan of the group starts, a warp per target slot
over its range as 32-lane ballots (the rank and the in-degree as
popcounts; the edge test on the 2-bit packed words, ``popc((x | x >> 1)
& 0x15555555)`` with x = a ^ b), the edge masks kept where the scratch
holds them and the CSR list written from them in ascending order, the
fixpoint over the list (or over the masks or the edge test when the list
does not fit), and the molecule id as the prefix of first keys up to the
range's start plus ballots over the range, with the full scan over all
slots when positions are not sorted. It is held against the plain
version, and on the kernel's edge cases (groups of 31-33, 64, 65 and
512 slots, an all-empty bucket, the i32 wrap of the count threshold, W 2
and 3, unsorted positions) against JAX too, through ``group_kernel``
with the model in the kernel's place; the kernel itself is held against
the plain version on the card in test_torch_cuda.py and chip_smoke.py.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import cluster_case
from duplexumiconsensusreads_tpu.kernels.grouping import _directional_cluster as jax_cluster
from duplexumiconsensusreads_tpu.kernels.grouping import group_kernel as jax_group
from duplexumiconsensusreads_torch.kernels import cluster_fixpoint as cf
from duplexumiconsensusreads_torch.kernels import grouping
from duplexumiconsensusreads_torch.kernels.encoding import pack_umi_words

I32_MAX = 2**31 - 1
N_BUCKETS = 2

_jax_cluster = jax.jit(jax.vmap(jax_cluster, in_axes=(0, 0, 0, 0, 0, None, None)),
                       static_argnums=(5, 6))


def make_tables(u: int, umi_len: int, seed: int, shuffle: bool = False):
    """N_BUCKETS unique-UMI tables of u slots as group_kernel builds them
    (chip_smoke.cluster_case, the card's smoke run's generator): codes,
    packed words, positions and counts, sorted by (pos, words), or with
    ``shuffle`` every slot permuted."""
    return cluster_case("unsorted" if shuffle else "groups", N_BUCKETS, u, umi_len,
                        np.random.default_rng(seed))


def plain(words, pos, cnt, umi_len, max_hamming, count_ratio):
    out = cf.directional_cluster_plain(torch.from_numpy(words), torch.from_numpy(pos),
                                       torch.from_numpy(cnt), umi_len, max_hamming, count_ratio)
    return tuple(a.numpy() for a in out)


CASES = [(u, umi_len, h, r) for u in (8, 64, 512) for umi_len in (12, 18)
         for h in (0, 1, 2) for r in (0, 2)]


# ------------------------------------------------------ the plain version vs JAX


@pytest.mark.parametrize("u, umi_len, max_hamming, count_ratio", CASES)
def test_plain_seeds_match_jax_directional_cluster(u, umi_len, max_hamming, count_ratio):
    codes, words, pos, cnt = make_tables(u, umi_len, seed=u + umi_len)
    seed, _, _ = plain(words, pos, cnt, umi_len, max_hamming, count_ratio)
    want = np.asarray(_jax_cluster(jnp.asarray(words), jnp.asarray(codes), jnp.asarray(pos),
                                   jnp.asarray(cnt), jnp.asarray(pos != I32_MAX),
                                   max_hamming, count_ratio))
    np.testing.assert_array_equal(seed, want)
    if max_hamming == 0:  # unique UMIs within a position: every slot seeds itself
        np.testing.assert_array_equal(seed, np.broadcast_to(np.arange(u), seed.shape))


def _reads(codes, pos, cnt, r):
    """The table's reads: cnt copies of each valid slot, in slot order
    (bucketing's presorted contract), padded to r with invalid reads;
    and each read's slot."""
    slot = np.repeat(np.arange(len(pos)), np.where(pos != I32_MAX, cnt, 0))
    n = len(slot)
    assert n <= r
    valid = np.zeros(r, bool)
    valid[:n] = True
    p = np.zeros(r, np.int32)
    p[:n] = pos[slot]
    umi = np.zeros((r, codes.shape[1]), np.uint8)
    umi[:n] = codes[slot]
    return p, umi, valid, np.concatenate([slot, np.full(r - n, -1)])


@pytest.mark.parametrize("u, umi_len, max_hamming, count_ratio", CASES)
def test_plain_ids_match_jax_group_kernel(u, umi_len, max_hamming, count_ratio):
    codes, words, pos, cnt = make_tables(u, umi_len, seed=7 * u + umi_len)
    _, mid, n_mol = plain(words, pos, cnt, umi_len, max_hamming, count_ratio)
    r = int(cnt.sum(axis=1).max())
    r = 1 << (r - 1).bit_length()
    kw = dict(strategy="adjacency", max_hamming=max_hamming, count_ratio=count_ratio,
              u_max=u, presorted=True)
    stacked = [_reads(codes[b], pos[b], cnt[b], r) for b in range(N_BUCKETS)]
    p, umi, valid, slot = (np.stack(a) for a in zip(*stacked))
    flags = np.zeros_like(valid)
    want = jax.vmap(lambda *a: jax_group(*a, **kw))(
        jnp.asarray(p), jnp.asarray(umi), jnp.asarray(flags), jnp.asarray(flags),
        jnp.asarray(valid))
    ours = grouping.group_kernel(*(torch.from_numpy(a) for a in (p, umi, flags, flags, valid)),
                                 **kw)
    for w_, o_ in zip(want, ours):
        np.testing.assert_array_equal(np.asarray(w_), o_.numpy())
    # the plain version's slot ids are the reads' molecule ids
    mol = np.asarray(want[1])
    got = np.where(valid, np.take_along_axis(mid, np.maximum(slot, 0), axis=1), mol)
    np.testing.assert_array_equal(got, mol)
    np.testing.assert_array_equal(n_mol, np.asarray(want[4]))
    assert (n_mol > 0).all()


# ----------------------------------------------------- the kernel's arithmetic


def packed_hamming(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Codes that differ between packed word rows: x = a ^ b, then
    popc((x | x >> 1) & 0x15555555) summed over the words."""
    x = (a ^ b).astype(np.uint32)
    m = (x | (x >> 1)) & np.uint32(0x15555555)
    bits = sum((m >> np.uint32(k)) & np.uint32(1) for k in range(32))
    return bits.astype(np.int64).sum(axis=-1)


def popc(x: int) -> int:
    return bin(x).count("1")


def ballots(bits: np.ndarray) -> list[int]:
    """A warp's ballots over one target's candidates, 32 a step: bit k
    of step m set where bits[32 m + k]."""
    return [sum(1 << int(k) for k in np.flatnonzero(bits[base:base + 32]))
            for base in range(0, len(bits), 32)]


def less_words(a, b):
    """Rows of words (k, W) against one row (W,): lexicographic a < b,
    and a == b."""
    lt = np.zeros(len(a), bool)
    eq = np.ones(len(a), bool)
    for k in range(a.shape[1]):
        lt |= eq & (a[:, k] < b[k])
        eq &= a[:, k] == b[k]
    return lt, eq


def group_ranges(pos):
    """Each slot's [lo, hi) as the kernel's scan gives it: the last
    group start up to the slot (a running max) and the first start after
    it (a running min from the right), when the positions are sorted;
    [0, U) for every slot when not; empty for an empty slot."""
    u = len(pos)
    idx = np.arange(u)
    start = np.ones(u, bool)
    start[1:] = pos[1:] != pos[:-1]
    lo = np.maximum.accumulate(np.where(start, idx, -1))
    hi = np.append(np.minimum.accumulate(np.where(start, idx, u)[::-1])[::-1][1:], u)
    grouped = bool(np.all(pos[:-1] <= pos[1:]))
    if not grouped:
        lo, hi = np.zeros(u, int), np.full(u, u)
    empty = pos == I32_MAX
    return grouped, np.where(empty, 0, lo), np.where(empty, 0, hi)


def kernel_model(words, pos, cnt, max_hamming, count_ratio, scratch=None):
    """One bucket through the kernel's schedule (csrc/cluster_fixpoint.cu):
    (seed, mid, n_mol, what the fixpoint ran on). Group ranges from one
    scan; a warp per target slot over its range, 32 candidates a step,
    the rank and in-degree as popcounts of ballots and the edge ballots
    kept as masks where ``scratch`` (bytes; the plan's by default) holds
    U x ceil(largest group / 32) words; the CSR list written from the
    masks (or from a second edge test) at off[j] + popc(mask & lanes
    below), ascending; Gauss-Seidel sweeps over the list (or, when it
    does not fit, over the masks or the edge test), in ascending slot
    order; then, where the table is strictly sorted by (pos, words), each
    id as the count of self-seeded valid slots below the slot's seed,
    else first keys by an any over the earlier slots of the range and
    ids as P[lo] + popcounts over the range."""
    u, w = words.shape
    grouped, lo, hi = group_ranges(pos)
    if scratch is None:
        scratch = cf.cluster_plan(u, w)[1]
    mask_words = -(-int((hi - lo).max(initial=0)) // 32)
    keep_masks = u * mask_words * 4 <= scratch
    # count_ratio * cnt - 1 in i32, wrapping
    thresh = ((np.int64(count_ratio) * cnt.astype(np.int64) - 1 + 2**31) % 2**32 - 2**31)

    def edge_bits(j):
        i = np.arange(lo[j], hi[j])
        return ((i != j) & (pos[i] == pos[j]) & (cnt[i] >= thresh[j])
                & (packed_hamming(words[i], words[j][None]) <= max_hamming))

    s = u * u + np.arange(u, dtype=np.int64)
    deg = np.zeros(u, np.int64)
    masks = {}
    for j in range(u):
        if lo[j] == hi[j]:
            continue
        i = np.arange(lo[j], hi[j])
        lt, _ = less_words(words[i], words[j])
        lt = (pos[i] != I32_MAX) & ((cnt[i] > cnt[j]) | ((cnt[i] == cnt[j]) & lt))
        masks[j] = ballots(edge_bits(j))
        s[j] = sum(map(popc, ballots(lt))) * u + j
        deg[j] = sum(map(popc, masks[j]))
    off = np.concatenate([[0], np.cumsum(deg)])
    n_edges = int(off[-1])
    mask_bytes = u * mask_words * 4 if keep_masks else 0
    from_masks = keep_masks and 2 * n_edges <= scratch - mask_bytes
    use_list = from_masks or 2 * n_edges <= scratch
    lst = np.full(n_edges, -1)
    if use_list:
        for j in masks:
            at = off[j]
            for k, m in enumerate(masks[j] if from_masks else ballots(edge_bits(j))):
                for lane in range(32):
                    if m >> lane & 1:
                        lst[at + popc(m & ((1 << lane) - 1))] = lo[j] + 32 * k + lane
                at += popc(m)
        assert (lst >= 0).all()
        assert all((np.diff(lst[off[j]:off[j + 1]]) > 0).all() for j in range(u))
    sweeps = 0
    while sweeps < u:
        sweeps += 1
        changed = False
        for j in masks:
            if use_list:
                ins = lst[off[j]:off[j + 1]]
            else:
                bits = (np.array([m >> k & 1 for m in masks[j] for k in range(32)], bool)
                        [:hi[j] - lo[j]] if keep_masks else edge_bits(j))
                ins = lo[j] + np.flatnonzero(bits)
            if len(ins) and s[ins].min() < s[j]:
                s[j], changed = s[ins].min(), True
        if not changed:
            break
    seed = (s % u).astype(np.int32)
    valid = pos != I32_MAX
    same = valid[1:] & (pos[1:] == pos[:-1])
    # words strictly rising within every group
    strict = grouped and all(less_words(words[k:k + 1], words[k + 1])[0][0]
                             for k in np.flatnonzero(same))
    info = {"grouped": grouped, "strict": strict, "keep_masks": keep_masks,
            "from_masks": from_masks, "use_list": use_list, "edges": n_edges,
            "sweeps": sweeps, "mask_words": mask_words}
    if strict:  # the distinct keys are the self-seeded slots, in slot order
        prefix = np.concatenate([[0], np.cumsum(valid & (seed == np.arange(u)))])
        mid = np.where(valid, prefix[seed], I32_MAX).astype(np.int32)
        return seed, mid, np.int32(prefix[-1]), info
    # first keys, their prefix, and each slot's count of smaller first keys
    fv = np.zeros(u, np.int64)
    for j in masks:
        i = np.arange(lo[j], j)
        _, eq = less_words(words[seed[i]], words[seed[j]])
        fv[j] = not ((pos[i] == pos[j]) & eq).any()
    prefix = np.concatenate([[0], np.cumsum(fv)])
    mid = np.full(u, I32_MAX, np.int32)
    for j in masks:
        i = np.arange(lo[j], hi[j])
        lt, _ = less_words(words[seed[i]], words[seed[j]])
        less = (fv[i] == 1) & np.where(pos[i] == pos[j], lt, pos[i] < pos[j])
        mid[j] = prefix[lo[j]] + sum(map(popc, ballots(less)))
    return seed, mid, np.int32(prefix[-1]), info


def test_packed_hamming_equals_code_hamming():
    rng = np.random.default_rng(0)
    for umi_len in (1, 12, 15, 16, 18, 30, 31):
        a = rng.integers(0, 4, (500, umi_len))
        b = np.where(rng.random((500, umi_len)) < 0.2, rng.integers(0, 4, (500, umi_len)), a)
        pa, pb = (pack_umi_words(torch.from_numpy(x.astype(np.uint8))).numpy() for x in (a, b))
        np.testing.assert_array_equal(packed_hamming(pa, pb), (a != b).sum(axis=1))


@pytest.mark.parametrize("shuffle", [False, True], ids=["sorted", "unsorted"])
@pytest.mark.parametrize("u, umi_len, max_hamming, count_ratio",
                         [(8, 12, 1, 2), (64, 18, 2, 0), (64, 12, 1, 2), (128, 18, 1, 2),
                          (128, 12, 2, 2), (64, 18, 0, 2)])
def test_kernel_model_matches_plain(u, umi_len, max_hamming, count_ratio, shuffle):
    _, words, pos, cnt = make_tables(u, umi_len, seed=3 * u + umi_len, shuffle=shuffle)
    want = plain(words, pos, cnt, umi_len, max_hamming, count_ratio)
    for b in range(N_BUCKETS):
        seed, mid, n_mol, _ = kernel_model(words[b], pos[b], cnt[b], max_hamming, count_ratio)
        np.testing.assert_array_equal(seed, want[0][b])
        np.testing.assert_array_equal(mid, want[1][b])
        assert n_mol == want[2][b]


def test_kernel_model_on_one_group_within_hamming_one_and_chains():
    # one position whose UMIs all lie within Hamming 1 of each other
    # (one base varies), and a chain up and down one group
    umi_len = 12
    base = np.zeros(umi_len, np.int32)
    one = np.stack([np.where(np.arange(umi_len) == 5, c, base) for c in range(4)])
    chain = np.stack([np.r_[np.ones(k, np.int32), np.zeros(umi_len - k, np.int32)]
                      for k in range(umi_len + 1)])
    for codes, cnt in ((one, np.array([9, 1, 30, 2])),
                       (chain, 2 * np.arange(umi_len + 1)[::-1] + 1),
                       (chain, 2 * np.arange(umi_len + 1) + 1)):
        words = pack_umi_words(torch.from_numpy(codes.astype(np.uint8))).numpy()
        order = np.argsort(words[:, 0], kind="stable")
        words, cnt = words[order], cnt[order].astype(np.int32)
        pos = np.zeros(len(cnt), np.int32)
        for ratio in (0, 1, 2):
            want = plain(words[None], pos[None], cnt[None], umi_len, 1, ratio)
            got = kernel_model(words, pos, cnt, 1, ratio)
            np.testing.assert_array_equal(got[0], want[0][0])
            np.testing.assert_array_equal(got[1], want[1][0])
            assert got[2] == want[2][0]


# the kernel's edge cases, each a table of N_BUCKETS buckets: (case,
# cluster_case kind, u, UMI length, max_hamming, count_ratio). groupN
# is one position group of exactly N slots (a warp's 32 candidates,
# one short and one past, two steps and one past, and 512); empty is a
# bucket of only empty slots; ratio_wrap has counts near 2^30, so
# count_ratio * cnt - 1 wraps in i32 for some slots and not others;
# reversed_group has each bucket's first group in falling word order
# (positions sorted, words not) and duplicate_keys repeats a slot's
# words beside it, so neither is strictly sorted by (pos, words) and
# their ids take the pair passes
EDGE_CASES = [
    ("group31", "size31", 32, 12, 1, 2), ("group32", "size32", 32, 12, 1, 2),
    ("group33", "size33", 64, 12, 1, 2), ("group64", "size64", 64, 12, 1, 2),
    ("group65", "size65", 128, 12, 1, 2), ("group512", "size512", 512, 12, 1, 2),
    ("empty", "empty", 64, 12, 1, 2), ("ratio_wrap", "groups", 64, 12, 1, 2),
    ("w2", "groups", 128, 18, 2, 2), ("w3", "groups", 128, 36, 2, 2),
    ("unsorted", "unsorted", 128, 12, 1, 2), ("reversed_group", "groups", 128, 12, 1, 2),
    ("duplicate_keys", "groups", 64, 12, 1, 2),
]


def edge_case_table(kind: str, u: int, umi_len: int, seed: int, case: str):
    if kind == "empty":
        codes = np.zeros((N_BUCKETS, u, umi_len), np.uint8)
        words = np.full((N_BUCKETS, u, -(-umi_len // 15)), I32_MAX, np.int32)
        pos = np.full((N_BUCKETS, u), I32_MAX, np.int32)
        return codes, words, pos, np.zeros((N_BUCKETS, u), np.int32)
    codes, words, pos, cnt = cluster_case(kind, N_BUCKETS, u, umi_len,
                                          np.random.default_rng(seed))
    if case == "ratio_wrap":  # 2 * cnt - 1 wraps above 2^30; exactly 2^30 does not
        cnt = np.where(pos != I32_MAX, cnt + 2**30 - 3, 0).astype(np.int32)
    if case == "duplicate_keys":  # each bucket's first group: its first UMI twice
        codes[:, 1], words[:, 1] = codes[:, 0], words[:, 0]
    if case == "reversed_group":
        for b in range(N_BUCKETS):
            g = np.flatnonzero(pos[b] == pos[b, 0])[::-1]
            for a in (codes, words, pos, cnt):
                a[b, :len(g)] = a[b, g]
    return codes, words, pos, cnt


@pytest.mark.parametrize("case, kind, u, umi_len, max_hamming, count_ratio", EDGE_CASES,
                         ids=[c[0] for c in EDGE_CASES])
def test_kernel_model_matches_plain_and_jax_on_edge_cases(case, kind, u, umi_len, max_hamming,
                                                          count_ratio, monkeypatch):
    codes, words, pos, cnt = edge_case_table(kind, u, umi_len, u + umi_len, case)
    if case.startswith("group"):
        assert sorted(np.unique(pos[0][pos[0] != I32_MAX], return_counts=True)[1]) == [
            int(case[5:])]
    want = plain(words, pos, cnt, umi_len, max_hamming, count_ratio)
    for b in range(N_BUCKETS):
        seed, mid, n_mol, info = kernel_model(words[b], pos[b], cnt[b], max_hamming,
                                              count_ratio)
        np.testing.assert_array_equal(seed, want[0][b])
        np.testing.assert_array_equal(mid, want[1][b])
        assert n_mol == want[2][b]
        assert info["grouped"] == (case != "unsorted") and info["use_list"]
        assert info["strict"] == (case not in ("unsorted", "reversed_group", "duplicate_keys"))
    if case == "ratio_wrap":
        assert (cnt == 2**30).any() and (cnt > 2**30).any()
    # the plain seeds are JAX's _directional_cluster's
    jseed = np.asarray(_jax_cluster(jnp.asarray(words), jnp.asarray(codes), jnp.asarray(pos),
                                    jnp.asarray(cnt), jnp.asarray(pos != I32_MAX),
                                    max_hamming, count_ratio))
    np.testing.assert_array_equal(want[0], jseed)
    if case in ("ratio_wrap", "unsorted", "reversed_group", "duplicate_keys"):
        return  # group_kernel builds strictly sorted tables of read counts
    # through group_kernel, with the model in the kernel's place, against
    # JAX's group_kernel on reads expanded from the table
    r = max(16, 1 << (int(cnt.sum(axis=1).max()) - 1).bit_length())
    kw = dict(strategy="adjacency", max_hamming=max_hamming, count_ratio=count_ratio,
              u_max=u, presorted=True)
    stacked = [_reads(codes[b], pos[b], cnt[b], r) for b in range(N_BUCKETS)]
    p, umi, valid, _ = (np.stack(a) for a in zip(*stacked))
    flags = np.zeros_like(valid)
    expected = jax.vmap(lambda *a: jax_group(*a, **kw))(
        jnp.asarray(p), jnp.asarray(umi), jnp.asarray(flags), jnp.asarray(flags),
        jnp.asarray(valid))

    def modelled(u_words, u_pos, u_cnt, _umi_len, h, ratio):
        outs = [kernel_model(*(a[b].numpy() for a in (u_words, u_pos, u_cnt)), h, ratio)
                for b in range(u_words.shape[0])]
        return tuple(torch.from_numpy(np.stack([o[k] for o in outs])) for k in range(3))

    monkeypatch.setattr(grouping, "directional_cluster", modelled)
    ours = grouping.group_kernel(*(torch.from_numpy(a) for a in (p, umi, flags, flags, valid)),
                                 **kw)
    for w_, o_ in zip(expected, ours):
        np.testing.assert_array_equal(np.asarray(w_), o_.numpy())


@pytest.mark.parametrize("mode", ["list_from_masks", "list_tested_again", "dense_over_masks",
                                  "dense_tested_again"])
def test_kernel_model_fixpoint_modes_match_plain(mode):
    # where the scratch holds the masks and the list, the list alone,
    # the masks alone (a dense group: every pair an edge) or neither
    dense = mode.startswith("dense")
    h, ratio = (12, 0) if dense else (1, 2)
    _, words, pos, cnt = cluster_case("dense" if dense else "size64", N_BUCKETS, 64, 12,
                                      np.random.default_rng(17))
    want = plain(words, pos, cnt, 12, h, ratio)
    for b in range(N_BUCKETS):
        info = kernel_model(words[b], pos[b], cnt[b], h, ratio)[3]
        mask_bytes = 64 * info["mask_words"] * 4
        scratch = {"list_from_masks": None, "list_tested_again": 2 * info["edges"],
                   "dense_over_masks": mask_bytes, "dense_tested_again": 0}[mode]
        seed, mid, n_mol, info = kernel_model(words[b], pos[b], cnt[b], h, ratio, scratch)
        np.testing.assert_array_equal(seed, want[0][b])
        np.testing.assert_array_equal(mid, want[1][b])
        assert n_mol == want[2][b]
        assert (info["use_list"], info["keep_masks"], info["from_masks"]) == {
            "list_from_masks": (True, True, True), "list_tested_again": (True, False, False),
            "dense_over_masks": (False, True, False),
            "dense_tested_again": (False, False, False)}[mode]


# ------------------------------------------------------------------- dispatch


def _small(device="cpu"):
    _, words, pos, cnt = make_tables(16, 12, seed=5)
    return tuple(torch.from_numpy(a).to(device) for a in (words, pos, cnt))


def test_cpu_tensor_takes_plain_version_without_launch():
    words, pos, cnt = _small()
    before = cf.directional_cluster.launches
    got = cf.directional_cluster(words, pos, cnt, 12, 1, 2)
    assert cf.directional_cluster.launches == before
    want = cf.directional_cluster_plain(words, pos, cnt, 12, 1, 2)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert [a.dtype for a in got] == [torch.int32] * 3
    assert got[0].shape == got[1].shape == pos.shape and got[2].shape == (pos.shape[0],)


def test_other_device_raises():
    with pytest.raises(ValueError, match="cuda or cpu"):
        cf.directional_cluster(*_small("meta"), 12, 1, 2)


@pytest.mark.parametrize(
    "change, err",
    [
        (lambda w, p, c, *a: (w.long(), p, c, *a), TypeError),
        (lambda w, p, c, *a: (w, p.long(), c, *a), TypeError),
        (lambda w, p, c, *a: (w, p, c.to(torch.int16), *a), TypeError),
        (lambda w, p, c, *a: (w[:, :-1], p, c, *a), ValueError),
        (lambda w, p, c, *a: (w[0], p[0], c[0], *a), ValueError),
        (lambda w, p, c, n, h, r: (w, p, c, 18, h, r), ValueError),  # 18 bases need 2 words
        (lambda w, p, c, n, h, r: (w, p, c, n, 1.5, r), ValueError),
        (lambda w, p, c, n, h, r: (w, p, c, n, h, 2**31), ValueError),
    ],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(change, err):
    with pytest.raises(err):
        cf.directional_cluster(*change(*_small(), 12, 1, 2))


def test_shared_memory_plan():
    # the table sits in shared memory at the main path's u_max, and
    # every u_max the kernel takes fits (the largest reads its table
    # from global memory)
    for w in (1, 2, 3):
        for u in (1, 8, 512, 2048, 4096, 8192, cf.MAX_U):
            in_smem, scratch = cf.cluster_plan(u, w)
            assert scratch >= 0 and cf.cluster_smem_bytes(u, w, in_smem, scratch) <= cf.SMEM_LIMIT
            if in_smem:
                assert scratch >= 2 * cf.MIN_LIST
        assert cf.cluster_plan(2048, w) == (True, 2 * cf.LIST_CAP)
        assert cf.cluster_plan(cf.MAX_U, w)[0] is False
        # the main class's table: a block of a quarter SM, four an SM at
        # 512 threads, 528 buckets in one wave on 132 SMs (>= 280), with
        # room for the masks of groups up to 256 slots and a list beside
        in_smem, scratch = cf.cluster_plan(512, w)
        smem = cf.cluster_smem_bytes(512, w, in_smem, scratch)
        assert in_smem and smem == cf.RESIDENT_SMEM
        per_block = smem + cf.STATIC_SMEM + cf.BLOCK_RESERVED
        assert cf.SM_SMEM // per_block == cf.BLOCKS_PER_SM == 4
        assert cf.BLOCKS_PER_SM * cf.THREADS == 2048 and 132 * cf.BLOCKS_PER_SM >= 280
        assert scratch - 512 * 8 * 4 >= 2 * cf.MIN_LIST


# ------------------------------------------- the per-phase split and its build


def _cluster_phases():
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location(
        "cluster_phases", os.path.join(os.path.dirname(os.path.dirname(__file__)), "scripts",
                                       "cluster_phases.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_cluster_phases_splits_stamp_rows_by_phase():
    # three blocks' stamp rows (csrc/cluster_fixpoint.cu's layout): the
    # phases' cycles, the median and slowest block, sweeps, SMs, modes
    cp = _cluster_phases()
    names = ["a", "b", "c"]
    rows = torch.zeros((3, cf.N_STAMPS), dtype=torch.int64)
    for b, (steps, sm) in enumerate((((10, 20, 30), 0), ((5, 5, 5), 0), ((40, 1, 1), 1))):
        rows[b, :4] = torch.tensor(np.cumsum([100 * b, *steps]))
        rows[b, cp.SWEEPS], rows[b, cp.SMID] = 2 + b, sm
        rows[b, cp.T_START], rows[b, cp.T_END] = 1000 + b, 2000 + 10 * b
        rows[b, cp.MODE], rows[b, cp.EDGES] = 15 if b else 7, 7 * b
    got = cp.phase_split(rows, names)
    assert got["median_block"] == {"bucket": 2, "cycles": {"a": 40, "b": 1, "c": 1},
                                   "span_cycles": 42, "sweeps": 4}
    assert [blk["bucket"] for blk in got["slowest_blocks"]] == [0, 2, 1]
    assert got["slowest_blocks"][0]["cycles"] == {"a": 10, "b": 20, "c": 30}
    assert got["share_of_all_spans"] == pytest.approx({"a": 55 / 117, "b": 26 / 117,
                                                       "c": 36 / 117})
    assert got["sweeps"]["max"] == 4 and got["fixpoint_modes"] == {"7": 1, "15": 2}
    assert got["sms_used"] == 2 and got["blocks_per_sm"]["max"] == 2
    assert got["launch_span_ns"] == 1020 and got["latest_block_start_ns"] == 2


def test_cluster_phases_table_shape_counts_groups_pairs_and_edges():
    cp = _cluster_phases()
    _, words, pos, cnt = make_tables(64, 12, seed=11)
    tab = (torch.from_numpy(words), torch.from_numpy(pos), torch.from_numpy(cnt), 12, 1, 2)
    got = cp.table_shape(*tab)
    sizes = [np.unique(pos[b][pos[b] != I32_MAX], return_counts=True)[1] for b in range(N_BUCKETS)]
    assert got["group_size"]["max"] == max(int(x.max()) for x in sizes)
    assert got["in_group_pairs"] == sum(int((x * (x - 1) // 2).sum()) for x in sizes)
    edge, _ = cf.cluster_edges_plain(*tab)
    assert got["edges"] == int(edge.sum()) > 0
    assert got["valid_slots_per_bucket"]["max"] == int((pos != I32_MAX).sum(axis=1).max())


def test_build_with_defines_is_another_library():
    # the stamped build of the same source is named apart, so both load
    from duplexumiconsensusreads_torch.kernels import build

    plain_lib = build.lib_path("cluster_fixpoint")
    stamped = build.lib_path("cluster_fixpoint", (cf.PHASES_MACRO,))
    assert plain_lib != stamped and os.path.dirname(plain_lib) == os.path.dirname(stamped)
    assert build.lib_path("cluster_fixpoint", (cf.PHASES_MACRO,)) == stamped
    assert f"-D{cf.PHASES_MACRO}" in build._flags((cf.PHASES_MACRO,))
