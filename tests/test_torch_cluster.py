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
only on the card; ``kernel_model`` below is its arithmetic in NumPy: the
edge test on the 2-bit packed words (``popc((x | x >> 1) & 0x15555555)``
with x = a ^ b), ranks over each slot's position-group range, the
fixpoint, and the molecule id as the prefix of first keys up to the
group start plus the in-group count, with the full scan over all slots
when positions are not sorted. It is held against the plain version
here; the kernel itself is held against the plain version on the card
in test_torch_cuda.py and chip_smoke.py.
"""

from __future__ import annotations

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


def kernel_model(words, pos, cnt, max_hamming, count_ratio):
    """One bucket through the kernel's arithmetic: (seed, mid, n_mol)."""
    u = len(pos)
    valid = pos != I32_MAX
    grouped = bool(np.all(pos[:-1] <= pos[1:]))

    def slot_range(j):
        if not valid[j]:
            return 0, 0
        if grouped:
            return (int(np.searchsorted(pos, pos[j], "left")),
                    int(np.searchsorted(pos, pos[j], "right")))
        return 0, u

    def less_words(a, b):  # rows of words (k, W) vs one row (W,): lexicographic a < b
        lt = np.zeros(len(a), bool)
        eq = np.ones(len(a), bool)
        for k in range(words.shape[1]):
            lt |= eq & (a[:, k] < b[k])
            eq &= a[:, k] == b[k]
        return lt, eq

    # ranks by (-count, words) over each slot's range -> start keys
    s = u * u + np.arange(u, dtype=np.int64)
    ranges = [slot_range(j) for j in range(u)]
    for i in np.flatnonzero(valid):
        lo, hi = ranges[i]
        js = np.arange(lo, hi)
        js = js[valid[js]]
        lt, _ = less_words(words[js], words[i])
        rank = int(((cnt[js] > cnt[i]) | ((cnt[js] == cnt[i]) & lt)).sum())
        s[i] = rank * u + i
    # in-edges i -> j over j's range, then Gauss-Seidel sweeps
    thresh = (np.int64(count_ratio) * cnt.astype(np.int64) - 1).astype(np.int32)  # i32 wrap
    ins = []
    for j in range(u):
        lo, hi = ranges[j]
        i = np.arange(lo, hi)
        e = ((i != j) & (pos[i] == pos[j]) & (cnt[i] >= thresh[j])
             & (packed_hamming(words[i], words[j][None]) <= max_hamming))
        ins.append(i[e])
    while True:
        changed = False
        for j in range(u):
            if len(ins[j]):
                m = min(s[j], s[ins[j]].min())
                if m < s[j]:
                    s[j], changed = m, True
        if not changed:
            break
    seed = (s % u).astype(np.int32)
    # first keys, their prefix, and each slot's count of smaller first keys
    fv = np.zeros(u, np.int32)
    for j in np.flatnonzero(valid):
        lo, _ = ranges[j]
        i = np.arange(lo, j)
        _, eq = less_words(words[seed[i]], words[seed[j]])
        fv[j] = not ((pos[i] == pos[j]) & eq).any()
    prefix = np.concatenate([[0], np.cumsum(fv)])
    mid = np.full(u, I32_MAX, np.int32)
    for j in np.flatnonzero(valid):
        lo, hi = ranges[j]
        i = np.arange(lo, hi)
        i = i[fv[i] == 1]
        lt, _ = less_words(words[seed[i]], words[seed[j]])
        same = pos[i] == pos[j]
        if grouped:
            mid[j] = prefix[lo] + int(lt.sum())
        else:
            mid[j] = int((same & lt).sum() + (~same & (pos[i] < pos[j])).sum())
    return seed, mid, np.int32(prefix[-1])


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
        seed, mid, n_mol = kernel_model(words[b], pos[b], cnt[b], max_hamming, count_ratio)
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


# ------------------------------------------------------------------- dispatch


def _small(device="cpu"):
    _, words, pos, cnt = make_tables(16, 12, seed=5)
    return tuple(torch.from_numpy(a).to(device) for a in (words, pos, cnt))


def test_cpu_tensor_takes_plain_version_without_launch():
    words, pos, cnt = _small()
    before = (cf.directional_cluster.launches, cf.propagate_min.launches)
    got = cf.directional_cluster(words, pos, cnt, 12, 1, 2)
    assert (cf.directional_cluster.launches, cf.propagate_min.launches) == before
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
            in_smem, cap = cf.cluster_plan(u, w)
            assert cap >= 0 and cf.cluster_smem_bytes(u, w, in_smem, cap) <= cf.SMEM_LIMIT
            if in_smem:
                assert cap >= cf.MIN_LIST
        assert cf.cluster_plan(2048, w) == (True, cf.LIST_CAP)
        assert cf.cluster_plan(cf.MAX_U, w)[0] is False
