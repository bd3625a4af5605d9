"""Grouping's directional-cluster fixpoint in the torch port against the
JAX package.

``kernels/cluster_fixpoint.py`` splits the min-ancestor propagation off
``_directional_cluster``: on CUDA a hand-written kernel sweeps each
bucket to its fixpoint in place, in ascending slot order within a
thread's run, scanning only each slot's position-group range; on the
CPU ``propagate_min_plain`` runs the batched Jacobi loop. Held here:

- the plain version, through the port's ``group_kernel``, against the
  JAX ``group_kernel`` (adjacency and cluster) on numpy-seeded buckets:
  every id and count bit-identical;
- a numpy model of the kernel's own schedule (in place, ascending slot,
  only each slot's position-group range) against the JAX
  ``_directional_cluster`` while loop, on hypothesis-made graphs that
  include chains of length U-1 in both slot orders, empty edge sets,
  all-invalid buckets and dense groups: the premise that the sweep
  order cannot change the seeds;
- the wrapper's dispatch: the CPU takes the plain version without a
  launch, another device raises.

The kernel itself is held against the plain version on the card in
test_torch_cuda.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from duplexumiconsensusreads_tpu.bucketing import build_buckets, stack_buckets
from duplexumiconsensusreads_tpu.kernels.grouping import _directional_cluster as jax_cluster
from duplexumiconsensusreads_tpu.kernels.grouping import group_kernel as jax_group
from duplexumiconsensusreads_tpu.simulate import SimConfig, simulate_batch
from duplexumiconsensusreads_tpu.types import GroupingParams
from duplexumiconsensusreads_torch.kernels import cluster_fixpoint as cf
from duplexumiconsensusreads_torch.kernels import grouping
from duplexumiconsensusreads_torch.kernels.encoding import pack_umi_words

I32_MAX = 2**31 - 1
KEYS = ("family_id", "molecule_id", "pair_id", "n_families", "n_molecules", "n_overflow")
GRAPH_KINDS = ("random", "chain_up", "chain_down", "empty", "all_invalid", "dense")

_jax_cluster = jax.jit(jax_cluster, static_argnums=(5, 6))


# ---------------------------------------------------------------- group_kernel


@pytest.mark.parametrize("strategy", ["adjacency", "cluster"])
@pytest.mark.parametrize("paired", [False, True])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_plain_fixpoint_through_group_kernel_matches_jax(strategy, paired, seed):
    batch, _ = simulate_batch(SimConfig(
        n_molecules=80, read_len=20, n_positions=6, umi_error=0.05,
        duplex=paired, seed=seed,
    ))
    gp = GroupingParams(strategy=strategy, paired=paired)
    buckets = [b for b in build_buckets(batch, capacity=128, grouping=gp)
               if b.capacity == 128 and not b.preclustered]
    assert buckets
    st_ = stack_buckets(buckets)
    kw = dict(strategy=strategy, max_hamming=gp.max_hamming,
              count_ratio=gp.effective_count_ratio, paired=paired, u_max=128,
              presorted=True)
    args = [st_[k] for k in ("pos", "umi", "strand_ab", "frag_end", "valid")]
    want = jax.vmap(lambda *a: jax_group(*a, **kw))(*args)
    before = cf.propagate_min.launches
    got = grouping.group_kernel(*(torch.from_numpy(np.ascontiguousarray(a)) for a in args), **kw)
    assert cf.propagate_min.launches == before
    for key, w, g in zip(KEYS, want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=key)
    # umi_error 0.05 at 6 positions: directional merges happened
    assert (np.asarray(want[4]) < np.asarray([b.n_unique_umi for b in buckets])).any()


# ------------------------------------------------- the kernel's schedule, modelled


def kernel_model(edge: np.ndarray, s0: np.ndarray, u_pos: np.ndarray):
    """The kernel's sweeps in numpy: per bucket, in place, slots in
    ascending order, each valid slot scanning only the slot range of its
    position group (the whole table when u_pos is not sorted), invalid
    slots (position I32_MAX) nothing, at most U sweeps, stopping at the
    first sweep that changes nothing. Returns (keys, sweeps per
    bucket)."""
    s = s0.copy()
    n, u = s0.shape
    sweeps = []
    for b in range(n):
        pos = u_pos[b]
        if (pos[:-1] <= pos[1:]).all():
            lo = np.searchsorted(pos, pos, side="left")
            hi = np.searchsorted(pos, pos, side="right")
        else:
            lo, hi = np.zeros(u, int), np.full(u, u)
        k = 0
        for k in range(1, u + 1):
            changed = False
            for j in range(u):
                if pos[j] == I32_MAX:
                    continue
                ins = s[b, lo[j]:hi[j]][edge[b, lo[j]:hi[j], j]]
                if ins.size and ins.min() < s[b, j]:
                    s[b, j] = ins.min()
                    changed = True
            if not changed:
                break
        sweeps.append(k)
    return s, sweeps


def _chain_umis(n: int) -> np.ndarray:
    """n UMIs of 31 bases forming an induced Hamming-1 path: C^k A^(31-k),
    then G^m C^(31-m), then T^m G^(31-m) (consecutive UMIs differ at one
    base, all others at two or more)."""
    out = []
    for phase, (hi_c, lo_c) in enumerate(((1, 0), (2, 1), (3, 2))):
        for k in range(1 if phase else 0, 32):
            out.append([hi_c] * k + [lo_c] * (31 - k))
    assert n <= len(out)
    return np.asarray(out[:n], np.int32)


def table(kind: str, u: int, rng, count_ratio: int, n_valid: int, n_groups: int):
    """One bucket's unique-UMI table as group_kernel builds it: slots
    sorted by position, unique UMIs within a position, invalid slots at
    the tail with I32_MAX words and positions. Returns (the five slot
    arrays, max_hamming, count_ratio)."""
    max_hamming = 1
    if kind in ("chain_up", "chain_down"):
        b = 31
        n_valid = u
        codes = _chain_umis(u)
        # counts fall along the chain, so with count_ratio 1 each link
        # points from node k to node k + 1 only; ratio 0 links both ways
        count_ratio = min(count_ratio, 1)
        cnt = 2 * (u - np.arange(u)) + 1
        if kind == "chain_down":  # node 0, the seed, at the last slot
            codes, cnt = codes[::-1], cnt[::-1]
        pos = np.zeros(u, np.int32)
    else:
        b = 5
        n_valid = 0 if kind == "all_invalid" else n_valid
        n_groups = max(1, min(n_groups, n_valid))
        # each group's UMIs distinct, drawn from the 32 binary 5-mers
        # (dense Hamming-1 neighbourhoods)
        cuts = np.array([], int)
        if n_valid > 1:
            cuts = np.sort(rng.choice(np.arange(1, n_valid), size=min(n_groups - 1, n_valid - 1),
                                      replace=False))
        sizes = np.diff(np.concatenate([[0], cuts, [n_valid]])).astype(int)
        sizes = np.minimum(sizes, 32)
        n_valid = int(sizes.sum())
        pos = np.repeat(np.arange(len(sizes), dtype=np.int32) * 7, sizes)
        codes = np.concatenate(
            [np.array([[(x >> i) & 1 for i in range(b)] for x in rng.permutation(32)[:g]],
                      np.int32).reshape(g, b) for g in sizes] or [np.zeros((0, b), np.int32)])
        cnt = rng.integers(1, 20, n_valid)
        if kind == "empty":
            max_hamming = 0  # unique UMIs within a position: no edge
        elif kind == "dense":
            max_hamming = b  # every pair within a group passes the distance
    # sort each position group by its packed words, as the table is
    words = pack_umi_words(torch.from_numpy(codes.astype(np.uint8)[None]))[0].numpy()
    if kind not in ("chain_up", "chain_down") and n_valid:
        order = np.lexsort(tuple(words[:, i] for i in range(words.shape[1] - 1, -1, -1)) + (pos,))
        codes, cnt, words, pos = codes[order], cnt[order], words[order], pos[order]
    n_inv = u - n_valid
    u_codes = np.concatenate([codes, np.zeros((n_inv, b), np.int32)])
    u_words = np.concatenate([words, np.full((n_inv, words.shape[1]), I32_MAX, np.int32)])
    u_pos = np.concatenate([pos, np.full(n_inv, I32_MAX, np.int32)]).astype(np.int32)
    u_cnt = np.concatenate([cnt, np.zeros(n_inv, int)]).astype(np.int32)
    u_valid = u_pos != I32_MAX
    return (u_words, u_codes, u_pos, u_cnt, u_valid), max_hamming, count_ratio


@st.composite
def tables(draw, kind):
    u = draw(st.sampled_from([1, 2, 8, 16, 33, 64]))
    return table(kind, u, np.random.default_rng(draw(st.integers(0, 2**32 - 1))),
                 draw(st.sampled_from([0, 1, 2])), draw(st.integers(1, u)),
                 draw(st.integers(1, 4)))


@pytest.mark.parametrize("kind", GRAPH_KINDS)
@settings(max_examples=25, deadline=None,
          suppress_health_check=[HealthCheck.too_slow, HealthCheck.function_scoped_fixture])
@given(data=st.data())
def test_kernel_schedule_model_matches_jax_while_loop(kind, data, monkeypatch):
    check_model_against_jax(kind, *data.draw(tables(kind)), monkeypatch)


@pytest.mark.parametrize("kind", ["chain_up", "chain_down"])
def test_longest_chain_at_u_64(kind, monkeypatch):
    # a directed chain through all 64 slots of one position; downward,
    # the seed sits at the last slot and needs U - 1 ascending sweeps
    check_model_against_jax(kind, *table(kind, 64, None, 1, 64, 1), monkeypatch)


def check_model_against_jax(kind, arrays, max_hamming, count_ratio, monkeypatch):
    u = arrays[0].shape[0]
    seen = {}

    def modelled(edge, s0, u_pos):
        keys, sweeps = kernel_model(edge.numpy(), s0.numpy(), u_pos.numpy())
        plain = cf.propagate_min_plain(edge, s0, u_pos)
        seen.update(edges=int(edge.sum()), sweeps=sweeps[0], plain=plain.numpy())
        return torch.from_numpy(keys)

    monkeypatch.setattr(grouping, "propagate_min", modelled)
    got = grouping._directional_cluster(
        *(torch.from_numpy(np.ascontiguousarray(a)[None]) for a in arrays),
        max_hamming, count_ratio)[0].numpy()
    want = np.asarray(_jax_cluster(*(jnp.asarray(a) for a in arrays), max_hamming, count_ratio))
    np.testing.assert_array_equal(got, want)
    # the model's keys are the Jacobi loop's, bit for bit
    np.testing.assert_array_equal(got, seen["plain"][0] % u)
    assert 1 <= seen["sweeps"] <= max(u, 1)
    if kind in ("empty", "all_invalid"):
        assert seen["edges"] == 0 and seen["sweeps"] == 1
    if kind == "chain_down" and count_ratio == 1 and u > 2:
        # the seed sits at the last slot: the ascending sweep moves it
        # one slot per sweep down a chain of U - 1 links
        assert seen["edges"] == u - 1 and seen["sweeps"] == u
        assert (got == u - 1).all()


def test_model_handles_unsorted_positions_by_the_full_scan():
    # positions out of order (the kernel then scans all U slots): the
    # model still reaches the plain loop's keys
    rng = np.random.default_rng(4)
    u = 12
    u_pos = rng.permutation(np.repeat(np.arange(3, dtype=np.int32), 4))[None]
    edge = (rng.random((1, u, u)) < 0.3) & (u_pos[:, :, None] == u_pos[:, None, :])
    edge &= ~np.eye(u, dtype=bool)
    s0 = (rng.permutation(u) * u + np.arange(u)).astype(np.int32)[None]
    keys, _ = kernel_model(edge, s0, u_pos)
    want = cf.propagate_min_plain(torch.from_numpy(edge), torch.from_numpy(s0),
                                  torch.from_numpy(u_pos))
    np.testing.assert_array_equal(keys, want.numpy())


# ------------------------------------------------------------------- dispatch


def _small(device="cpu"):
    rng = np.random.default_rng(9)
    u = 16
    u_pos = np.repeat(np.arange(4, dtype=np.int32), 4)[None]
    edge = (rng.random((1, u, u)) < 0.4) & (u_pos[:, :, None] == u_pos[:, None, :])
    s0 = (rng.permutation(u) * u + np.arange(u)).astype(np.int32)[None]
    return tuple(torch.from_numpy(a).to(device) for a in (edge, s0, u_pos))


def test_cpu_tensor_takes_plain_version_without_launch():
    edge, s0, u_pos = _small()
    before = cf.propagate_min.launches
    got = cf.propagate_min(edge, s0, u_pos)
    assert cf.propagate_min.launches == before
    assert got.dtype == torch.int32
    assert torch.equal(got, cf.propagate_min_plain(edge, s0, u_pos))
    # keys only fall, each to a key of its position group
    assert (got <= s0).all()


def test_other_device_raises():
    edge, s0, u_pos = _small("meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        cf.propagate_min(edge, s0, u_pos)


@pytest.mark.parametrize(
    "change, err",
    [
        (lambda e, s, p: (e.to(torch.uint8), s, p), TypeError),
        (lambda e, s, p: (e, s.long(), p), TypeError),
        (lambda e, s, p: (e, s, p.long()), TypeError),
        (lambda e, s, p: (e[:, :-1], s, p), ValueError),
        (lambda e, s, p: (e, s, p[:, :-1]), ValueError),
        (lambda e, s, p: (e[0], s[0], p[0]), ValueError),
    ],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(change, err):
    with pytest.raises(err):
        cf.propagate_min(*change(*_small()))


def test_shared_memory_plan():
    # the default list fits beside the slot arrays at every u_max the
    # kernel takes, and is full length at the main path's 1024-2048
    for u in (1, 128, 1024, 2048, 4096, cf.MAX_U):
        cap = cf.default_list_cap(u)
        assert cap >= 0 and cf.smem_bytes(u, cap) <= cf.SMEM_LIMIT
    assert cf.default_list_cap(2048) == cf.LIST_CAP
    # past what shared memory holds, the slot arrays alone leave no list
    assert cf.default_list_cap(19_300) == 0
