"""The torch port's grouping kernel against the JAX package's.

Same stacked buckets (numpy, from the repo's simulator + bucketing) go
through the JAX ``group_kernel`` (vmapped over the bucket axis) and the
port's batched ``group_kernel``: every id and count must be
bit-identical, for exact/adjacency/cluster grouping, paired and not,
mate-aware and not.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from duplexumiconsensusreads_tpu.bucketing import build_buckets, stack_buckets
from duplexumiconsensusreads_tpu.kernels.encoding import pack_2bit as jax_pack_2bit
from duplexumiconsensusreads_tpu.kernels.encoding import pack_umi_words as jax_pack
from duplexumiconsensusreads_tpu.kernels.grouping import group_kernel as jax_group
from duplexumiconsensusreads_tpu.simulate import SimConfig, simulate_batch
from duplexumiconsensusreads_tpu.types import GroupingParams
from duplexumiconsensusreads_torch.kernels.encoding import pack_2bit, pack_umi_words
from duplexumiconsensusreads_torch.kernels.grouping import group_kernel

KEYS = ("family_id", "molecule_id", "pair_id", "n_families", "n_molecules", "n_overflow")


def _stacked(strategy, paired, mate_aware, seed=7):
    batch, _ = simulate_batch(
        SimConfig(
            n_molecules=90, read_len=24, n_positions=15, umi_error=0.03,
            duplex=paired, paired_reads=mate_aware, seed=seed,
        )
    )
    gp = GroupingParams(strategy=strategy, paired=paired, mate_aware=mate_aware)
    buckets = [
        b for b in build_buckets(batch, capacity=128, grouping=gp)
        if b.capacity == 128 and not b.preclustered
    ]
    assert len(buckets) >= 2
    return stack_buckets(buckets), gp


def _u_max(stacked):
    n_u = []
    for b in range(stacked["pos"].shape[0]):
        v = stacked["valid"][b]
        key = np.column_stack([stacked["pos"][b][v], stacked["umi"][b][v]])
        n_u.append(len(np.unique(key, axis=0)))
    return 1 << (max(n_u) - 1).bit_length()


@pytest.mark.parametrize("strategy", ["exact", "adjacency", "cluster"])
@pytest.mark.parametrize("paired", [False, True])
@pytest.mark.parametrize("mate_aware", [False, True])
def test_group_kernel_bit_identical(strategy, paired, mate_aware):
    st, gp = _stacked(strategy, paired, mate_aware)
    u_max = _u_max(st)
    kw = dict(
        strategy=strategy, max_hamming=gp.max_hamming,
        count_ratio=gp.effective_count_ratio, paired=paired,
        mate_aware=mate_aware, u_max=u_max, presorted=True,
    )
    args = [st[k] for k in ("pos", "umi", "strand_ab", "frag_end", "valid")]
    want = jax.vmap(lambda *a: jax_group(*a, **kw))(*args)
    got = group_kernel(*(torch.from_numpy(np.ascontiguousarray(a)) for a in args), **kw)
    for key, w, g in zip(KEYS, want, got):
        g = g.numpy()
        w = np.asarray(w)
        assert g.dtype == np.int32, key
        np.testing.assert_array_equal(g, w, err_msg=key)
    assert int(np.asarray(want[3]).sum()) > 0


def test_undersized_table_overflows_like_jax():
    st, gp = _stacked("adjacency", True, False, seed=3)
    kw = dict(strategy="adjacency", paired=True, u_max=8, presorted=True)
    args = [st[k] for k in ("pos", "umi", "strand_ab", "frag_end", "valid")]
    want = jax.vmap(lambda *a: jax_group(*a, **kw))(*args)
    got = group_kernel(*(torch.from_numpy(np.ascontiguousarray(a)) for a in args), **kw)
    assert int(np.asarray(want[5]).sum()) > 0  # the table did overflow
    for key, w, g in zip(KEYS, want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=key)


@pytest.mark.parametrize("umi_len", [1, 12, 15, 16, 31])
def test_pack_umi_words_matches_jax(umi_len):
    codes = np.random.default_rng(umi_len).integers(0, 4, (3, 50, umi_len)).astype(np.uint8)
    got = pack_umi_words(torch.from_numpy(codes))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_pack(codes)))


@pytest.mark.parametrize("length", [1, 4, 7, 150])
def test_pack_2bit_matches_jax(length):
    codes = np.random.default_rng(length).integers(0, 4, (2, 5, length)).astype(np.uint8)
    got = pack_2bit(torch.from_numpy(codes))
    assert got.dtype == torch.uint8 and got.shape[-1] == -(-length // 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_pack_2bit(codes)))


def test_unsorted_input_is_refused():
    z = torch.zeros(1, 4, dtype=torch.int32)
    with pytest.raises(NotImplementedError):
        group_kernel(z, torch.zeros(1, 4, 6, dtype=torch.uint8), z.bool(), z.bool(), z.bool())
