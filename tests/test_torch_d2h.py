"""The port's wire rungs against the JAX package's.

- Packed D2H: the port's batched compaction (``pack_fetch_outputs``) on
  the outputs of one real dispatch class must give wire arrays
  byte-equal to the JAX ``_pack_d2h_fn`` on the same (numpy) outputs,
  and ``unpack_fetch_outputs`` must give back the unpacked fetch at
  every position the scatter reads. Also the ids-lane rung, the
  overflow check, the k_pad bound and the per-class rung decision.
- Sub-byte H2D: ``unpack_bitplanes`` and the sub-byte ``pack_stacked``
  equal to JAX, and a class dispatched on the sub-byte rung gives the
  unpacked pipeline's outputs exactly.

All comparisons are exact (tolerance 0): these are integer layouts.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from duplexumiconsensusreads_tpu.bucketing import build_buckets as jax_build_buckets
from duplexumiconsensusreads_tpu.bucketing import stack_buckets as jax_stack
from duplexumiconsensusreads_tpu.kernels.encoding import unpack_bitplanes as jax_unpack_bitplanes
from duplexumiconsensusreads_tpu.ops.pipeline import pack_stacked as jax_pack_stacked
from duplexumiconsensusreads_tpu.ops.pipeline import qual_alphabet as jax_qual_alphabet
from duplexumiconsensusreads_tpu.runtime import executor as jx
from duplexumiconsensusreads_tpu.simulate import SimConfig, simulate_batch
from duplexumiconsensusreads_tpu.types import ConsensusParams as JC
from duplexumiconsensusreads_tpu.types import GroupingParams as JG
from duplexumiconsensusreads_torch.bucketing import build_buckets, stack_buckets
from duplexumiconsensusreads_torch.interop import ARRAY_KEYS, stacked_from_numpy
from duplexumiconsensusreads_torch.kernels.encoding import unpack_bitplanes
from duplexumiconsensusreads_torch.ops import pipeline
from duplexumiconsensusreads_torch.runtime import executor as tx
from duplexumiconsensusreads_torch.types import ConsensusParams, GroupingParams

CASES = {  # name: (strategy, mode, error model, mate-aware)
    "config1": ("exact", "single_strand", None, False),
    "config5": ("adjacency", "duplex", "cycle", False),
    "config5_mates": ("adjacency", "duplex", "cycle", True),
}


def _batch(mates: bool, **sim):
    batch, _ = simulate_batch(SimConfig(
        n_molecules=100, read_len=40, n_positions=12, umi_error=0.02,
        duplex=True, paired_reads=mates, seed=5, **sim,
    ))
    return batch


def _classes(name: str, **sim):
    strategy, mode, em, mates = CASES[name]
    gp = GroupingParams(strategy=strategy, paired=mode == "duplex", mate_aware=mates)
    cp = ConsensusParams(mode=mode, error_model=em)
    buckets = build_buckets(_batch(mates, **sim), capacity=128, grouping=gp)
    return buckets, tx.partition_buckets(buckets, gp, cp, packed_io=True, device="cpu"), gp, cp


def _outputs(cbuckets, spec):
    st = stack_buckets(cbuckets)
    if spec.packed_io:
        pipeline.pack_stacked(st, spec)
    args = stacked_from_numpy(st, "cpu")
    return pipeline.fused_pipeline(*(args[k] for k in ARRAY_KEYS), spec)


@pytest.mark.parametrize("name", sorted(CASES))
def test_packed_wire_equals_jax_and_round_trips(name):
    buckets, part, _, _ = _classes(name)
    for cbuckets, spec in part:
        out = _outputs(cbuckets, spec)
        k_pad = tx.d2h_k_pad(cbuckets, spec)
        assert k_pad == jx.d2h_k_pad(cbuckets, spec)
        wire = tx.fetch_outputs(tx.start_fetch(
            tx.pack_fetch_outputs(out, spec, k_pad), keys=tx.PACKED_FETCH_KEYS,
        ))
        # the JAX epilogue on the very same outputs (host numpy -> jnp)
        want = jx._pack_d2h_fn()(
            {k: jnp.asarray(v.numpy()) for k, v in out.items()},
            spec.consensus.mode == "duplex", k_pad, 1,
        )
        assert set(wire) == set(want) == set(tx.PACKED_FETCH_KEYS)
        for k in tx.PACKED_FETCH_KEYS:
            w = np.asarray(want[k])
            assert wire[k].dtype == w.dtype and wire[k].shape == w.shape, k
            assert wire[k].tobytes() == w.tobytes(), k
        # round trip: every position the scatter reads comes back exact
        full = tx.unpack_fetch_outputs(dict(wire), cbuckets, spec)
        ref = tx.fetch_outputs(tx.start_fetch(out))
        duplex = spec.consensus.mode == "duplex"
        n_out = np.clip(ref["n_molecules" if duplex else "n_families"], 0,
                        ref["cons_valid"].shape[1])
        live = np.arange(ref["cons_valid"].shape[1])[None, :] < n_out[:, None]
        for k, v in full.items():
            assert v.dtype == ref[k].dtype, k
            if v.ndim >= 2 and v.shape[:2] == live.shape:
                np.testing.assert_array_equal(v[live], ref[k][live], err_msg=k)
            else:
                np.testing.assert_array_equal(v, ref[k], err_msg=k)
        # the ledger's logical side: what the unpacked fetch moves
        assert tx.d2h_logical_nbytes(wire, cbuckets, spec) == sum(
            v.nbytes for v in ref.values()
        )
        assert sum(v.nbytes for v in wire.values()) < sum(v.nbytes for v in ref.values())


def test_ids16_rung_round_trips_and_overflow_is_loud():
    buckets, part, _, _ = _classes("config5")
    # a class whose row bound is tighter than its padded rows, so a
    # forged count can overflow it
    cbuckets, spec = next(
        (cb, sp) for cb, sp in part if tx.d2h_k_pad(cb, sp) < len(cb) * sp.m_max
    )
    out = _outputs(cbuckets, spec)
    ref = tx.fetch_outputs(tx.start_fetch(out))
    ids16 = tx.fetch_outputs(tx.start_fetch(tx.pack_ids_u16(out, True), keys=tx.IDS16_FETCH_KEYS))
    assert ids16["ids16"].dtype == np.uint16
    full = tx.unpack_fetch_outputs(ids16, cbuckets, spec)
    np.testing.assert_array_equal(full["molecule_id"], ref["molecule_id"])
    assert tx.d2h_logical_nbytes(ids16, cbuckets, spec) == sum(v.nbytes for v in ref.values())
    # a forged count past the bound: the typed, unretried failure
    k_pad = tx.d2h_k_pad(cbuckets, spec)
    wire = tx.fetch_outputs(tx.start_fetch(tx.pack_fetch_outputs(out, spec, k_pad),
                                           keys=tx.PACKED_FETCH_KEYS))
    wire["n_molecules"] = np.full_like(wire["n_molecules"], 1 << 20)
    with pytest.raises(tx.D2hCompactionOverflow, match="overflow"):
        tx.unpack_fetch_outputs(wire, cbuckets, spec)


@pytest.mark.parametrize("d2h_on", [False, True])
@pytest.mark.parametrize("ids16_want", [False, True])
@pytest.mark.parametrize("capacity", [128, 1 << 16])
@pytest.mark.parametrize("per_base_tags", [False, True])
def test_d2h_rung_decision_matches_jax(d2h_on, ids16_want, capacity, per_base_tags):
    args = (d2h_on, ids16_want, capacity, per_base_tags)
    assert tx.d2h_rung_for_class(*args) == jx.d2h_rung_for_class(*args)
    assert tx.d2h_pack_ok(capacity, per_base_tags) == jx.d2h_pack_ok(capacity, per_base_tags)


@pytest.mark.parametrize("nbits, l", [(5, 40), (7, 40), (5, 13), (7, 150)])
def test_unpack_bitplanes_matches_jax(nbits, l):
    rng = np.random.default_rng(nbits * 1000 + l)
    packed = rng.integers(0, 256, (3, 7, nbits * -(-l // 8))).astype(np.uint8)
    got = unpack_bitplanes(torch.from_numpy(packed), l, nbits).numpy()
    want = np.asarray(jax_unpack_bitplanes(jnp.asarray(packed), l, nbits))
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("qual_range, qbits", [((30, 33), 3), ((20, 40), 5)])
def test_subbyte_pack_equals_jax_and_decodes_exactly(qual_range, qbits):
    lo, hi = qual_range
    gp, cp = GroupingParams(strategy="adjacency", paired=True), ConsensusParams(mode="duplex")
    batch = _batch(False, qual_lo=lo, qual_hi=hi)
    buckets = build_buckets(batch, capacity=128, grouping=gp)
    alpha = pipeline.qual_alphabet(buckets)
    jbuckets = jax_build_buckets(batch, capacity=128, grouping=JG(**vars(gp)))
    assert alpha == jax_qual_alphabet(jbuckets)
    assert pipeline.subbyte_qbits_for(len(alpha)) == qbits
    part = tx.partition_buckets(buckets, gp, cp, packed_io=True, qual_alphabet=alpha,
                                device="cpu")
    jpart = jx.partition_buckets(jbuckets, JG(**vars(gp)), JC(**vars(cp)), packed_io=True,
                                 qual_alphabet=alpha)
    for (cbuckets, spec), (jcb, jspec) in zip(part, jpart):
        assert (spec.packed_qbits, spec.qual_lut, spec.cycles_len) == (
            jspec.packed_qbits, jspec.qual_lut, jspec.cycles_len) and spec.packed_qbits == qbits
        st = pipeline.pack_stacked(stack_buckets(cbuckets), spec)
        jst = jax_pack_stacked(jax_stack(jcb), jspec)
        for k in ARRAY_KEYS:
            assert st[k].dtype == jst[k].dtype and st[k].tobytes() == jst[k].tobytes(), k
        # the sub-byte class decodes to exactly the unpacked pipeline
        got = _outputs(cbuckets, spec)
        want = _outputs(cbuckets, dataclasses.replace(
            spec, packed_io=False, umi_len=None, packed_qbits=None, qual_lut=None,
            cycles_len=None))
        for k in want:
            assert torch.equal(got[k], want[k]), k


def test_subbyte_spec_is_validated():
    cp = ConsensusParams(mode="duplex")
    gp = GroupingParams(strategy="adjacency", paired=True)
    with pytest.raises(ValueError, match="packed_qbits"):
        pipeline.PipelineSpec(gp, cp, packed_io=True, packed_qbits=3,
                              qual_lut=tuple(range(8)), cycles_len=40)
    with pytest.raises(ValueError, match="packed_qbits"):
        pipeline.PipelineSpec(gp, cp, packed_io=False, packed_qbits=5,
                              qual_lut=(30,), cycles_len=40)
