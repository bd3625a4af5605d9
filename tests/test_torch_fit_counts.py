"""The counts fit of the cycle error model against the JAX package's.

``ssc_kernel(columns="fit_counts")`` (the fit pass plus 4L unfiltered
per-base count columns) per ssc method on the same bucket as the JAX
kernel, ``fit_cycle_cap_from_counts`` against the JAX function and
against the port's gather fit, ``fused_pipeline`` with
``fit_impl="counts"`` against ``"gather"`` and against the JAX pipeline
with the same spec, ``DUT_FIT_IMPL`` through ``spec_for_buckets``, and
``spec_from_fields`` mapping a JAX spec with the counts fit.

Tolerances: the integer outputs (family sizes, counts, cycle caps) are
exact on every method but runsum, whose family sums are differences of
large prefix sums and are held to the JAX package's runsum tolerance
(atol 3); the fit argmax is exact against JAX but at evidence ties,
as in tests/test_torch_ssc_methods.py; within the port, the counts
and gather fits give identical caps and pipeline outputs, since the
count columns do not change how the loglik columns are summed.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from duplexumiconsensusreads_tpu.bucketing import build_buckets, stack_buckets
from duplexumiconsensusreads_tpu.kernels.consensus import ssc_kernel as jax_ssc
from duplexumiconsensusreads_tpu.kernels.error_model import (
    fit_cycle_cap_from_counts as jax_fit_counts,
)
from duplexumiconsensusreads_tpu.oracle import group_reads
from duplexumiconsensusreads_tpu.parallel.sharded import _ARRAY_KEYS, _vmapped
from duplexumiconsensusreads_tpu.runtime.executor import partition_buckets
from duplexumiconsensusreads_tpu.simulate import SimConfig, simulate_batch
from duplexumiconsensusreads_tpu.types import ConsensusParams, GroupingParams
from duplexumiconsensusreads_torch.interop import spec_from_fields, stacked_from_numpy
from duplexumiconsensusreads_torch.kernels.consensus import SSC_METHODS, ssc_kernel
from duplexumiconsensusreads_torch.kernels.error_model import (
    fit_cycle_cap_from_counts,
    fit_cycle_cap_kernel,
)
from duplexumiconsensusreads_torch.ops import pipeline as port

F_MAX = 128
# the port's method -> the JAX method that computes the same reduction
# (segment_gemm's counterpart is the Pallas kernel; its plain reduction
# is JAX's segment_sum)
JAX_METHOD = {"segment_gemm": "segment", "matmul": "matmul", "segment": "segment",
              "blockseg": "blockseg", "runsum": "runsum"}
RUNSUM_ATOL = 3


def _bucket(seed, min_qual_n=False):
    batch, _ = simulate_batch(
        SimConfig(n_molecules=60, read_len=36, n_positions=6, duplex=False,
                  n_frac=0.02, seed=seed)
    )
    fams = group_reads(batch, GroupingParams(strategy="exact"))
    bases = np.asarray(batch.bases)
    quals = np.asarray(batch.quals)
    if min_qual_n:
        quals = np.where(bases == 4, 0, quals).astype(np.uint8)
    fid = np.asarray(fams.family_id).astype(np.int32)
    valid = np.asarray(batch.valid).copy()
    valid[::13] = False
    return bases, quals, fid, valid


def _port(bases, quals, fid, valid, **kw):
    t = [torch.from_numpy(np.ascontiguousarray(x))[None] for x in (bases, quals, fid, valid)]
    return [o[0].numpy() for o in ssc_kernel(*t, **kw)]


def _random_bucket(rng, r=300, l=40, f_max=64):
    bases = rng.integers(0, 6, (r, l)).astype(np.uint8)  # N and PAD included
    quals = rng.integers(2, 41, (r, l)).astype(np.uint8)
    fid = rng.integers(-1, f_max, r).astype(np.int32)
    valid = rng.random(r) < 0.9
    return bases, quals, fid, valid


@pytest.mark.parametrize("method", SSC_METHODS)
@pytest.mark.parametrize("min_input_qual", [0, 20])
def test_ssc_fit_counts_matches_jax(method, min_input_qual):
    bases, quals, fid, valid = _bucket(4 + min_input_qual, min_qual_n=True)
    kw = dict(f_max=F_MAX, min_reads=2, min_input_qual=min_input_qual, columns="fit_counts")
    got = _port(bases, quals, fid, valid, method=method, **kw)
    want = [np.asarray(o) for o in jax_ssc(bases, quals, fid, valid,
                                           method=JAX_METHOD[method], **kw)]
    assert len(got) == len(want) == 4
    names = ("cons_base", "fam_size", "fam_valid", "counts")
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        if method == "runsum":
            np.testing.assert_allclose(g.astype(np.float64), w.astype(np.float64),
                                       atol=RUNSUM_ATOL, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    # the count columns are the unfiltered per-base tallies of the
    # contributing reads (min_input_qual deliberately not applied)
    ok = valid & (fid >= 0)
    recount = np.zeros((F_MAX, bases.shape[1], 4), np.float32)
    for i in np.nonzero(ok)[0]:
        real = bases[i] < 4
        recount[fid[i], np.nonzero(real)[0], bases[i][real]] += 1
    if method != "runsum":
        np.testing.assert_array_equal(got[3].reshape(F_MAX, -1, 4), recount)
    # the fit pass's outputs are the plain fit's on the port
    fit = _port(bases, quals, fid, valid, method=method,
                **{**kw, "columns": "fit"})
    if method != "runsum":
        for g, w in zip(got[:3], fit):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed", [99, 7])
@pytest.mark.parametrize("min_input_qual", [0, 15])
def test_fit_cycle_cap_from_counts_bit_identical(seed, min_input_qual):
    """The family-side fit equals the JAX function on the same counts,
    and the port's read-side gather fit on the same pass-1 consensus."""
    rng = np.random.default_rng(seed)
    bases, quals, fid, valid = _random_bucket(rng)
    kw = dict(f_max=64, min_reads=2, max_qual=90, max_input_qual=50,
              min_input_qual=min_input_qual)
    cb0, _sz0, fv0, counts0 = _port(bases, quals, fid, valid, columns="fit_counts", **kw)
    got = fit_cycle_cap_from_counts(*(torch.from_numpy(x)[None] for x in (cb0, counts0, fv0)))
    want = np.asarray(jax_fit_counts(cb0, counts0, fv0))
    assert got.dtype == torch.int32 and got.shape == (1, bases.shape[1])
    np.testing.assert_array_equal(got[0].numpy(), want)
    gather = fit_cycle_cap_kernel(
        *(torch.from_numpy(np.ascontiguousarray(x))[None] for x in (bases, fid, valid, cb0, fv0))
    )
    np.testing.assert_array_equal(got.numpy(), gather.numpy())
    # a narrower cap table moves both fits alike
    for cap in (30, 90):
        a = fit_cycle_cap_from_counts(*(torch.from_numpy(x)[None] for x in (cb0, counts0, fv0)),
                                      max_phred_cap=cap)
        np.testing.assert_array_equal(
            a[0].numpy(), np.asarray(jax_fit_counts(cb0, counts0, fv0, max_phred_cap=cap)))


def _class(seed, read_len=36, mate_aware=False):
    gp = GroupingParams(strategy="adjacency", paired=True, mate_aware=mate_aware)
    cp = ConsensusParams(mode="duplex", error_model="cycle")
    batch, _ = simulate_batch(
        SimConfig(n_molecules=110, read_len=read_len, n_positions=16, umi_error=0.02,
                  cycle_error_slope=0.003, duplex=True, paired_reads=mate_aware,
                  n_frac=0.01, seed=seed)
    )
    buckets = build_buckets(batch, capacity=128, grouping=gp)
    classes = partition_buckets(buckets, gp, cp, ssc_method="matmul")
    cbuckets, spec = max(classes, key=lambda c: len(c[0]))
    assert len(cbuckets) >= 2
    return stack_buckets(cbuckets), spec


def _fields(spec, **over):
    fields = {f.name: getattr(spec, f.name) for f in dataclasses.fields(spec)}
    fields.update(over)
    return fields


@pytest.mark.parametrize("seed, read_len, mate_aware, method", [
    (5, 36, False, "segment_gemm"),
    (8, 48, True, "segment_gemm"),
    (5, 36, False, "blockseg"),
    (11, 40, False, "matmul"),
])
def test_fused_pipeline_counts_equals_gather_and_jax(seed, read_len, mate_aware, method):
    st, spec = _class(seed, read_len, mate_aware)
    inputs = list(stacked_from_numpy(st, "cpu").values())
    outs = {
        impl: port.fused_pipeline(*inputs, spec_from_fields(
            **_fields(spec, fit_impl=impl, ssc_method=method)))
        for impl in ("gather", "counts")
    }
    assert set(outs["counts"]) == set(outs["gather"])
    for key, g in outs["gather"].items():
        np.testing.assert_array_equal(outs["counts"][key].numpy(), g.numpy(), err_msg=key)
    want = _vmapped(*(st[k] for k in _ARRAY_KEYS), dataclasses.replace(spec, fit_impl="counts"))
    got = outs["counts"]
    assert set(got) == set(want)
    for key, w in want.items():
        w, g = np.asarray(w), got[key].numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, key
        if key == "cons_qual":
            assert np.abs(g.astype(int) - w.astype(int)).max() <= 2  # a duplex qual
        else:
            np.testing.assert_array_equal(g, w, err_msg=key)
    assert int(got["cons_valid"].sum()) > 0


@pytest.mark.parametrize("env, want", [(None, "gather"), ("gather", "gather"),
                                       ("counts", "counts")])
def test_dut_fit_impl_sets_the_spec_as_in_jax(monkeypatch, env, want):
    from duplexumiconsensusreads_tpu.ops.pipeline import spec_for_buckets as jax_spec_for
    from duplexumiconsensusreads_torch import bucketing as port_bucketing

    if env is None:
        monkeypatch.delenv("DUT_FIT_IMPL", raising=False)
    else:
        monkeypatch.setenv("DUT_FIT_IMPL", env)
    gp = GroupingParams(strategy="adjacency", paired=True)
    cp = ConsensusParams(mode="duplex", error_model="cycle")
    batch, _ = simulate_batch(SimConfig(n_molecules=30, read_len=36, seed=2))
    theirs = jax_spec_for(build_buckets(batch, capacity=128, grouping=gp), gp, cp)
    ours = port.spec_for_buckets(
        port_bucketing.build_buckets(batch, capacity=128, grouping=gp), gp, cp)
    assert theirs.fit_impl == ours.fit_impl == want
    assert port.spec_for_buckets([], gp, cp).fit_impl == want


def test_spec_from_fields_maps_the_counts_fit():
    from duplexumiconsensusreads_tpu.ops.pipeline import PipelineSpec as JaxSpec

    js = JaxSpec(GroupingParams(strategy="adjacency", paired=True),
                 ConsensusParams(mode="duplex", error_model="cycle"),
                 u_max=64, f_max=128, m_max=64, ssc_method="pallas", fit_impl="counts")
    ps = spec_from_fields(**_fields(js))
    assert ps.fit_impl == "counts" and ps.ssc_method == "segment_gemm"
    assert spec_from_fields(**_fields(js, fit_impl="gather")).fit_impl == "gather"
    with pytest.raises(ValueError, match="fit_impl"):
        spec_from_fields(**_fields(js, fit_impl="bogus"))


def test_fit_counts_refuses_want_err():
    bases, quals, fid, valid = _bucket(3)
    with pytest.raises(ValueError, match="incompatible with want_err"):
        _port(bases, quals, fid, valid, f_max=F_MAX, columns="fit_counts", want_err=True)
    with pytest.raises(ValueError, match="columns mode"):
        _port(bases, quals, fid, valid, f_max=F_MAX, columns="counts")
