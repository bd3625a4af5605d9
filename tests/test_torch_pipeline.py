"""The torch port's batched fused pipeline against the JAX package's.

For each benchmark preset (config1-config5), the same stacked bucket
class (repo simulator + bucketing + the JAX package's partition) goes
through the JAX ``fused_pipeline`` under ``vmap`` and the port's
batched ``fused_pipeline`` — unpacked and with the byte-rung packed
wire convention. Every output key must meet the parity bar: ids,
counts, depths, validity and mate/pair/end metadata bit-identical,
bases identical, quals within one per single-strand consensus (so
within two for a duplex qual, the sum of two strand quals). The JAX
side runs the dense one-hot reduction; the port its default
(segment_gemm, the plain version on the CPU).

Then the contracts of tests/test_pipeline.py on the port: each bucket
against the oracle on its own reads (that suite's check), bucketing
equal to the JAX package's and keeping groups and families whole, a
giant family's one jumbo bucket, duplex refused without paired
grouping, the cycle model's Q40+ calibration, and every reduction
method's per-base err counts equal to the oracle's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from duplexumiconsensusreads_tpu.bucketing import build_buckets, stack_buckets
from duplexumiconsensusreads_tpu.parallel.sharded import _ARRAY_KEYS, _vmapped
from duplexumiconsensusreads_tpu.runtime.executor import partition_buckets
from duplexumiconsensusreads_tpu.simulate import SimConfig, simulate_batch
from duplexumiconsensusreads_tpu.types import ConsensusParams, GroupingParams
from duplexumiconsensusreads_torch.interop import stacked_from_numpy, spec_from_fields
from duplexumiconsensusreads_torch.ops import pipeline as port
from test_pipeline import CONFIGS as PIPELINE_CONFIGS
from test_pipeline import _check_bucket_against_oracle as check_bucket_against_oracle

PRESETS = {  # the JAX CLI's table (cli/main.py CONFIG_PRESETS)
    "config1": ("exact", "ss", None),
    "config2": ("adjacency", "ss", None),
    "config3": ("adjacency", "duplex", None),
    "config4": ("adjacency", "duplex", None),
    "config5": ("adjacency", "duplex", "cycle"),
}
INT_KEYS = (
    "family_id", "molecule_id", "n_families", "n_molecules", "n_overflow",
    "cons_base", "cons_depth", "depth_max", "depth_min_pos", "cons_valid",
    "cons_mate", "cons_pair", "cons_end", "cons_err",
)


def _class(config: str, per_base_counts: bool = False, mate_aware: bool = False):
    strategy, mode, em = PRESETS[config]
    duplex = mode == "duplex"
    gp = GroupingParams(strategy=strategy, paired=duplex, mate_aware=mate_aware)
    cp = ConsensusParams(mode="duplex" if duplex else "single_strand", error_model=em)
    batch, _ = simulate_batch(
        SimConfig(n_molecules=100, read_len=32, n_positions=16, umi_error=0.02,
                  cycle_error_slope=0.003, duplex=duplex, paired_reads=mate_aware,
                  n_frac=0.01, seed=int(config[-1]))
    )
    buckets = build_buckets(batch, capacity=128, grouping=gp)
    classes = partition_buckets(buckets, gp, cp, ssc_method="matmul",
                                per_base_counts=per_base_counts)
    cbuckets, spec = max(classes, key=lambda c: len(c[0]))
    assert len(cbuckets) >= 2
    return stack_buckets(cbuckets), spec


def _port_spec(spec, **over):
    fields = {f.name: getattr(spec, f.name) for f in dataclasses.fields(spec)}
    fields.update(over)
    return spec_from_fields(**fields)


def _check(got: dict, want: dict, duplex: bool):
    assert set(got) == set(want)
    for key, w in want.items():
        w = np.asarray(w)
        g = got[key].numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, key
        if key == "cons_qual":
            assert np.abs(g.astype(int) - w.astype(int)).max() <= (2 if duplex else 1)
        else:
            assert key in INT_KEYS, key
            np.testing.assert_array_equal(g, w, err_msg=key)


@pytest.mark.parametrize("config", sorted(PRESETS))
def test_fused_pipeline_matches_jax_packed_and_unpacked(config):
    st, spec = _class(config)
    want = _vmapped(*(st[k] for k in _ARRAY_KEYS), spec)
    duplex = spec.consensus.mode == "duplex"
    unpacked = port.fused_pipeline(*stacked_from_numpy(st, "cpu").values(), _port_spec(spec))
    _check(unpacked, want, duplex)
    assert int(unpacked["cons_valid"].sum()) > 0

    umi_len = int(st["umi"].shape[2])
    packed_st = port.pack_stacked({k: np.array(v) for k, v in st.items()})
    packed = port.fused_pipeline(
        *stacked_from_numpy(packed_st, "cpu").values(),
        _port_spec(spec, packed_io=True, umi_len=umi_len),
    )
    _check(packed, want, duplex)


@pytest.mark.parametrize("config, mate_aware, per_base", [
    ("config3", True, False),
    ("config2", False, True),
])
def test_fused_pipeline_mate_aware_and_per_base_counts(config, mate_aware, per_base):
    st, spec = _class(config, per_base_counts=per_base, mate_aware=mate_aware)
    want = _vmapped(*(st[k] for k in _ARRAY_KEYS), spec)
    got = port.fused_pipeline(*stacked_from_numpy(st, "cpu").values(), _port_spec(spec))
    _check(got, want, spec.consensus.mode == "duplex")


def test_pack_stacked_matches_jax_wire_bytes():
    from duplexumiconsensusreads_tpu.ops.pipeline import pack_stacked as jax_pack

    st, _ = _class("config5")
    a = jax_pack({k: np.array(v) for k, v in st.items()})
    b = port.pack_stacked({k: np.array(v) for k, v in st.items()})
    for k in _ARRAY_KEYS:
        assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k


def test_spec_for_buckets_matches_jax():
    from duplexumiconsensusreads_tpu.ops.pipeline import spec_for_buckets as jax_spec_for

    batch, _ = simulate_batch(SimConfig(n_molecules=60, read_len=24, seed=2))
    gp = GroupingParams(strategy="adjacency", paired=True, mate_aware=True)
    cp = ConsensusParams(mode="duplex")
    buckets = build_buckets(batch, capacity=64, grouping=gp)
    from duplexumiconsensusreads_torch.types import ConsensusParams as PC, GroupingParams as PG

    j = jax_spec_for(buckets, gp, cp, packed_io=True)
    p = port.spec_for_buckets(buckets, PG(**vars(gp)), PC(**vars(cp)), packed_io=True)
    for f in ("u_max", "f_max", "m_max", "presorted", "packed_io", "umi_len"):
        assert getattr(p, f) == getattr(j, f), f


def test_analytic_flops_registry_covers_every_method():
    from duplexumiconsensusreads_torch.kernels.consensus import SSC_METHODS

    assert set(port.SSC_METHOD_COSTS) == set(SSC_METHODS)
    for m in SSC_METHODS:
        assert port.analytic_flops(port.PipelineSpec(ssc_method=m), 128, 32, 12) > 0


@pytest.mark.parametrize("config", ["config3", "config5"])
def test_duplex_gather_merge_when_rows_are_not_strided(config):
    # a class capped at the bucket capacity has 2*m_max != f_max: dense
    # family rows, merged by the gather-based duplex_kernel on both sides
    st, spec = _class(config)
    spec = dataclasses.replace(spec, m_max=spec.f_max)
    want = _vmapped(*(st[k] for k in _ARRAY_KEYS), spec)
    got = port.fused_pipeline(*stacked_from_numpy(st, "cpu").values(), _port_spec(spec))
    _check(got, want, duplex=True)
    assert int(got["cons_valid"].sum()) > 0


# ---- the contracts of tests/test_pipeline.py, on the port

def _port_batch(cfg):
    from duplexumiconsensusreads_torch.simulate import simulate_batch as port_simulate

    return port_simulate(cfg)


def _params(gp, cp):
    from duplexumiconsensusreads_torch import types as pt

    return pt.GroupingParams(**vars(gp)), pt.ConsensusParams(**vars(cp))


@pytest.mark.parametrize("name, cfg, gp, cp", PIPELINE_CONFIGS,
                         ids=[c[0] for c in PIPELINE_CONFIGS])
def test_fused_pipeline_matches_the_oracle_per_bucket(name, cfg, gp, cp):
    """Every bucket of the JAX suite's five configurations through the
    port's run_bucket on the CPU, held against the oracle on exactly
    that bucket's reads by the JAX suite's own check."""
    from duplexumiconsensusreads_torch.bucketing import build_buckets as port_build_buckets
    from duplexumiconsensusreads_torch.ops import PipelineSpec as PortSpec
    from duplexumiconsensusreads_torch.ops import run_bucket

    batch, _ = _port_batch(cfg)
    pgp, pcp = _params(gp, cp)
    spec = PortSpec(grouping=pgp, consensus=pcp)
    for bucket in port_build_buckets(batch, capacity=512, adjacency=gp.strategy == "adjacency"):
        out = {k: v.numpy() for k, v in run_bucket(bucket, spec, device="cpu").items()}
        check_bucket_against_oracle(bucket, out, gp, cp,
                                    qual_tol=5 if name == "cfg5_min_input_qual" else 3)


def test_bucketing_preserves_reads_and_groups_alike():
    """The port's buckets equal the JAX package's; every valid read once,
    a position group split only past the capacity, no family torn."""
    from duplexumiconsensusreads_torch.bucketing import build_buckets as port_build_buckets
    from duplexumiconsensusreads_torch.utils.phred import pack_umi

    batch, _ = _port_batch(SimConfig(n_molecules=200, n_positions=20, duplex=True, seed=25))
    buckets = port_build_buckets(batch, capacity=128)
    assert [b.read_index.tolist() for b in buckets] == [
        b.read_index.tolist() for b in build_buckets(batch, capacity=128)]
    all_idx = np.concatenate([b.read_index[b.valid] for b in buckets])
    assert sorted(all_idx) == sorted(np.nonzero(batch.valid)[0])
    pos_all = np.asarray(batch.pos_key)
    sizes = {p: (pos_all[batch.valid] == p).sum() for p in np.unique(pos_all)}
    pos_of, fam_of = {}, {}
    for bi, b in enumerate(buckets):
        idx = b.read_index[b.valid]
        for p in np.unique(pos_all[idx]):
            pos_of.setdefault(p, set()).add(bi)
        for k in set(zip(pos_all[idx], pack_umi(np.asarray(batch.umi)[idx]))):
            fam_of.setdefault(k, set()).add(bi)
    assert all(sizes[p] > 128 for p, bs in pos_of.items() if len(bs) > 1)
    assert not [k for k, bs in fam_of.items() if len(bs) > 1]


def test_giant_family_gets_one_jumbo_bucket_alike():
    import warnings

    from duplexumiconsensusreads_torch.bucketing import build_buckets as port_build_buckets
    from duplexumiconsensusreads_torch.types import ReadBatch

    b = ReadBatch.empty(100, 20, 6)
    b.valid[:] = True
    b.bases[:] = 0
    b.pos_key[:] = 1000
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        buckets = port_build_buckets(b, capacity=32)
        theirs = build_buckets(b, capacity=32)
    assert [bk.capacity for bk in buckets] == [bk.capacity for bk in theirs] == [128]
    assert sorted(buckets[0].read_index[buckets[0].valid]) == list(range(100))


def test_duplex_requires_paired_grouping_alike():
    from duplexumiconsensusreads_torch import types as pt
    from duplexumiconsensusreads_torch.ops import PipelineSpec as PortSpec

    with pytest.raises(ValueError, match="paired"):
        PortSpec(grouping=pt.GroupingParams(paired=False),
                 consensus=pt.ConsensusParams(mode="duplex"))


def test_cycle_error_model_earns_its_flops_in_the_port():
    """Late-cycle error above the reported quals: config5's cycle model
    keeps the overall error and fixes the Q40+ calibration in the
    port's call_batch, as in the JAX package's."""
    from duplexumiconsensusreads_torch.runtime.executor import call_batch

    batch, truth = _port_batch(SimConfig(
        n_molecules=500, read_len=60, n_positions=12, mean_family_size=3, base_error=0.002,
        cycle_error_slope=0.004, umi_error=0.0, duplex=True, qual_lo=30, qual_hi=40, seed=42))
    lut = {(int(p), u.tobytes()): i for i, (p, u) in enumerate(zip(truth.mol_pos_key,
                                                                    truth.mol_umi))}
    stats = {}
    for em in (None, "cycle"):
        gp, cp = _params(GroupingParams(strategy="exact", paired=True),
                         ConsensusParams(mode="duplex", error_model=em, min_duplex_reads=1))
        cb, cq, _, cv, fp, fu = call_batch(batch, gp, cp, capacity=1024, device="cpu")[:6]
        n_err = n_base = hi_err = hi_base = 0
        for i in np.nonzero(cv)[0]:
            real = cb[i] < 4
            wrong = real & (cb[i] != truth.mol_seq[lut[(int(fp[i]), fu[i].tobytes())]])
            hi = real & (cq[i] >= 40)
            n_err, n_base = n_err + int(wrong.sum()), n_base + int(real.sum())
            hi_err, hi_base = hi_err + int((wrong & hi).sum()), hi_base + int(hi.sum())
        assert n_base > 10_000
        stats[em] = (n_err / n_base, hi_err / max(hi_base, 1), hi_base)
    (err3, hi3, nhi3), (err5, hi5, nhi5) = stats[None], stats["cycle"]
    assert err5 <= err3 * 1.05 and nhi3 > 0 and nhi5 > 0
    assert hi5 < hi3 and hi5 <= 10 ** (-40 / 10) * 20


@pytest.mark.parametrize("method", ["segment_gemm", "matmul", "blockseg", "segment"])
@pytest.mark.parametrize("gp_kw, cp_kw", [
    (dict(strategy="exact", paired=False), dict(mode="single_strand")),
    (dict(strategy="adjacency", paired=True), dict(mode="duplex")),
    (dict(strategy="adjacency", paired=True), dict(mode="duplex", error_model="cycle")),
], ids=["ss-exact", "duplex", "duplex-cycle"])
def test_per_base_err_counts_match_the_oracle(gp_kw, cp_kw, method):
    """spec.per_base_counts: every reduction method's err matrix (the
    ce tag) equals the port oracle's exactly, bucket by bucket, and the
    port oracle equals the JAX package's."""
    from duplexumiconsensusreads_tpu.oracle import group_reads as jax_group
    from duplexumiconsensusreads_tpu.ops import ConsensusCaller as JaxCaller
    from duplexumiconsensusreads_torch import oracle
    from duplexumiconsensusreads_torch.bucketing import build_buckets as port_build_buckets
    from duplexumiconsensusreads_torch.ops import ConsensusCaller, run_bucket
    from duplexumiconsensusreads_torch.ops import spec_for_buckets as port_spec_for_buckets
    from duplexumiconsensusreads_torch.types import ReadBatch

    batch, _ = _port_batch(SimConfig(n_molecules=120, duplex=True, umi_error=0.02,
                                     base_error=0.05, seed=19))
    gp, cp = _params(GroupingParams(**gp_kw), ConsensusParams(**cp_kw))
    buckets = port_build_buckets(batch, capacity=512, grouping=gp)
    spec = dataclasses.replace(port_spec_for_buckets(buckets, gp, cp, ssc_method=method),
                               per_base_counts=True)
    checked = total_err = 0
    for bk in buckets:
        err = run_bucket(bk, spec, device="cpu")["cons_err"].numpy()
        sub = ReadBatch(bases=bk.bases, quals=bk.quals, umi=bk.umi,
                        pos_key=bk.pos.astype(np.int64), strand_ab=bk.strand_ab,
                        frag_end=bk.frag_end, valid=bk.valid)
        fams = oracle.group_reads(sub, gp)
        cons = ConsensusCaller(cp, backend="cpu")(sub, fams)
        jcons = JaxCaller(ConsensusParams(**cp_kw), backend="cpu")(
            sub, jax_group(sub, GroupingParams(**gp_kw)))
        np.testing.assert_array_equal(cons.err, jcons.err)
        n = len(cons.valid)
        np.testing.assert_array_equal(err[:n], cons.err)
        assert not err[n:].any() and (cons.err <= cons.depth).all()
        checked += int(cons.valid.sum())
        total_err += int(cons.err.sum())
    assert checked > 50 and total_err > 0
