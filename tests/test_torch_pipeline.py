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
