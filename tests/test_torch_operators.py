"""The operator boundary of the torch port against the JAX package's.

The same simulated ReadBatch (numpy) goes through
- the oracle copies (``oracle/consensus.py``, ``oracle/error_model.py``)
  and the JAX package's: identical outputs;
- ``UmiGrouper``: the ``cpu`` backend against the JAX ``cpu`` backend
  (identical), the ``cuda`` backend on ``device="cpu"`` against the JAX
  ``tpu`` backend under ``JAX_PLATFORMS=cpu`` (identical: ids and counts
  are integers);
- ``ConsensusCaller``: ``cpu`` against ``cpu`` (identical), ``cuda`` on
  the CPU against ``tpu`` at the parity bar: depth and validity
  identical, bases identical except at evidence ties, quals within 1
  per strand (ROADMAP "Faults found" 1 and 4).
Also: the cuda caller reaches ``segment_gemm``; the grouper refuses a
table over 2048 slots; the default backend needs a card.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from duplexumiconsensusreads_tpu import oracle as jax_oracle
from duplexumiconsensusreads_tpu import types as jt
from duplexumiconsensusreads_tpu.ops import ConsensusCaller as JaxCaller
from duplexumiconsensusreads_tpu.ops import UmiGrouper as JaxGrouper
from duplexumiconsensusreads_torch import oracle
from duplexumiconsensusreads_torch.constants import NO_CALL_QUAL
from duplexumiconsensusreads_torch.kernels import consensus as kcons
from duplexumiconsensusreads_torch.ops import ConsensusCaller, UmiGrouper
from duplexumiconsensusreads_torch.simulate import SimConfig, simulate_batch
from duplexumiconsensusreads_torch.types import ConsensusParams, GroupingParams

# (strategy, paired, mate_aware)
GROUPINGS = [("exact", False, False), ("adjacency", True, False),
             ("cluster", True, False), ("adjacency", True, True)]
GROUPING_IDS = ["exact-ss", "adjacency-duplex", "cluster-duplex", "adjacency-duplex-mates"]
# (grouping, consensus, mate_aware)
CALLS = {
    "config1": (GroupingParams("exact"), ConsensusParams()),
    "config5": (GroupingParams("adjacency", paired=True),
                ConsensusParams(mode="duplex", error_model="cycle")),
    "config5-mates": (GroupingParams("adjacency", paired=True, mate_aware=True),
                      ConsensusParams(mode="duplex", error_model="cycle", min_input_qual=10)),
    "ss-paired-minreads": (GroupingParams("cluster", paired=True),
                           ConsensusParams(min_reads=2, max_qual=60, max_input_qual=40)),
}
TIE_QUAL = 3


def _batch(mates: bool, seed: int = 5):
    batch, _ = simulate_batch(SimConfig(
        n_molecules=70, read_len=30, n_positions=10, umi_error=0.03,
        cycle_error_slope=0.003, duplex=True, paired_reads=mates, seed=seed,
    ))
    return batch


def _jax(obj, cls):
    """The same numpy fields as the JAX package's dataclass."""
    return cls(**{f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)})


def _assert_fams_equal(a, b):
    for f in ("family_id", "molecule_id", "pair_id", "n_families", "n_molecules"):
        np.testing.assert_array_equal(np.asarray(getattr(a, f)), np.asarray(getattr(b, f)),
                                      err_msg=f)


@pytest.mark.parametrize("name", ["config1", "config5", "ss-paired-minreads"])
def test_oracle_copies_equal_jax(name):
    gp, cp = CALLS[name]
    batch = _batch(False)
    jb = _jax(batch, jt.ReadBatch)
    fams = oracle.group_reads(batch, gp)
    jfams = jax_oracle.group_reads(jb, _jax(gp, jt.GroupingParams))
    _assert_fams_equal(fams, jfams)
    jcp = _jax(cp, jt.ConsensusParams)
    ss = oracle.call_consensus(batch, fams, dataclasses.replace(cp, mode="single_strand"))
    jss = jax_oracle.call_consensus(jb, jfams, dataclasses.replace(jcp, mode="single_strand"))
    cap = oracle.fit_cycle_error_model(batch, fams, ss)
    np.testing.assert_array_equal(cap, jax_oracle.fit_cycle_error_model(jb, jfams, jss))
    q2 = oracle.apply_cycle_error_model(np.asarray(batch.quals), cap)
    np.testing.assert_array_equal(q2, jax_oracle.apply_cycle_error_model(batch.quals, cap))
    out = oracle.call_consensus(batch, fams, cp, quals_override=q2)
    jout = jax_oracle.call_consensus(jb, jfams, jcp, quals_override=q2)
    for f in ("bases", "quals", "depth", "valid", "err"):
        np.testing.assert_array_equal(np.asarray(getattr(out, f)),
                                      np.asarray(getattr(jout, f)), err_msg=f)


@pytest.mark.parametrize("backend", ["cpu", "cuda"])
@pytest.mark.parametrize("strategy, paired, mate_aware", GROUPINGS, ids=GROUPING_IDS)
def test_umi_grouper_equals_jax(backend, strategy, paired, mate_aware):
    batch = _batch(mate_aware)
    gp = GroupingParams(strategy, paired=paired, mate_aware=mate_aware)
    ours = UmiGrouper(gp, backend=backend, device="cpu")(batch)
    theirs = JaxGrouper(_jax(gp, jt.GroupingParams),
                        backend="cpu" if backend == "cpu" else "tpu")(_jax(batch, jt.ReadBatch))
    _assert_fams_equal(ours, theirs)
    if backend == "cuda":
        # and the device path equals the oracle's partition numbering
        _assert_fams_equal(ours, UmiGrouper(gp, backend="cpu")(batch))


def _parity(a, b, duplex: bool) -> int:
    """ConsensusBatch a (port) against b (JAX) at the parity bar; returns
    the tie cycles."""
    np.testing.assert_array_equal(np.asarray(a.valid), np.asarray(b.valid))
    np.testing.assert_array_equal(np.asarray(a.depth), np.asarray(b.depth))
    sa, sb = np.asarray(a.bases), np.asarray(b.bases)
    qa, qb = np.asarray(a.quals).astype(int), np.asarray(b.quals).astype(int)
    tol = 2 if duplex else 1
    dq = np.abs(qa - qb)
    tie = (((sa != sb) & (qa <= max(TIE_QUAL, NO_CALL_QUAL)) & (qb <= max(TIE_QUAL, NO_CALL_QUAL)))
           | ((sa == sb) & (dq > tol) & (dq <= 2 * TIE_QUAL + tol) & duplex))
    assert not ((sa != sb) & ~tie).any(), "bases differ outside a tie"
    assert (np.where(tie, 0, dq) <= tol).all()
    assert tie.sum() * 100 <= sa.size
    return int(tie.sum())


@pytest.mark.parametrize("backend", ["cpu", "cuda"])
@pytest.mark.parametrize("name", list(CALLS))
def test_consensus_caller_equals_jax(backend, name):
    gp, cp = CALLS[name]
    batch = _batch(gp.mate_aware)
    jb = _jax(batch, jt.ReadBatch)
    fams = UmiGrouper(gp, backend="cpu")(batch)
    jfams = _jax(fams, jt.FamilyAssignment)
    ours = ConsensusCaller(cp, backend=backend, device="cpu")(batch, fams)
    theirs = JaxCaller(_jax(cp, jt.ConsensusParams),
                       backend="cpu" if backend == "cpu" else "tpu")(jb, jfams)
    assert np.asarray(ours.valid).any()
    if backend == "cpu":
        for f in ("bases", "quals", "depth", "valid", "err"):
            np.testing.assert_array_equal(np.asarray(getattr(ours, f)),
                                          np.asarray(getattr(theirs, f)), err_msg=f)
    else:
        _parity(ours, theirs, cp.mode == "duplex")
        # and against the oracle, whose f64 math neither f32 side matches
        # bit for bit: the same bar
        _parity(ours, ConsensusCaller(cp, backend="cpu")(batch, fams), cp.mode == "duplex")


@pytest.mark.parametrize("method, calls", [("segment_gemm", 2), ("matmul", 0)])
def test_cuda_caller_reaches_segment_gemm(monkeypatch, method, calls):
    """Both ssc passes of the cycle model reduce through segment_gemm (the
    kernel on a card, its plain version here) unless another method is
    asked for; the methods agree."""
    seen = []
    inner = kcons.segment_gemm

    def counting(big, fid, f_max):
        seen.append(tuple(big.shape))
        return inner(big, fid, f_max)

    monkeypatch.setattr(kcons, "segment_gemm", counting)
    gp, cp = CALLS["config5"]
    batch = _batch(False)
    fams = UmiGrouper(gp, backend="cpu")(batch)
    out = ConsensusCaller(cp, backend="cuda", method=method, device="cpu")(batch, fams)
    assert len(seen) == calls
    if calls:
        l = batch.read_len
        # the fit pass drops the depth columns: 4L + 1, then 5L + 1
        assert [s[-1] for s in seen] == [4 * l + 1, 5 * l + 1]
        ref = ConsensusCaller(cp, backend="cuda", method="segment", device="cpu")(batch, fams)
        for f in ("bases", "quals", "depth", "valid"):
            np.testing.assert_array_equal(getattr(out, f), getattr(ref, f), err_msg=f)


def test_grouper_refuses_tables_over_2048():
    rng = np.random.default_rng(0)
    n, u = 2100, 12
    codes = rng.integers(0, 4, (n, u)).astype(np.uint8)
    codes[:, :6] = np.stack([(np.arange(n) >> (2 * k)) & 3 for k in range(6)], 1)  # all unique
    batch = dataclasses.replace(
        _batch(False), bases=np.zeros((n, 4), np.uint8), quals=np.full((n, 4), 30, np.uint8),
        umi=codes, pos_key=np.zeros(n, np.int64), strand_ab=np.ones(n, bool),
        frag_end=np.zeros(n, bool), valid=np.ones(n, bool),
    )
    with pytest.raises(ValueError, match=r"4096 .*2048.*group --capacity"):
        UmiGrouper(GroupingParams("adjacency"), device="cpu")(batch)
    # exact grouping keeps no directional key: no limit
    fams = UmiGrouper(GroupingParams("exact"), device="cpu")(batch)
    assert int(fams.n_families) == n


def test_default_backend_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gp, cp = CALLS["config5"]
    batch = _batch(False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        UmiGrouper(gp)(batch)
    fams = UmiGrouper(gp, backend="cpu")(batch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ConsensusCaller(cp)(batch, fams)
    assert np.asarray(ConsensusCaller(cp, backend="cpu")(batch, fams).valid).any()
    for cls in (UmiGrouper, ConsensusCaller):
        with pytest.raises(ValueError, match="unknown backend 'tpu'"):
            cls(backend="tpu")
    with pytest.raises(ValueError, match="unknown ssc method"):
        ConsensusCaller(method="blockseg")


@pytest.mark.cuda
def test_operators_on_the_card_match_the_cpu(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: segment_gemm has no CPU mode")
    from duplexumiconsensusreads_torch.kernels import segment_gemm as sg

    gp, cp = CALLS["config5"]
    batch = _batch(False)
    fams = UmiGrouper(gp, device="cuda")(batch)
    _assert_fams_equal(fams, UmiGrouper(gp, device="cpu")(batch))
    sg.segment_gemm.launches = 0
    out = ConsensusCaller(cp, device="cuda")(batch, fams)
    assert sg.segment_gemm.launches == 2
    _parity(out, ConsensusCaller(cp, device="cpu")(batch, fams), duplex=True)
