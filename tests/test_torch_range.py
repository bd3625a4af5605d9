"""The port's range mode (``iter_batch_chunks`` with start / key_lo /
key_hi / first_read, and the stream's input_range / chunk_base /
first_read) against the JAX package's.

- Chunks: on every range of a shard plan at K in {2, 3, 4, 7}, the
  port's iterator yields the JAX iterator's chunks, array for array and
  info for info — natively and under ``DUT_NO_NATIVE=1``, where both
  packages' portable iterators ignore ``start`` and ``first_read`` and
  filter the whole-file chunks instead.
- Fingerprint: the key the port hashes is the JAX key (range fields
  included) plus the engine tag, for plain, ranged and shard runs.
- Stream: a ranged port run agrees with the JAX ranged run record by
  record at the parity bar, counters equal.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest

from duplexumiconsensusreads_tpu.io import read_bam as jax_read_bam
from duplexumiconsensusreads_tpu.io import simulated_bam
from duplexumiconsensusreads_tpu.runtime import stream as jax_stream_mod
from duplexumiconsensusreads_tpu.serve.shard.plan import plan_shards as jax_plan_shards
from duplexumiconsensusreads_tpu.simulate import SimConfig
from duplexumiconsensusreads_tpu.types import ConsensusParams as JC
from duplexumiconsensusreads_tpu.types import GroupingParams as JG
from duplexumiconsensusreads_torch.cli.main import params_for
from duplexumiconsensusreads_torch.io import read_bam
from duplexumiconsensusreads_torch.runtime import stream
from duplexumiconsensusreads_torch.serve.shard.plan import plan_shards

from test_torch_stream import _compare

CHUNK = 120


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_range")
    out = {}
    for name, paired in (("single", False), ("mates", True)):
        p = str(d / f"{name}.bam")
        simulated_bam(SimConfig(n_molecules=150, read_len=48, n_positions=24, umi_error=0.01,
                                duplex=True, paired_reads=paired, seed=23),
                      path=p, sort=True)
        out[name] = p
    return d, out


def _ranges(path, k):
    plan = jax_plan_shards(path, CHUNK, duplex=True, n_shards=k)
    return [(r.start, r.key_lo, r.key_hi, r.first_read) for r in plan.ranges]


def _chunks(fn, path, rng, **kw):
    start, lo, hi, first = rng
    return list(fn(path, CHUNK, True, start=start, key_lo=lo, key_hi=hi,
                   first_read=first, warn_mixed=False, **kw))


def _assert_same_chunks(ours, theirs):
    assert len(ours) == len(theirs) > 0
    for (_, ob, oi), (_, jb, ji) in zip(ours, theirs):
        for f in dataclasses.fields(jb):
            np.testing.assert_array_equal(np.asarray(getattr(ob, f.name)),
                                          np.asarray(getattr(jb, f.name)), err_msg=f.name)
        assert {k: v for k, v in oi.items() if k != "native"} == \
            {k: v for k, v in ji.items() if k != "native"}


@pytest.mark.parametrize("which", ["single", "mates"])
@pytest.mark.parametrize("k", [2, 3, 4, 7])
def test_range_chunks_equal_jax(inputs, which, k):
    _, paths = inputs
    ranges = _ranges(paths[which], k)
    assert len(ranges) == k
    total = 0
    for rng in ranges:
        ours = _chunks(stream.iter_batch_chunks, paths[which], rng)
        _assert_same_chunks(ours, _chunks(jax_stream_mod.iter_batch_chunks,
                                          paths[which], rng))
        total += sum(int(np.asarray(b.valid).size) for _, b, _ in ours)
    whole = list(stream.iter_batch_chunks(paths[which], CHUNK, True))
    assert total == sum(int(np.asarray(b.valid).size) for _, b, _ in whole)


@pytest.mark.parametrize("k", [3, 7])
def test_range_chunks_equal_jax_without_native(inputs, monkeypatch, k):
    """Both portable iterators ignore start and first_read and filter
    the whole-file chunks by key: the port's yields the JAX chunks."""
    _, paths = inputs
    ranges = _ranges(paths["mates"], k)
    monkeypatch.setenv("DUT_NO_NATIVE", "1")
    for rng in ranges:
        ours = _chunks(stream.iter_batch_chunks, paths["mates"], rng)
        assert not any(i.get("native") for _, _, i in ours)
        _assert_same_chunks(ours, _chunks(jax_stream_mod.iter_batch_chunks,
                                          paths["mates"], rng))


def test_port_plan_cuts_the_same_ranges(inputs):
    _, paths = inputs
    ours = plan_shards(paths["mates"], CHUNK, duplex=True, n_shards=4)
    theirs = jax_plan_shards(paths["mates"], CHUNK, duplex=True, n_shards=4)
    assert [dataclasses.asdict(r) for r in ours.ranges] == \
        [dataclasses.asdict(r) for r in theirs.ranges]


def _fingerprint_key(mod, monkeypatch, *args, **kw):
    seen = []
    real = json.dumps

    def spy(obj, **k):
        seen.append(obj)
        return real(obj, **k)

    monkeypatch.setattr(mod.json, "dumps", spy)
    try:
        mod._fingerprint(*args, **kw)
    finally:
        monkeypatch.setattr(mod.json, "dumps", real)
    return seen[-1]


@pytest.mark.parametrize("kw", [
    {},
    dict(input_range=((1234, 56), 7, 9)),
    dict(input_range=((1234, 56), 7, None), chunk_base=3, first_read=41),
    dict(chunk_base=2),
    dict(stat_sig="00ff00ff00ff00ff"),
], ids=["plain", "range", "shard", "chunk_base", "live"])
@pytest.mark.parametrize("no_native", [False, True])
def test_fingerprint_key_is_the_jax_key_plus_the_engine(inputs, monkeypatch, kw, no_native):
    _, paths = inputs
    if no_native:
        monkeypatch.setenv("DUT_NO_NATIVE", "1")
    gp, cp, _ = params_for("config5")
    args = (paths["single"], gp, cp, 128, CHUNK)
    jargs = (paths["single"], JG(**vars(gp)), JC(**vars(cp)), 128, CHUNK)
    ours = _fingerprint_key(stream, monkeypatch, *args, **kw)
    theirs = _fingerprint_key(jax_stream_mod, monkeypatch, *jargs, **kw)
    assert stream.ENGINE in ours
    assert [x for x in ours if x != stream.ENGINE] == theirs
    if "input_range" in kw:
        assert ("python" if no_native else "native") in ours


def test_ranged_stream_matches_jax(inputs, tmp_path):
    """One middle shard of a K=3 plan through both engines' streams."""
    _, paths = inputs
    plan = jax_plan_shards(paths["mates"], CHUNK, duplex=True, n_shards=3)
    r = plan.ranges[1]
    gp, cp, _ = params_for("config3")
    kw = dict(input_range=(r.start, r.key_lo, r.key_hi), chunk_base=r.chunk_base,
              first_read=r.first_read, mate_aware=plan.mate_aware, capacity=128,
              chunk_reads=CHUNK)
    jout, tout = str(tmp_path / "j.bam"), str(tmp_path / "t.bam")
    jrep = jax_stream_mod.stream_call_consensus(paths["mates"], jout, JG(**vars(gp)),
                                                JC(**vars(cp)), n_devices=1, **kw)
    trep = stream.stream_call_consensus(paths["mates"], tout, gp, cp, device="cpu", **kw)
    for f in ("n_records", "n_valid_reads", "n_chunks", "n_buckets", "n_families",
              "n_consensus", "n_consensus_pairs", "mate_aware"):
        assert getattr(trep, f) == getattr(jrep, f), f
    assert trep.n_chunks == r.n_chunks and trep.n_records == r.n_records
    jr, tr = jax_read_bam(jout)[1], read_bam(tout)[1]
    _compare(jr, tr, duplex=True)
    # consensus names carry the whole-file chunk index
    assert tr.names[0].startswith(f"cons{r.chunk_base}")
