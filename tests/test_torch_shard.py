"""The port's scatter-gather sharding (serve/shard/) against the JAX
package's and against its own unsharded run.

- Plans: ``plan_shards`` cuts the JAX package's ``ShardRange`` list at
  K in {1, 2, 3, 4, 7, 20} (and by ``shard_bytes``), on a plain input
  and on a two-contig, unevenly covered input with an unmapped tail;
  ``child_spec_dicts`` writes the JAX sub-job specs.
- Bytes: a job submitted with ``shards=K`` and run by the CPU service
  merges into a BAM and .bai byte-identical to the unsharded port run
  with ``serve_provenance``, at every K above; also when two daemons
  share the work, when the daemon running a shard dies mid-slice, and
  under ``DUT_NO_NATIVE=1``.
"""

from __future__ import annotations

import dataclasses
import os
import threading

import numpy as np
import pytest

from duplexumiconsensusreads_tpu.io import simulated_bam
from duplexumiconsensusreads_tpu.serve.job import validate_spec as jax_validate
from duplexumiconsensusreads_tpu.serve.shard.plan import child_spec_dicts as jax_children
from duplexumiconsensusreads_tpu.serve.shard.plan import plan_shards as jax_plan_shards
from duplexumiconsensusreads_tpu.simulate import SimConfig
from duplexumiconsensusreads_torch.cli.main import main as cli_main
from duplexumiconsensusreads_torch.runtime import faults
from duplexumiconsensusreads_torch.runtime.stream import stream_call_consensus
from duplexumiconsensusreads_torch.serve import ConsensusService, client
from duplexumiconsensusreads_torch.serve.job import job_params, serve_provenance, validate_spec
from duplexumiconsensusreads_torch.serve.shard.plan import child_spec_dicts, plan_shards

CONFIG = dict(grouping="adjacency", mode="duplex", capacity=128, chunk_reads=120,
              write_index=True)
KS = (1, 2, 3, 4, 7, 20)


@pytest.fixture(scope="module")
def sim(tmp_path_factory):
    """(input, unsharded bytes, unsharded .bai) of the port's one-shot
    stream with the job's provenance line."""
    d = tmp_path_factory.mktemp("torch_shard")
    path = str(d / "in.bam")
    simulated_bam(SimConfig(n_molecules=110, read_len=48, n_positions=20, umi_error=0.02,
                            seed=41), path=path, sort=True)
    ref = str(d / "ref.bam")
    rep = _one_shot(path, ref)
    assert rep.n_chunks >= 7
    return path, _read(ref), _read(ref + ".bai")


def _one_shot(path, out):
    spec = validate_spec({"job_id": "ref", "input": path, "output": out, "config": CONFIG})
    gp, cp, kw = job_params(spec)
    kw.pop("mesh")
    return stream_call_consensus(path, out, gp, cp, device="cpu",
                                 provenance_cl=serve_provenance(CONFIG), **kw)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(autouse=True)
def _clean_faults():
    yield
    faults.uninstall()


@pytest.fixture(scope="module")
def multi_contig(tmp_path_factory):
    """Two contigs, uneven coverage and an unmapped sentinel tail (the
    JAX planner suite's input): the planner must tile it exactly."""
    from duplexumiconsensusreads_tpu.io.bam import FLAG_UNMAPPED, BamHeader, write_bam
    from duplexumiconsensusreads_tpu.io.convert import readbatch_to_records
    from duplexumiconsensusreads_tpu.simulate import simulate_batch

    d = tmp_path_factory.mktemp("torch_shard_plan")
    batch, _ = simulate_batch(SimConfig(n_molecules=90, n_positions=6, umi_error=0.02,
                                        read_len=48, seed=77))
    batch = batch.take(np.argsort(np.asarray(batch.pos_key), kind="stable"))
    recs = readbatch_to_records(batch, duplex=True)
    pos = np.asarray(recs.pos)
    ref_id = np.asarray(recs.ref_id)
    ref_id[pos >= int(np.median(pos))] = 1
    flags = np.asarray(recs.flags)
    n = len(flags)
    unm = slice(n - max(n // 12, 1), n)
    ref_id[unm] = -1
    flags[unm] |= FLAG_UNMAPPED
    header = BamHeader.synthetic(ref_names=("chr1", "chr2"), ref_lengths=(10_000_000,) * 2,
                                 sort_order="coordinate")
    path = str(d / "multi.bam")
    write_bam(path, header, recs)
    return path


def _plans_equal(ours, theirs):
    assert [dataclasses.asdict(r) for r in ours.ranges] == \
        [dataclasses.asdict(r) for r in theirs.ranges]
    for f in ("input", "chunk_reads", "n_chunks", "n_records", "mate_aware"):
        assert getattr(ours, f) == getattr(theirs, f), f


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("which", ["sim", "multi_contig"])
def test_plan_shards_equals_jax(sim, multi_contig, which, k):
    path = sim[0] if which == "sim" else multi_contig
    ours = plan_shards(path, CONFIG["chunk_reads"], duplex=True, n_shards=k)
    theirs = jax_plan_shards(path, CONFIG["chunk_reads"], duplex=True, n_shards=k)
    _plans_equal(ours, theirs)
    assert sum(r.n_records for r in ours.ranges) == ours.n_records
    assert sum(r.n_chunks for r in ours.ranges) == ours.n_chunks


@pytest.mark.parametrize("shard_bytes", [1 << 12, 1 << 14, 1 << 30])
def test_plan_by_bytes_and_child_specs_equal_jax(sim, shard_bytes):
    path = sim[0]
    ours = plan_shards(path, CONFIG["chunk_reads"], duplex=True, shard_bytes=shard_bytes,
                       max_shards=5)
    theirs = jax_plan_shards(path, CONFIG["chunk_reads"], duplex=True,
                             shard_bytes=shard_bytes, max_shards=5)
    _plans_equal(ours, theirs)
    parent = {"job_id": "job-p", "input": path, "output": "/o.bam", "config": CONFIG,
              "shard_bytes": shard_bytes, "chaos": "shard.write:3:oserror",
              "trace": "/t.jsonl", "deadline_s": 60.0}
    assert child_spec_dicts(validate_spec(parent), ours) == jax_children(
        jax_validate(parent), theirs)
    with pytest.raises(ValueError, match="exactly one"):
        plan_shards(path, 120, duplex=True)


def _run_sharded(spool, path, out, k, n_daemons=1):
    jid = client.submit(spool, path, out, config=dict(CONFIG), shards=k)
    svcs = [ConsensusService(spool, device="cpu", chunk_budget=2, poll_s=0.02,
                             daemon_id=f"sh-{i}") for i in range(n_daemons)]
    if n_daemons == 1:
        snaps = [svcs[0].run_until_idle()]
    else:
        snaps = [None] * n_daemons

        def run(i):
            snaps[i] = svcs[i].run_until_idle()

        threads = [threading.Thread(target=run, args=(i,), daemon=True)
                   for i in range(n_daemons)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
    return jid, snaps


@pytest.mark.parametrize("k", KS)
def test_merged_output_and_index_equal_the_unsharded_run(sim, tmp_path, k):
    path, ref_bytes, ref_bai = sim
    spool = str(tmp_path / "spool")
    out = str(tmp_path / "merged.bam")
    jid, (snap,) = _run_sharded(spool, path, out, k)
    assert snap["jobs_split"] == 1 and snap["jobs_merged"] == 1 and snap["jobs_failed"] == 0
    st = client.status(spool, jid)
    plan = plan_shards(path, CONFIG["chunk_reads"], duplex=True, n_shards=k)
    assert st["state"] == "done" and st["shards"]["done"] == len(plan.ranges)
    assert st["result"]["sharded"]["n_shards"] == len(plan.ranges)
    assert _read(out) == ref_bytes
    assert _read(out + ".bai") == ref_bai
    assert not [p for p in os.listdir(tmp_path) if ".shard" in p]


def test_two_daemons_share_the_shards_byte_identical(sim, tmp_path):
    path, ref_bytes, ref_bai = sim
    spool = str(tmp_path / "spool")
    out = str(tmp_path / "merged.bam")
    jid, snaps = _run_sharded(spool, path, out, 4, n_daemons=2)
    assert sum(s["jobs_split"] for s in snaps) == 1
    assert sum(s["jobs_merged"] for s in snaps) == 1
    assert sum(s["jobs_done"] for s in snaps) == 5  # 4 shards + the parent
    assert client.status(spool, jid)["state"] == "done"
    assert (_read(out), _read(out + ".bai")) == (ref_bytes, ref_bai)


def test_mid_shard_daemon_death_is_taken_over_byte_identical(sim, tmp_path):
    """The daemon running a shard dies after its first fresh chunk commit
    (the modelled SIGKILL: its lease stays journaled); a second daemon
    takes the shard over, resumes its checkpoint, runs the rest and the
    merge — byte-identical, each job completed once."""
    path, ref_bytes, ref_bai = sim
    spool = str(tmp_path / "spool")
    out = str(tmp_path / "merged.bam")
    jid = client.submit(spool, path, out, config=dict(CONFIG), shards=3)
    victim = ConsensusService(spool, device="cpu", chunk_budget=0, poll_s=0.02,
                              daemon_id="victim")
    orig = victim.worker.run_slice

    def dying(spec, budget, should_yield, drain_event, lease=None):
        if spec.shard is None:
            return orig(spec, budget, should_yield, drain_event, lease=lease)

        def die():
            raise faults.InjectedKill("mid-shard daemon death")

        return orig(spec, 1, die, drain_event, lease=lease)

    victim.worker.run_slice = dying
    with pytest.raises(faults.InjectedKill):
        victim.run_until_idle()
    snap = ConsensusService(spool, device="cpu", poll_s=0.02,
                            daemon_id="rescuer").run_until_idle()
    assert snap["jobs_recovered"] >= 1 and snap["jobs_merged"] == 1
    st = client.status(spool, jid)
    assert st["state"] == "done"
    assert (_read(out), _read(out + ".bai")) == (ref_bytes, ref_bai)


def test_sharding_without_native_matches_the_unsharded_run(sim, tmp_path, monkeypatch):
    """Under DUT_NO_NATIVE=1 the shards run the portable iterator, which
    ignores the seek and the first-read realignment and filters the
    whole-file chunks instead: the merge still equals the unsharded
    portable run (both deflate with the Python codec)."""
    path, _, _ = sim
    monkeypatch.setenv("DUT_NO_NATIVE", "1")
    ref = str(tmp_path / "ref.bam")
    _one_shot(path, ref)
    out = str(tmp_path / "merged.bam")
    jid, _ = _run_sharded(str(tmp_path / "spool"), path, out, 3)
    assert client.status(str(tmp_path / "spool"), jid)["state"] == "done"
    assert (_read(out), _read(out + ".bai")) == (_read(ref), _read(ref + ".bai"))


def test_cli_submit_shards_round_trips(sim, tmp_path, capsys):
    path, ref_bytes, ref_bai = sim
    spool = str(tmp_path / "spool")
    out = str(tmp_path / "cli.bam")
    assert cli_main(["call", path, "-o", out, "--submit", "--spool", spool, "--grouping",
                     "adjacency", "--mode", "duplex", "--capacity", "128", "--chunk-reads",
                     "120", "--write-index", "--shards", "2"]) == 0
    jid = capsys.readouterr().out.strip()
    ConsensusService(spool, device="cpu", poll_s=0.02).run_until_idle()
    assert cli_main(["call", "--wait", jid, "--spool", spool, "--wait-timeout", "5",
                     "--json"]) == 0
    assert '"done"' in capsys.readouterr().out
    assert (_read(out), _read(out + ".bai")) == (ref_bytes, ref_bai)
