"""serve/shard/ — scatter-gather job sharding.

The JAX package's serve/shard/, copied with the imports rewritten.

The consensus pipeline is embarrassingly parallel across genomic
ranges, but a job submitted to the service runs as one serial stream on
one daemon. This package turns N daemons into N-way parallelism on ONE
large input, with the headline contract that the merged output is
byte-identical to the same job run unsharded:

  PLANNER (plan.py)   a job submitted with ``shards=K`` (or
                      ``shard_bytes``) is claimed like any job; the
                      claiming daemon scans the input's chunk grid —
                      the exact boundaries the unsharded run would use
                      — and registers K range sub-jobs in one durable
                      journal transaction (fault site ``serve.split``,
                      fenced: a kill mid-plan re-plans idempotently,
                      sub-job ids derived from (parent_id, shard_idx)).
  FAN-OUT             sub-jobs are ordinary journal entries: they flow
                      through the unchanged queue/scheduler/lease/
                      fence/watchdog path, so every daemon claims,
                      runs, preempts, resumes, takes over and
                      quarantines them exactly like whole jobs. The
                      parent is a journaled aggregate state machine
                      (queued → splitting → fanned → merging →
                      done/failed) riding the same flock'd txn
                      protocol.
  MERGER (merge.py)   when the last sub-job publishes, the parent is
                      requeued as a merge task any daemon can claim
                      (same lease protocol, fault site ``serve.merge``)
                      and the per-shard BGZF outputs are spliced in
                      shard order — one header, the shard record
                      members verbatim, one EOF block — then the BAI/
                      CSI index is rebuilt over the merged output.

Byte identity holds because consensus record names embed the global
chunk index: the planner aligns every shard to whole-file chunk
boundaries (``chunk_base`` + ``first_read`` realign the raw-read grid,
see plan.py), so each shard output's record members are the unsharded
run's members for those chunks, verbatim.
"""

_LAZY = {
    "ShardPlan": "duplexumiconsensusreads_torch.serve.shard.plan",
    "ShardRange": "duplexumiconsensusreads_torch.serve.shard.plan",
    "plan_shards": "duplexumiconsensusreads_torch.serve.shard.plan",
    "child_job_id": "duplexumiconsensusreads_torch.serve.shard.plan",
    "shard_output_path": "duplexumiconsensusreads_torch.serve.shard.plan",
    "splice_shards": "duplexumiconsensusreads_torch.serve.shard.merge",
}

__all__ = sorted(_LAZY)


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(mod), name)
