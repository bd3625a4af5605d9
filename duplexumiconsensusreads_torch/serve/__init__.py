"""serve/ — the multi-job consensus service.

One warm process multiplexes many consensus jobs onto its devices:

  client (``call --submit`` / serve.client) durably spools a job file
  into ``<spool>/inbox/`` → the daemon (``dut-serve`` / serve.service)
  ADMITS it into a bounded, durably-journaled queue (serve.queue;
  io.durable tmp+fsync+rename, so a killed daemon loses no accepted
  job) → a FAIR SCHEDULER (serve.scheduler: FIFO within priority
  class, per-job chunk budget) hands it to a WARM WORKER (serve.worker)
  that runs it as a ``stream_call_consensus`` slice on the daemon's
  card, reusing the process's loaded kernel libraries, CUDA context and
  warm caching allocator — paid once for the daemon's lifetime instead
  of once per job.

Preemption is free by construction: a job yields the device only at a
chunk boundary, where the streaming executor's checkpoint/resume
contract already guarantees a later slice converges to the
byte-identical output. SIGTERM triggers graceful drain: finish the
in-flight chunk, checkpoint, journal the queue, exit 0; a restarted
daemon resumes both the queue and the interrupted job.

A FLEET is N daemons on one spool: every journal mutation is a flock'd
transaction, each job runs under exactly one daemon's durable LEASE
(fencing token + monotonic expiry, renewed per chunk commit and per
heartbeat), dead daemons' jobs are taken over and resumed from their
checkpoints, zombies are fenced off before they can write a byte, and
overload sheds by per-class policy with queue-wait / time-to-first-
chunk percentiles in ``metrics.json`` (see ARCHITECTURE.md "Fleet &
leases").

Attribute access is lazy (PEP 562): the CLIENT side
(``serve.client``/``serve.queue``, behind ``call --submit/--status/
--wait``) must stay importable without dragging in the executor stack
on every submit or status poll, and never initialises CUDA; only the
daemon-side classes (``ConsensusService``) pay that import.

The JAX package's serve/, ported to one CUDA card per daemon: the
spool, journal, lease, scheduler and shard protocols are copied with
the imports rewritten, so a spool is the same format for both engines
(a job's checkpoint fingerprint names the engine, so neither resumes
the other's chunks). What the card changed is written in
``service.py``, ``worker.py`` and ``daemon.py``.
"""

_LAZY = {
    "ConsensusService": "duplexumiconsensusreads_torch.serve.service",
    "FairScheduler": "duplexumiconsensusreads_torch.serve.scheduler",
    "JobSpec": "duplexumiconsensusreads_torch.serve.job",
    "SpoolQueue": "duplexumiconsensusreads_torch.serve.queue",
    "job_params": "duplexumiconsensusreads_torch.serve.job",
}

__all__ = sorted(_LAZY)


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(mod), name)
