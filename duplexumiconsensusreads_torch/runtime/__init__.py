"""runtime/: the whole-file and streaming executors and their registries.

``RunReport``, ``call_batch`` and ``call_consensus_file`` resolve lazily
(PEP 562), so importing ``runtime.knobs`` or ``runtime.faults`` (the
serving client does, on every ``call --submit/--status/--wait``) does
not import the executor stack."""

_LAZY = ("RunReport", "call_batch", "call_consensus_file")

__all__ = list(_LAZY)


def __getattr__(name: str):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    from duplexumiconsensusreads_torch.runtime import executor

    return getattr(executor, name)
