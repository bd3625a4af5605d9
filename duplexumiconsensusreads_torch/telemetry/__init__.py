"""Per-chunk tracing + live telemetry for the streaming executor.

`trace` is the recording side (span recorder, structured events, the
byte-ledger `xfer` records, the device-ledger `dev` records, the
heartbeat thread), copied from the JAX package with the same record
schema, so a capture of either engine reads the same. It imports only
the stdlib so `runtime/faults.py` and `io/durable.py` can hook into it
without an import cycle. The offline analysis side (report, ledger,
devledger, chrome, device) is not ported yet.
"""

from duplexumiconsensusreads_torch.telemetry.trace import (
    KNOWN_DEV_FIELDS,
    KNOWN_EVENTS,
    KNOWN_STAGES,
    KNOWN_XFER_DIRS,
    Heartbeat,
    TraceRecorder,
    emit_event,
    get_active,
    install,
    uninstall,
)

__all__ = [
    "KNOWN_DEV_FIELDS",
    "KNOWN_EVENTS",
    "KNOWN_STAGES",
    "KNOWN_XFER_DIRS",
    "Heartbeat",
    "TraceRecorder",
    "emit_event",
    "get_active",
    "install",
    "uninstall",
]
