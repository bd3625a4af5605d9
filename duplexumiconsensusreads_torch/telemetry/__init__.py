"""Per-chunk tracing + live telemetry for the streaming executor.

`trace` is the recording side (span recorder, structured events, the
byte-ledger `xfer` records, the device-ledger `dev` records, the
heartbeat thread), with the JAX package's record schema, so a capture
of either engine reads the same; `chrome` exports a capture as Chrome
trace events (opens in Perfetto / chrome://tracing); `report` is the
offline analysis side (schema validation, per-lane utilization,
per-stage percentiles, per-chunk critical path, the sum-check against
`RunReport.seconds`); `ledger` is the byte twin (per-chunk byte
totals, measured bandwidth, the wire-floor model, the byte sum-checks
`tools/wirestat.py` enforces); `devledger` is the device twin
(per-class FLOPs/MFU/arithmetic intensity, the roofline verdicts, the
dev-interval sum-checks `tools/devstat.py` enforces); `device` is the
peak-FLOP/s table of the CUDA cards every MFU consumer resolves
through; `steps` is the step clock (device spans the compiled step
records itself, by class, lane and stage); `fleet` is the fleet flight
recorder (N daemons' service captures stitched into per-job
cross-daemon timelines with an exact sum-check, fleet metrics, SLO
gates; `tools/fleet_report.py` is its CLI). The analysers read files
only and never need a device. The recording side imports only the
stdlib so `runtime/faults.py` and `io/durable.py` can hook into it
without an import cycle.
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
