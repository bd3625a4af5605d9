"""The program's step clock (``telemetry/steps.py``), read once after
the window's synchronize: the stream time of each stage of the
replayed steps, a million reads, and the share of the replayed calls'
spans that the stage marks cover. Nothing where the program has no
step clock (an older checkout), no replayed step, or a replayed class
without a stage sample."""

from __future__ import annotations


def readout(ctx) -> dict | None:
    """The program's read-out, read once a run (None without a clock)."""
    if "step_clock" not in ctx.state:
        try:
            from duplexumiconsensusreads_torch.telemetry import steps
        except ImportError:
            ctx.state["step_clock"] = None
        else:
            ctx.state["step_clock"] = steps.read()
    return ctx.state["step_clock"]


def replayed(ctx) -> list[dict] | None:
    """The replayed step entries, each class with a stage sample; None
    where there is none, or a class has no sample."""
    out = readout(ctx)
    if not out:
        return None
    rows = [e for e in out["calls"] if e["kind"] == "step" and e["mode"] == "replayed"]
    if not rows or any(e["samples"] == 0 for e in rows):
        return None
    return rows


def ms_per_mread(ctx, stage: str) -> float | None:
    """``stage``'s stream milliseconds a million reads: each class's
    stage seconds a sampled replay, times its replays, summed, over the
    reads those replays covered (``pass_reads`` times the replays of a
    class: replayed calls over the calls a pass makes)."""
    rows = replayed(ctx)
    if rows is None or not any(stage in e["stage_s"] for e in rows):
        return None
    classes, mesh = ctx.state.get("classes"), ctx.state.get("mesh")
    reads = ctx.state.get("pass_reads")
    if not classes or mesh is None or not reads:
        return None
    passes = sum(e["calls"] for e in rows) / (len(classes) * mesh.size)
    seconds = sum(e["stage_s"].get(stage, 0.0) / e["samples"] * e["calls"] for e in rows)
    return seconds * 1e3 / (passes * reads / 1e6)


def coverage(ctx) -> float | None:
    """The sampled replays' first-to-last-mark seconds over their call
    spans: what is left is input binding, launch and the span's own
    events."""
    rows = replayed(ctx)
    if rows is None:
        return None
    span = sum(e["marked_span_s"] for e in rows)
    return sum(e["marked_s"] for e in rows) / span if span > 0 else None
