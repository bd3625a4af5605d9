"""The device trace of a window: ``torch.profiler`` with CPU and CUDA
activities around the window, reduced to device intervals, kernel
times by name, and the idle gaps with what the host was doing."""

from __future__ import annotations

import contextlib
import time


class Trace:
    """What a traced window leaves for the metric readers."""

    def __init__(self):
        self.window_s = 0.0
        self.intervals: list[tuple[int, int]] = []  # merged device-busy [start, end) ns
        self.busy_s = 0.0
        self.kernels: dict[str, list[float]] = {}  # device op name -> durations (s)
        self.idle_gaps: list[list] = []
        self.t0_ns = self.t1_ns = 0

    def kernel_seconds(self, needle: str) -> tuple[float, int]:
        """(total seconds, launches) of the device ops whose name holds
        ``needle``."""
        ts = [d for name, ds in self.kernels.items() if needle in name for d in ds]
        return sum(ts), len(ts)

    def breakdown(self) -> dict:
        ops = sorted(((n, sum(d)) for n, d in self.kernels.items()), key=lambda x: -x[1])
        return {"device_ops": [[n[:160], s] for n, s in ops[:10]],
                "idle_gaps": self.idle_gaps[:10]}


def _merge(iv: list[tuple[int, int]]) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _reduce(events, tr: Trace) -> None:
    from torch.autograd import DeviceType

    dev, cpu = [], []
    for e in events:
        s, en = e.start_ns(), e.end_ns()
        if e.device_type() == DeviceType.CUDA:
            dev.append((s, en))
            tr.kernels.setdefault(e.name(), []).append((en - s) * 1e-9)
        else:
            cpu.append((s, en, e.name()))
    tr.intervals = _merge(dev)
    tr.busy_s = sum(e - s for s, e in tr.intervals) * 1e-9
    if not tr.intervals:
        return
    lo = min(s for s, _ in tr.intervals)
    t0 = min([lo] + [s for s, _, _ in cpu])
    t1 = max([tr.intervals[-1][1]] + [e for _, e, _ in cpu])
    tr.t0_ns, tr.t1_ns = t0, t1
    gaps = [(t0, tr.intervals[0][0])]
    gaps += [(a[1], b[0]) for a, b in zip(tr.intervals, tr.intervals[1:])]
    gaps.append((tr.intervals[-1][1], t1))
    gaps = sorted((g for g in gaps if g[1] > g[0]), key=lambda g: g[0] - g[1])[:10]
    for gs, ge in gaps:
        # the host call running where the gap ends: what the device waited on
        inner = [(s, en, n) for s, en, n in cpu if s <= ge <= en]
        label = min(inner, key=lambda x: x[1] - x[0])[2] if inner else "host (no traced call)"
        tr.idle_gaps.append([label[:160], (ge - gs) * 1e-9])


@contextlib.contextmanager
def traced(enabled: bool):
    """Profile the block when ``enabled``; yields the Trace, which is
    filled when the block ends."""
    tr = Trace()
    if not enabled:
        yield tr
        return
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    t0 = time.monotonic()
    try:
        yield tr
    finally:
        import torch

        torch.cuda.synchronize()
        tr.window_s = time.monotonic() - t0
        prof.stop()
    _reduce(prof.profiler.kineto_results.events(), tr)
