"""One run of one cell: load what the cell names, set it up, measure the
window, check the outputs against the reference, and build the result.

Everything a cell is made of is found by name: the cell in
``BENCHMARK.json``, its configuration's file, ``traffic/<mix>.json``
(which names its driver, ``drivers/<driver>.py``), ``limits/<cell>.json``
and ``metrics/<metric>.py``. A new cell, mix or metric is new files.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
import time

import numpy as np

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKOUT = os.path.dirname(PKG)
CACHE = os.path.join(PKG, ".cache")
# modules that may not be loaded in a run, compared by whole top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "duplexumiconsensusreads_tpu")


class NoDevice(RuntimeError):
    """No card, or fewer cards than the cell asks for."""


# the program under test: the port, as this checkout holds it
PROGRAM = "duplexumiconsensusreads_torch"


def program_in_checkout() -> None:
    """Import the program and refuse a copy from outside the checkout
    (an installed one): the run measures this checkout's program."""
    mod = importlib.import_module(PROGRAM)
    where = os.path.dirname(os.path.dirname(os.path.abspath(mod.__file__)))
    if where != CHECKOUT:
        raise SystemExit(f"{PROGRAM} was loaded from {where}, not from this checkout "
                         f"({CHECKOUT})")


def process_age() -> float:
    """Seconds since this process started (the kernel's start time)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start_ticks / os.sysconf("SC_CLK_TCK")


def cache_env() -> None:
    """Fix every build and kernel cache of the program inside the
    checkout, at fixed paths, before the program is imported."""
    for var, sub in (("DUT_BUILD_DIR", "build"), ("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(CACHE, sub)
        os.makedirs(os.environ[var], exist_ok=True)


def load_json(*parts: str) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Ctx:
    """The state of one run, shared by the driver and the metric readers."""

    name: str
    workload: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: object = None
    window_seconds: float = 0.0
    reads: object = None  # gen.sim.Reads
    setup_s: float = 0.0
    window_s: float = 0.0
    window_reads: int = 0
    attempted: int = 0
    failed: int = 0
    counters: dict = dataclasses.field(default_factory=dict)  # program counters the driver read
    tracer: object = None  # lib.trace.Trace of the window
    state: dict = dataclasses.field(default_factory=dict)  # the driver's own


def cell_parts(bench: dict, name: str) -> tuple[dict, dict, dict]:
    """(workload, configuration file, traffic file) of the cell ``name``."""
    wl = next((w for w in bench["workloads"] if w["name"] == name), None)
    if wl is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == wl["config"])
    config = load_json(CHECKOUT, entry["file"])
    traffic = load_json(PKG, "traffic", wl["traffic"] + ".json")
    return wl, config, traffic


def metrics_of(bench: dict, name: str, trace: bool) -> list[dict]:
    """The metrics a run of cell ``name`` reports: its end-to-end ones
    (--trace 0), or its per-layer ones (--trace 1)."""
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (name in m["workloads"] if "workloads" in m else m["moves"] in moved)]


def read_metric(metric: dict, ctx: Ctx):
    mod = load_module(os.path.join(PKG, "metrics", metric["name"] + ".py"),
                      "portbench_metric_" + metric["name"].replace(".", "_"))
    value = mod.read(ctx)
    return None if value is None else float(value)


def forbidden_loaded() -> list[str]:
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


def sample_buckets(ctx: Ctx, buckets: list, heads=()) -> list[int]:
    """Indices of the buckets the check compares: a draw from the seed,
    with the bucket of the most reads, the one that holds the largest
    position group, and each bucket whose first read is in ``heads``
    (the driver's: the first bucket of each dispatch class)."""
    rng = np.random.default_rng(np.random.SeedSequence([ctx.seed % (1 << 64), 7]))
    k = min(int(ctx.traffic.get("check_buckets", 48)), len(buckets))
    pick = set(rng.choice(len(buckets), size=k, replace=False).tolist())
    sizes = [len(b) for b, _ in buckets]
    pick.add(int(np.argmax(sizes)))
    group = [int(np.unique(ctx.reads.pos[b], return_counts=True)[1].max()) for b, _ in buckets]
    pick.add(int(np.argmax(group)))
    heads = set(heads)
    pick |= {i for i, (b, _) in enumerate(buckets) if int(b[0]) in heads}
    return sorted(pick)


def run_cell(bench: dict, name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", check_modules: bool = True) -> tuple[dict, list[str]]:
    """One run. Returns (result line, check lines for standard error).
    ``device`` "cpu" runs the program's plain kernels, and
    ``check_modules`` False skips the look for forbidden modules, for
    tests in a process that loaded them itself."""
    import torch

    from portbench.lib import compare, trace as tracing
    from portbench.reference.consensus import expected_records
    from portbench.reference.partition import all_buckets

    wl, config, traffic = cell_parts(bench, name)
    program_in_checkout()
    if device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < int(wl["chips"]):
            raise NoDevice(f"cell {name} needs {wl['chips']} CUDA device(s); "
                           f"this machine has {torch.cuda.device_count()}")
    ctx = Ctx(name=name, workload=wl, config=config, traffic=traffic, seed=int(seed),
              seconds=float(seconds), trace=trace, device=torch.device(device))
    ctx.window_seconds = min(float(seconds), float(traffic.get("trace_seconds", seconds))) \
        if trace else float(seconds)
    driver = load_module(os.path.join(PKG, "drivers", traffic["driver"] + ".py"),
                         "portbench_driver_" + traffic["driver"])
    with torch.no_grad():
        driver.setup(ctx)
        ctx.setup_s = process_age()
        with tracing.traced(trace and device == "cuda") as tr:
            driver.window(ctx)
        ctx.tracer = tr
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    metrics = {}
    for m in metrics_of(bench, name, trace):
        v = read_metric(m, ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    sim = config["sim"]
    buckets = all_buckets(ctx.reads.pos, ctx.reads.umi, int(traffic.get("chunk_reads", 0)),
                          int(config["capacity"]), config["grouping"]["strategy"] != "exact",
                          int(traffic.get("max_chunks", 0)))
    heads = driver.class_heads(ctx) if hasattr(driver, "class_heads") else ()
    pick = sample_buckets(ctx, buckets, heads)
    with torch.no_grad():
        observed = driver.observe(ctx, [buckets[i][0] for i in pick])
    driver.free(ctx)
    expected = expected_records(ctx.reads, [buckets[i][0] for i in pick], config["grouping"],
                                config["consensus"], device=ctx.device)
    numbers = compare.compare(expected, observed)
    limits = load_json(PKG, "limits", name + ".json")
    correct, checks = compare.judge(numbers, limits)
    dev = {"platform": "gpu" if device == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
           "count": int(wl["chips"]), "memory_peak_bytes": int(peak)}
    if trace:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
    result = {"correct": bool(correct), "attempted": ctx.attempted, "failed": ctx.failed,
              "metrics": metrics, "device": dev}
    if trace and tr.intervals:
        result["breakdown"] = tr.breakdown()
    result["checks"] = checks
    lines = [f"window {ctx.window_s:.3f} s, {ctx.attempted} calls or passes, "
             f"setup {ctx.setup_s:.3f} s, counters {json.dumps(ctx.counters, sort_keys=True)}",
             f"reads {ctx.reads.n}, buckets compared {len(pick)} of {len(buckets)}, "
             f"sim {json.dumps(sim, sort_keys=True)}"]
    lines += [f"check {k}: {c['value']} (limit {c['limit']})" for k, c in checks.items()]
    bad = forbidden_loaded() if check_modules else []
    if bad:
        raise SystemExit(f"forbidden modules loaded: {', '.join(bad)}")
    return result, lines
