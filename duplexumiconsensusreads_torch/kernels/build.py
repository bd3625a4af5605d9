"""Build the package's CUDA sources with nvcc and load them via ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles, at
first use, into ``_build/lib<name>-<digest>.so`` beside the package
(the directory is git-ignored; ``DUT_BUILD_DIR`` moves it, see
utils/compile_cache.py); the digest of the source names the library,
so an edited source rebuilds and an unchanged one loads the existing
file. A build with compile-time macros (``defines``, e.g. the
cluster kernel's per-phase clock stamps) is another library of the same
source, named by a digest that includes them. Nothing here runs at
import time.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o _build/lib<name>-<digest>.so csrc/<name>.cu
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

from duplexumiconsensusreads_torch.utils.compile_cache import build_dir

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
# the default build directory ($DUT_BUILD_DIR overrides it at call time)
BUILD_DIR = os.path.join(PKG_DIR, "_build")

# every CUDA source of the package; build_all compiles them in parallel
SOURCES = ("segment_gemm", "cluster_fixpoint", "step_clock")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_LIBS: dict[tuple, ctypes.CDLL] = {}
# launch accounting of the kernel wrappers (count_launch): one lock for
# every wrapper's counters, and the tally of the launches a thread is
# capturing into a CUDA graph (runtime/graphs.py), which launch nothing
# until the graph replays
_COUNT_LOCK = threading.Lock()
_CAPTURING = threading.local()
# serialises the first build + load of each library: the streaming
# executor's transfer workers can all reach their first kernel launch
# at once, and must not start two nvcc runs or two CDLL loads
_LOAD_LOCK = threading.Lock()


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, else PATH, else the
    toolkit's default install location."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _flags(defines=()) -> tuple:
    return (*NVCC_FLAGS, *(f"-D{d}" for d in defines))


def lib_path(name: str, defines=()) -> str:
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_flags(defines)).encode()).hexdigest()
    return os.path.join(build_dir(BUILD_DIR), f"lib{name}-{digest[:16]}.so")


def _start(name: str, defines=()):
    """Start nvcc for one source unless its library exists; returns
    (name, final path, tmp path, Popen | None)."""
    out = lib_path(name, defines)
    if os.path.exists(out):
        return name, out, None, None
    os.makedirs(os.path.dirname(out), exist_ok=True)
    # unique temp name + atomic rename: concurrent builds never load
    # a half-written library
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *_flags(defines), "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    return name, out, tmp, proc


def build_all(names=SOURCES, defines=()) -> dict[str, float]:
    """Compile every named source, one nvcc each, all started together,
    with the macros ``defines``. Returns {name: seconds} (0.0 for a
    library that already existed); raises with the compiler's output if
    any build fails."""
    t0 = time.monotonic()
    started = [_start(n, defines) for n in names]
    secs = {}
    errors = []
    for name, out, tmp, proc in started:
        if proc is None:
            secs[name] = 0.0
            continue
        log, _ = proc.communicate()
        secs[name] = time.monotonic() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log.decode(errors='replace')}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return secs


def device_guard(device):
    """``torch.cuda.device(device)`` when ``device`` is not the current
    CUDA device (a kernel launches on the current one), else nothing:
    the guard costs a launch a few microseconds of host time."""
    import torch

    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def load(name: str, defines=()) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu built with the macros
    ``defines``, built first if needed. Thread-safe: concurrent first
    callers build and load it once."""
    key = (name, tuple(defines))
    lib = _LIBS.get(key)
    if lib is None:
        with _LOAD_LOCK:
            lib = _LIBS.get(key)
            if lib is None:
                build_all((name,), defines)
                lib = ctypes.CDLL(lib_path(name, defines))
                _LIBS[key] = lib
    return lib


def count_launch(wrapper, device_index, stream) -> None:
    """One launch of ``wrapper``'s kernel queued on (device index,
    stream handle): added to ``wrapper.launches`` and
    ``wrapper.stream_launches[(device_index, stream)]``, or, while this
    thread captures a CUDA graph (:func:`tally_launches`), to the
    capture's tally instead, since a captured launch runs only when the
    graph replays (runtime/graphs.py adds the tally per replay)."""
    tally = getattr(_CAPTURING, "tally", None)
    if tally is not None:
        tally[wrapper] = tally.get(wrapper, 0) + 1
        return
    add_launches(wrapper, 1, device_index, stream)


def add_launches(wrapper, n: int, device_index, stream) -> None:
    """Add ``n`` launches on (device index, stream handle) to a
    wrapper's counters (under the lock: several threads launch at
    once in the streaming executor)."""
    with _COUNT_LOCK:
        wrapper.launches += n
        on = (device_index, stream)
        wrapper.stream_launches[on] = wrapper.stream_launches.get(on, 0) + n


@contextlib.contextmanager
def tally_launches():
    """While entered, this thread's kernel launches go into the yielded
    {wrapper: launches} dict instead of the wrappers' counters."""
    prev = getattr(_CAPTURING, "tally", None)
    tally: dict = {}
    _CAPTURING.tally = tally
    try:
        yield tally
    finally:
        _CAPTURING.tally = prev
