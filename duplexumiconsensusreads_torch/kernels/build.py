"""Build the package's CUDA sources with nvcc and load them via ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles, at
first use, into ``_build/lib<name>-<digest>.so`` beside the package
(the directory is git-ignored); the digest of the source names the
library, so an edited source rebuilds and an unchanged one loads the
existing file. Nothing here runs at import time.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o _build/lib<name>-<digest>.so csrc/<name>.cu
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")

# every CUDA source of the package; build_all compiles them in parallel
SOURCES = ("segment_gemm",)

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_LIBS: dict[str, ctypes.CDLL] = {}
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


def lib_path(name: str) -> str:
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"lib{name}-{digest[:16]}.so")


def _start(name: str):
    """Start nvcc for one source unless its library exists; returns
    (name, final path, tmp path, Popen | None)."""
    out = lib_path(name)
    if os.path.exists(out):
        return name, out, None, None
    os.makedirs(BUILD_DIR, exist_ok=True)
    # unique temp name + atomic rename: concurrent builds never load
    # a half-written library
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    return name, out, tmp, proc


def build_all(names=SOURCES) -> dict[str, float]:
    """Compile every named source, one nvcc each, all started together.
    Returns {name: seconds} (0.0 for a library that already existed);
    raises with the compiler's output if any build fails."""
    t0 = time.monotonic()
    started = [_start(n) for n in names]
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


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed.
    Thread-safe: concurrent first callers build and load it once."""
    lib = _LIBS.get(name)
    if lib is None:
        with _LOAD_LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                build_all((name,))
                lib = ctypes.CDLL(lib_path(name))
                _LIBS[name] = lib
    return lib
