"""ctypes binding to the native BAM loader (``src/bamloader.cpp``).

Host C++, not a device kernel: multithreaded BGZF inflate and deflate,
the BAM record-chain walk, and record field extraction straight into
NumPy buffers — a copy of the JAX package's native loader. It compiles
at first use, with g++ and the JAX package's Makefile flags, into
``_build/libdutbam-<digest>.so`` beside the package (git-ignored); the
digest covers the sources and the command, so an edited source or
another zlib setup rebuilds and an unchanged one loads the existing
file:

    g++ -O3 -std=c++17 -fPIC -Wall -shared -o _build/libdutbam-<d>.so \
        src/bamloader.cpp -lz -pthread

On a host without ``zlib.h`` the source is compiled against
``src/zlib_decls.h`` and linked to the ``libz.so.1`` that Python's own
``zlib`` module loads.

There is no silent fallback: a failed build raises with the compiler's
output. ``DUT_NO_NATIVE=1`` (the JAX package's switch, under its name)
is the one way to run the portable Python codec instead; it applies to
the reader, the streaming iterator and the deflate alike. The functions
are bound through ``ctypes.CDLL``, which releases the GIL for each call.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import subprocess
import threading
import time

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_DIR, "src")
SOURCE = os.path.join(SRC_DIR, "bamloader.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-shared")
# the parallel inflate/deflate/fill calls' thread count (the JAX
# package's choice)
N_THREADS = min(os.cpu_count() or 1, 16)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

_c_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_c_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_c_u16p = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
_c_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")


def native_enabled() -> bool:
    """False when ``DUT_NO_NATIVE`` selects the portable codec."""
    return not os.environ.get("DUT_NO_NATIVE")


def _cxx() -> str:
    return os.environ.get("CXX", "g++")


@functools.cache
def zlib_header_found() -> bool:
    """Whether the C++ compiler finds ``zlib.h`` (a preprocessor probe)."""
    r = subprocess.run([_cxx(), "-E", "-x", "c++", "-"], input=b"#include <zlib.h>\n",
                       capture_output=True)
    return r.returncode == 0


@functools.cache
def _libz_link_arg() -> str:
    """``-lz`` when the linker finds libz.so, else the full path of the
    libz.so.1 this process has loaded for Python's zlib module."""
    r = subprocess.run([_cxx(), "-print-file-name=libz.so"], capture_output=True, text=True)
    if os.path.isabs(r.stdout.strip()):
        return "-lz"
    import zlib  # noqa: F401 — maps libz.so.1 into this process

    with open("/proc/self/maps") as f:
        for line in f:
            path = line.split()[-1]
            if "/libz.so" in path and os.path.isfile(path):
                return path
    raise RuntimeError("no libz.so for the native loader: neither the linker "
                       "nor this Python process has one")


def build_command(out: str) -> list[str]:
    """The full g++ command line (zlib probed on this host)."""
    decls = [] if zlib_header_found() else ["-DDUT_ZLIB_DECLS"]
    return [_cxx(), *CXX_FLAGS, *decls, "-o", out, SOURCE, _libz_link_arg(), "-pthread"]


def lib_path() -> str:
    """The library's path, named by the digest of the sources and the
    build command."""
    h = hashlib.sha256()
    for name in sorted(os.listdir(SRC_DIR)):
        with open(os.path.join(SRC_DIR, name), "rb") as f:
            h.update(name.encode() + f.read())
    h.update(" ".join(build_command("OUT")).encode())
    return os.path.join(BUILD_DIR, f"libdutbam-{h.hexdigest()[:16]}.so")


def start_build():
    """Start g++ unless the library exists; returns a handle for
    :func:`finish_build` (so a caller can run it beside nvcc)."""
    out = lib_path()
    if os.path.exists(out):
        return out, None, None, time.monotonic()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    proc = subprocess.Popen(build_command(tmp), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)
    return out, tmp, proc, time.monotonic()


def finish_build(handle) -> dict:
    """Wait for a :func:`start_build`; raises with the compiler's output
    on failure. Returns {"path", "seconds" (0.0 when it existed),
    "zlib_h"}."""
    out, tmp, proc, t0 = handle
    secs = 0.0
    if proc is not None:
        log, _ = proc.communicate()
        secs = time.monotonic() - t0
        if proc.returncode != 0:
            raise RuntimeError(
                f"g++ failed for {SOURCE}:\n{log.decode(errors='replace')}"
            )
        # atomic publish: a concurrent loader never sees half a library
        os.replace(tmp, out)
    return {"path": out, "seconds": secs, "zlib_h": zlib_header_found()}


def build() -> dict:
    """Build the library unless it exists, under an inter-process file
    lock (pytest workers, the ingest producer and the drain workers may
    all reach the first load at once)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "libdutbam.lock"), "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        try:
            return finish_build(start_build())
        finally:
            fcntl.flock(lk, fcntl.LOCK_UN)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.dut_bgzf_usize.restype = ctypes.c_long
    lib.dut_bgzf_usize.argtypes = [_c_u8p, ctypes.c_long]
    lib.dut_bgzf_decompress.restype = ctypes.c_long
    lib.dut_bgzf_decompress.argtypes = [
        _c_u8p, ctypes.c_long, _c_u8p, ctypes.c_long, ctypes.c_int,
    ]
    lib.dut_bgzf_compress_bound.restype = ctypes.c_long
    lib.dut_bgzf_compress_bound.argtypes = [ctypes.c_long]
    lib.dut_bgzf_compress.restype = ctypes.c_long
    lib.dut_bgzf_compress.argtypes = [
        _c_u8p, ctypes.c_long, _c_u8p, ctypes.c_long, ctypes.c_int, ctypes.c_int,
    ]
    lib.dut_bam_chain.restype = ctypes.c_long
    lib.dut_bam_chain.argtypes = [
        _c_u8p, ctypes.c_long, ctypes.c_long, ctypes.c_long,
        ctypes.POINTER(ctypes.c_long),
    ]
    lib.dut_bam_chain_offsets.restype = ctypes.c_long
    lib.dut_bam_chain_offsets.argtypes = [
        _c_u8p, ctypes.c_long, ctypes.c_long, ctypes.c_long,
        ctypes.POINTER(ctypes.c_long), ctypes.c_void_p,
    ]
    lib.dut_bam_scan.restype = ctypes.c_long
    lib.dut_bam_scan.argtypes = [
        _c_u8p, ctypes.c_long,
        ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.c_void_p,
    ]
    lib.dut_bam_fill.restype = ctypes.c_int
    lib.dut_bam_fill.argtypes = [
        _c_u8p, ctypes.c_long, _c_i64p, ctypes.c_long,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        _c_u16p, _c_i32p, _c_i32p, _c_i32p, _c_i32p, _c_i32p,
        _c_u8p, _c_u8p, _c_u8p,
        np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS"),
    ]
    return lib


def get_lib() -> ctypes.CDLL:
    """The bound library, built first if needed. Raises when it cannot
    be built or loaded. Thread-safe: concurrent first callers build and
    load it once."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(build()["path"]))
        return _lib


def active_lib() -> ctypes.CDLL | None:
    """The library, or None when ``DUT_NO_NATIVE`` selects the portable
    codec (a build failure raises: no silent fallback)."""
    return get_lib() if native_enabled() else None


def native_available() -> bool:
    """True when the native path is selected (and so built and loaded)."""
    return active_lib() is not None


def bgzf_compress_native(data: bytes, level: int = 6, n_threads: int = 0) -> bytes:
    """Parallel BGZF-compress ``data`` (no EOF block). Raises if the
    native call fails."""
    lib = get_lib()
    if not data:
        return b""
    src = np.frombuffer(data, np.uint8)
    cap = lib.dut_bgzf_compress_bound(len(src))
    out = np.empty(max(cap, 1), np.uint8)
    w = lib.dut_bgzf_compress(src, len(src), out, cap, level, n_threads or N_THREADS)
    if w < 0:
        raise RuntimeError(f"native BGZF deflate failed on {len(data)} bytes")
    return out[:w].tobytes()
