"""Where the port's compiled kernel libraries live: the counterpart of
the JAX package's persistent XLA compilation cache.

The port compiles nothing at run time but its two build outputs: the
CUDA sources of ``csrc/`` (``kernels/build.py``, nvcc) and the native
BAM loader (``native/``, g++). Each library is named by a digest of its
source and its build command, so a directory of them is a cache that
never goes stale: the first process pointed at it builds, and every
later one (another daemon, the next bench run, a restarted job) loads
the libraries and builds nothing.

The location is a process-wide knob, ``DUT_BUILD_DIR`` (default: the
``_build/`` directory beside the package). ``serve.daemon --build-dir``
and the bench's cache directory set it through
:func:`enable_compile_cache`. A build that fails raises; nothing falls
back to a plain version.
"""

from __future__ import annotations

import os

ENV_VAR = "DUT_BUILD_DIR"


def build_dir(default: str) -> str:
    """The build directory in force: ``$DUT_BUILD_DIR``, else
    ``default`` (kernels/build.py and native/ each pass their
    package-relative ``_build/``)."""
    return os.path.abspath(os.environ.get(ENV_VAR) or default)


def enable_compile_cache(cache_dir: str) -> str:
    """Point every later kernel build and load of this process (and of
    the processes it starts) at ``cache_dir``; returns its absolute
    path. Call it before the first kernel or native-loader use: a
    library already loaded stays loaded from where it was built."""
    path = os.path.abspath(cache_dir)
    os.makedirs(path, exist_ok=True)
    os.environ[ENV_VAR] = path
    return path
