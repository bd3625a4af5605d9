"""Repository-wide pytest settings for the torch port's tests.

Registers the ``cuda`` marker: tests that need an NVIDIA card (the
hand-written CUDA kernels have no CPU mode). Each such test decides at
run time, inside the test, whether a card is present and skips with a
reason when it is not.

Also makes one warning independent of test order: the installed jax
deprecates ``jax.experimental.shard_map``, which the JAX package imports
when it first shards a pipeline, and jax warns about it once per
process. A test that turns warnings into errors around a sharded call
(``tests/test_jumbo.py``) then passed or failed by whether another file
had reached that import earlier in the same worker; it failed whenever
its file ran alone. The import is made once here, at start, with that
one deprecation recorded and dropped, so every worker starts alike.

And builds the JAX package's native BAM library once, before any test
file is collected (:func:`build_reference_native`). That package
builds ``native/libdutbam.so`` lazily, on its first ``get_lib()``, by
running ``make`` in place with no lock, and the Makefile writes the
library where it is loaded; a failed load leaves the loader without a
library for the rest of the process. Under ``pytest -n 6`` every
worker collects every file, and collection calls ``get_lib()``
(``tests/test_foreign_bam.py``'s module-level check, ``tests/test_native.py``'s
``skipif``), so on a checkout without the library six workers ran six
``make``s over one output file, and a worker that loaded it half
written skipped the reference's native tests and compared the port
against a reference without its native reader. The reference stays as
it is; here the first process to take an inter-process lock builds and
loads the library, and the others wait for it, then load the finished
file.
"""

import fcntl
import importlib.util
import os
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
# git-ignored, beside the port's own built libraries
REFERENCE_NATIVE_LOCK = os.path.join(ROOT, "duplexumiconsensusreads_torch", "_build",
                                     "reference-native.lock")


def build_reference_native(native_dir=None, lock_path=REFERENCE_NATIVE_LOCK):
    """The JAX package's bound native library (None when it cannot be
    built), built and loaded while holding an exclusive ``fcntl`` lock
    on ``lock_path``, so that processes doing this at once build it once
    and load only a finished file. ``native_dir`` is a copy of that
    package's ``native/`` directory to load from instead (its loader
    builds into it); by default the package itself is imported, which
    raises ImportError where jax is missing."""
    if native_dir is None:
        from duplexumiconsensusreads_tpu import native as loader
    else:
        spec = importlib.util.spec_from_file_location(
            "reference_native_copy", os.path.join(native_dir, "__init__.py"))
        loader = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(loader)
    os.makedirs(os.path.dirname(lock_path), exist_ok=True)
    with open(lock_path, "a") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        try:
            return loader.get_lib()
        finally:
            fcntl.flock(lk, fcntl.LOCK_UN)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU with nvcc (torch port kernels); skips without one",
    )
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always", DeprecationWarning)
        try:
            from jax.experimental.shard_map import shard_map  # noqa: F401
        except ImportError:  # a machine with only PyTorch (the card's)
            pass
    try:
        build_reference_native()
    except ImportError:
        pass
