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
"""

import warnings


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
