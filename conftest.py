"""Repository-wide pytest settings for the torch port's tests.

Registers the ``cuda`` marker: tests that need an NVIDIA card (the
hand-written CUDA kernels have no CPU mode). Each such test decides at
run time, inside the test, whether a card is present and skips with a
reason when it is not.
"""


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU with nvcc (torch port kernels); skips without one",
    )
