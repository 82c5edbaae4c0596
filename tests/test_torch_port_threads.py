"""The intra-op thread count of the port's test modules.

The suite runs several pytest workers on one host (``-n 6``).  PyTorch starts
one intra-op thread per core in each of them, and the JAX package's XLA
threads come on top: the cores are oversubscribed many times over and every
model-running test slows down several-fold.  The port's test modules import
``torch_threads`` (module-scoped, autouse) to hold torch to ``TEST_THREADS``
while they run, and hand ``child_env()`` to the processes they start; the
models at the tests' sizes gain little from more threads.
"""

from __future__ import annotations

import os

import pytest
import torch

TEST_THREADS = 2


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(TEST_THREADS)
    yield
    torch.set_num_threads(n)


def child_env(**extra: str) -> dict[str, str]:
    """The environment for a child process: this one's, with torch's
    intra-op threads (``OMP_NUM_THREADS``) at ``TEST_THREADS``."""
    return {**os.environ, "OMP_NUM_THREADS": str(TEST_THREADS), **extra}


def test_torch_threads_holds_the_module_to_test_threads():
    assert torch.get_num_threads() == TEST_THREADS
    assert child_env()["OMP_NUM_THREADS"] == str(TEST_THREADS)
