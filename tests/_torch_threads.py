"""One CPU thread for each test of a port test module that imports the
fixture below.

The suite runs in several processes sharing the cores (pytest-xdist); an
op's multi-threaded region then waits on threads that the other processes
hold, and a test of many small ops (a training loop, a time loop) slows
down a hundredfold.  A module takes the policy with one line::

    from _torch_threads import one_cpu_thread  # noqa: F401  (autouse)
"""
from __future__ import annotations

import pytest
import torch


@pytest.fixture(autouse=True)
def one_cpu_thread():
    """Each test's eager ops on one CPU thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
