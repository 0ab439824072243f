"""A module-scoped autouse fixture that runs torch on one thread while a
test module of the port runs; a module takes it with

    from torch_one_thread import one_torch_thread  # noqa: F401

The test run's workers (6 on 8 cores) each run their module's torch ops:
at a thread a core each, torch's threads oversubscribe the cores and its
tiny ops run many times slower than on one thread a worker."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
