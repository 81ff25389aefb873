"""One intra-op thread for the port's CPU tests.

Tier-1 runs under pytest-xdist, several workers on one host. Each
worker's torch defaults to one intra-op thread per core, so the workers'
parallel regions oversubscribe the cores and wait at their barriers far
longer than the work takes; the port's CPU tests run tiny shapes, for
which one thread is as fast in a serial run. Every port test module
imports `one_torch_thread` (an autouse fixture), which holds torch at one
intra-op thread while that module's tests run and restores the count
after: the results are the same, the host's cores are shared instead of
fought over. The kernel tests (tests/test_torch_kernels.py), which run
on the card, leave torch as it is.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
