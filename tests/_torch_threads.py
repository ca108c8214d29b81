"""One intra-op thread for the port's small CPU tests: the suite runs
several pytest workers on one host, and at smoke sizes each torch
process's default thread pool (one thread a core) only contends with the
other workers'.  Import ``one_thread`` into a test module to apply it to
every test there; the count is restored after each test."""
import pytest
import torch


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
