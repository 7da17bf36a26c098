"""One torch intra-op thread for each test of the port's CPU suite.

The suite runs in several xdist workers on one machine's cores. Each
worker's torch would otherwise start a thread per core, and their spinning
pools then slowed a CPU train step of the test model from 5 s alone to 37 s
among the other workers. A test module imports this fixture to take it.
It is session-scoped, so that module-scoped fixtures, which are built
before any function-scoped one, run on one thread too; the port's modules
run last in the suite (tests/conftest.py)."""
import pytest
import torch


@pytest.fixture(scope="session", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
