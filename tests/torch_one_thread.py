"""A module fixture for the port's CPU test files: torch runs with ONE
intra-op thread while the module's tests run, and with its old count after.

The tier-1 run puts six pytest workers on the host's cores. Each worker's
torch would start an OpenMP team of one thread a core for every parallel
op, and the teams of six workers (beside JAX's own thread pools) spin
against each other: on one 8-core host, four of the port's files on four
workers took several times as long in all with them (CHANGES.md has the
times).
A test file opts in with `from torch_one_thread import one_torch_thread
# noqa: F401`.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
