"""An autouse fixture for the port's CPU tests: one intra-op torch thread
while a module runs.  Under ``pytest -n`` every worker is a process with
its own thread pool; at the default width the pools oversubscribe the
cores many times over and the small ops wait on each other.  A test module
takes it with ``from torch_threads import one_torch_thread``."""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
