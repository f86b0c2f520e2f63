"""A module-scoped autouse fixture for the port's CPU tests: torch on one
thread while a test module runs.

The test workers share the host's cores, and torch's default of one
thread a core in every worker oversubscribes them many times over: a file
of small attention ops took 264 s over six workers with the default and 16
s with one thread each. A test module takes the fixture by importing it:

    from torch_threads import one_torch_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)
