"""A module-scoped autouse fixture for the port's CPU tests: torch on one
thread while a test module runs (and torch._dynamo imported at collection,
below).

The test workers share the host's cores, and torch's default of one
thread a core in every worker oversubscribes them many times over: a file
of small attention ops took 264 s over six workers with the default and 16
s with one thread each. A test module takes the fixture by importing it:

    from torch_threads import one_torch_thread  # noqa: F401
"""

import pytest
import torch
# torch.optim's optimizers import torch._dynamo when they are built, and
# that import walks sys.modules (inspect.getmodule). The JAX package's
# tests/reference_shim.py leaves stand-in modules there whose __getattr__
# answers every name with a class, __file__ too, and the walk then fails:
# a worker that ran tests/test_reference_import_parity.py before a port
# file that trains failed there. Every worker imports this module while it
# collects the tests, before any test runs, so the import is done here.
import torch._dynamo  # noqa: E402,F401


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)
