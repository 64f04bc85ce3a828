"""One torch thread per test module of the port.

The port's plain kernel versions run many small torch ops.  With several
test workers on one host, torch's intra-op thread pools oversubscribe the
cores; one thread per worker keeps the workers out of each other's way.
A test module takes the fixture by importing it:

    from torch_threads import _one_torch_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
