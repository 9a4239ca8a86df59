"""A module fixture for the port's tests that run many small eager ops.

Beside the other test processes, a spinning intra-op thread pool costs far
more than it brings: a MARL builder run took 54 s on 8 threads and 3.6 s on 1
under full CPU load. A test module applies it with
``from tests._torch_threads import one_intra_op_thread`` (autouse, module
scope).
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """Run the module's torch work on one intra-op thread, and restore the count after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
