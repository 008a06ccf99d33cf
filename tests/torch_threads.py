"""One torch intra-op thread for a test module.

The suite runs in several parallel worker processes on shared cores. With
torch's default of a thread per core in every worker, the port's small
tensors spend their time in thread handoffs: a tiny mission-stack step ran
~50x slower inside the suite than alone. A test module that does torch work
imports the fixture, which then applies to every test in it:

    from tests.torch_threads import one_intra_op_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """Run the module's tests with one intra-op thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
