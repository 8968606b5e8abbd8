"""An autouse fixture for test modules of the port that run its plain
versions at a few hundred lanes and more: the module's tests on one
PyTorch thread.  From 256 lanes the limb arithmetic passes PyTorch's
grain for intra-op threads, and on a CPU the suite shares with its other
xdist workers those threads only contend: on an 8-core machine the two
130-lane cases of ``test_torch_engine_interface.py`` took 129 and 195 s
in the suite without it and 7-10 s alone.  Import it into the module:

    from torch_threads import one_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
