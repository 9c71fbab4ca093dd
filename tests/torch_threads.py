"""One intra-op thread for torch in a test module of the port.

The test workers share the machine's cores: at torch's default (a thread
a core) in every worker, their OpenMP pools contend and each small op's
fork and join waits for descheduled threads. Import the fixture into a
test module to run it on one thread (``test_torch_loss_curve.py`` keeps
its own two)."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
