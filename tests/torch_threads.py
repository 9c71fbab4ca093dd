"""One intra-op thread for torch in a test module of the port, and a hard
limit on the module's time.

The test workers share the machine's cores: at torch's default (a thread
a core) in every worker, their OpenMP pools contend and each small op's
fork and join waits for descheduled threads. Import the fixture into a
test module to run it on one thread (``test_torch_loss_curve.py`` keeps
its own two).

The same fixture arms SIGALRM for MODULE_LIMIT seconds over the module
(its module fixtures' setup, its tests and their teardown): a wait that
never ends (a process, a socket, a blocking KV get) then fails the test
it is in with ``TimeoutError`` instead of holding the worker, and the
whole suite, past its time limit. Once it has fired, every further
AFTER_LIMIT seconds in the module fire it again."""

import signal
import threading

import pytest
import torch

#: the seconds a port test module may take (the slowest take ~180 s in a
#: whole run on six workers)
MODULE_LIMIT = 600
#: once past MODULE_LIMIT, the seconds each further wait in the module gets
AFTER_LIMIT = 60


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread(request):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    name = request.module.__name__

    def expire(signum, frame):
        signal.alarm(AFTER_LIMIT)
        raise TimeoutError(f"{name} ran past its {MODULE_LIMIT} s limit")

    armed = threading.current_thread() is threading.main_thread()
    if armed:
        previous = signal.signal(signal.SIGALRM, expire)
        signal.alarm(MODULE_LIMIT)
    yield
    if armed:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, previous)
    torch.set_num_threads(threads)
