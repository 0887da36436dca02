"""Settings shared by the port's tests: every `tests/test_torch_*.py`
imports `per_test_time_limit` from here, which also applies the thread
setting below once, when this module is first imported.

Each xdist worker runs torch on one intra-op thread: with torch's default,
six workers ran 48 threads on 8 cores and every plain-PyTorch kernel
version ran about five times slower. A run without xdist keeps torch's
default.
"""

import contextlib
import os
import signal

import pytest
import torch

if "PYTEST_XDIST_WORKER" in os.environ:
    torch.set_num_threads(1)

# Seconds one test may run, about twice the slowest tier-1 test with one
# thread per worker (336-390 s on 8 cores). The alarm is handled only when
# control comes back to Python, so a long XLA compile still runs to its
# end: the limit catches hangs, not slow compiles.
TEST_TIME_LIMIT = 800


@contextlib.contextmanager
def time_limit():
    """Fail the running test once TEST_TIME_LIMIT seconds have passed."""
    seconds = TEST_TIME_LIMIT

    def expire(signum, frame):
        pytest.fail(f"ran past the per-test time limit of {seconds} s "
                    "(TEST_TIME_LIMIT in tests/torch_suite.py)")

    handler = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, handler)


@pytest.fixture(autouse=True)
def per_test_time_limit():
    """Every test of a module that imports this fixture runs under
    `time_limit()`."""
    with time_limit():
        yield
