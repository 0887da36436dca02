"""The port's shared test settings in tests/torch_suite.py: the per-test
time limit and the torch threads of an xdist worker."""

import glob
import os
import pathlib
import subprocess
import sys
import time

import pytest

import torch_suite
from torch_suite import per_test_time_limit  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))


def test_time_limit_fails_a_test_that_runs_past_it(monkeypatch):
    monkeypatch.setattr(torch_suite, "TEST_TIME_LIMIT", 0.2)
    start = time.monotonic()
    with pytest.raises(pytest.fail.Exception,
                       match=r"per-test time limit of 0\.2 s"):
        with torch_suite.time_limit():
            time.sleep(5)
    assert time.monotonic() - start < 2


def test_every_port_test_file_runs_under_the_limit(request):
    assert "per_test_time_limit" in request.fixturenames
    missing = [
        os.path.basename(path)
        for path in sorted(glob.glob(os.path.join(HERE, "test_torch_*.py")))
        if "from torch_suite import per_test_time_limit"
        not in pathlib.Path(path).read_text()
    ]
    assert missing == []


# Torch's thread count before and after importing the shared settings.
_PROBE = ("import torch; before = torch.get_num_threads(); "
          "import torch_suite; print(before, torch.get_num_threads())")


def _threads(env):
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env, cwd=HERE,
                         capture_output=True, text=True, check=True,
                         timeout=120)
    return tuple(int(x) for x in out.stdout.split())


def test_xdist_worker_gets_one_torch_thread():
    """An xdist worker runs torch on one thread; a single process keeps
    torch's default."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PYTEST_XDIST_")}
    default, alone = _threads(env)
    assert alone == default
    env.update(PYTEST_XDIST_WORKER="gw0", PYTEST_XDIST_WORKER_COUNT="6")
    assert _threads(env) == (default, 1)
