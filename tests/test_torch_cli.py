"""The port's debug CLI (`python -m ahocorasick_tpu_torch.cli`) on the CPU.

Each run's standard output is held against the JAX package's CLI
(`ahocorasick_tpu.cli.main`) on the same files: the match count, or the
automaton dump with --debug. The port runs with ``--device cpu`` (the
kernels' plain PyTorch versions). Outputs are integers or text: exact
equality.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ahocorasick_tpu import cli as jcli
from ahocorasick_tpu_torch import cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SYL = "bar bel bor dan dar del dor fan far gar gor hal han".split()


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The kernels' plain versions run many small torch operations. With
    several test processes on one host, torch's intra-op threads contend
    (one case of this file took 50x longer beside five copies of itself),
    so these tests run torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A dictionary of 12 mixed-case names (a few sharing prefixes) and
    6 KiB of text with planted hits."""
    d = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(31)
    names = sorted({
        "".join(SYL[int(rng.integers(len(SYL)))]
                for _ in range(int(rng.integers(2, 4)))).capitalize()
        for _ in range(12)
    })
    words = []
    for _ in range(1200):
        if rng.random() < 0.1:
            w = names[int(rng.integers(len(names)))]
            words.append(w.lower() if rng.random() < 0.5 else w)
        else:
            words.append("".join(SYL[int(rng.integers(len(SYL)))][:2]
                                 for _ in range(2)))
    dict_path = d / "dict.txt"
    dict_path.write_bytes("\n".join(names).encode() + b"\r\n\n")
    hay_path = d / "hay.txt"
    hay_path.write_bytes(" ".join(words).encode())
    return str(dict_path), str(hay_path)


def run(main, argv, capsys):
    assert main(argv) == 0
    return capsys.readouterr().out


FLAGS = {
    "standard": [],
    "leftmost-longest": ["--match-kind", "leftmost-longest"],
    "leftmost-first": ["--match-kind", "leftmost-first", "--kind", "dfa"],
    "overlapping": ["--overlapping"],
    "count-only": ["--count-only"],
    "ascii-case-insensitive": ["--ascii-case-insensitive", "--count-only"],
    "cascade": ["--engine", "cascade", "--count-only"],
    "anchored": ["--start-kind", "both", "--anchored"],
    "debug": ["--debug", "--debug-states", "6"],
}


@pytest.mark.parametrize("name", list(FLAGS))
def test_cli_stdout_equals_jax(files, name, capsys):
    args = list(files) + FLAGS[name]
    got = run(cli.main, args + ["--device", "cpu"], capsys)
    want = run(jcli.main, args, capsys)
    assert got == want
    if name != "debug":
        assert int(got) > 0 or name == "anchored"


def test_cli_cascade_takes_the_cascade_engine(files, monkeypatch):
    """--engine cascade builds the cascade engine on the named device."""
    from ahocorasick_tpu_torch import ahocorasick as facade

    built = []
    orig = facade.CascadeEngine.__init__

    def spy(self, *a, **k):
        orig(self, *a, **k)
        built.append(self.device)
    monkeypatch.setattr(facade.CascadeEngine, "__init__", spy)
    assert cli.main(list(files) + ["--engine", "cascade", "--count-only",
                                   "--device", "cpu"]) == 0
    assert [d.type for d in built] == ["cpu"]


def test_cli_default_device_is_cuda(files):
    """Without --device the CLI asks for cuda, which fails without a CUDA
    device (and runs there with one)."""
    if torch.cuda.is_available():
        assert cli.main(list(files)) == 0
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(list(files))


def test_cli_runs_as_a_module(files):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-m", "ahocorasick_tpu_torch.cli", *files,
         "--overlapping", "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    err = proc.stderr.splitlines()
    assert [ln.split(":")[0] for ln in err] == [
        "build time", "patterns", "kind", "memory usage", "search time"]
    assert err[1] == "patterns: 12"
    assert "GB/s" in err[4]
    assert int(proc.stdout) > 0
