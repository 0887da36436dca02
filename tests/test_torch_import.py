"""The port stands alone: importing it (its packed searcher, sharded
search and CLI included) loads neither JAX nor the JAX package, and no
source of the port (or chip_smoke.py) imports either."""

import os
import re
import subprocess
import sys

from torch_suite import per_test_time_limit  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|ahocorasick_tpu)(?:\.|\s|$)",
    re.MULTILINE,
)


def test_import_loads_no_jax():
    code = (
        "import sys, ahocorasick_tpu_torch as T\n"
        "T.AhoCorasick(['ab'], device='cpu').count_matches(b'xab')\n"
        "import ahocorasick_tpu_torch.serialize, ahocorasick_tpu_torch.stream\n"
        "from ahocorasick_tpu_torch.ops import staged, staged_kernels, "
        "fingerprint, fingerprint_kernels, compaction, cascade, block_scan, "
        "candidate_kernels, walk_kernels\n"
        "T.AhoCorasick(['abcdef', 'bcdefg'], device='cpu', engine='cascade', "
        "device_threshold=0).count_matches(b'xabcdefg' * 600)\n"
        "T.AhoCorasick(['ab', ''], device='cpu', engine='dfa-scan', "
        "device_threshold=0).count_matches(b'xabcdefg' * 600)\n"
        "T.AhoCorasick(['abcdef', 'bcdefg'], device='cpu', "
        "engine='fingerprint').count_matches(b'xabcdefg' * 600)\n"
        "import ahocorasick_tpu_torch.packed, ahocorasick_tpu_torch.cli\n"
        "from ahocorasick_tpu_torch.parallel import shard\n"
        "from ahocorasick_tpu_torch.packed import Config, teddy\n"
        "s = Config().device('cpu').only_teddy(True).builder().extend("
        "['abc', 'bcd']).build()\n"
        "assert [m.astuple() for m in s.find_iter(b'xabcd' * 900)][:1] == "
        "[(0, 1, 4)]\n"
        "ac = T.AhoCorasick(['ab', 'bc'], device='cpu')\n"
        "assert shard.sharded_bitap_count(ac._engine('bitap'), b'xabc' * 600, "
        "shard.make_mesh(4, 'cpu')) == 1200\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib')) or m == 'ahocorasick_tpu' or "
        "m.startswith('ahocorasick_tpu.'))\n"
        "print(bad)\n"
        "raise SystemExit(1 if bad else 0)\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _sources():
    pkg = os.path.join(REPO, "ahocorasick_tpu_torch")
    for root, _dirs, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_no_source_imports_jax_or_the_jax_package():
    srcs = list(_sources())
    assert len(srcs) > 20
    for path in srcs:
        with open(path) as f:
            text = f.read()
        assert not FORBIDDEN.search(text), path
