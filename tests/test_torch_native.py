"""The port's native C++ builder: its build location, the R1 gate, and
array equality with the Python builder and with the JAX package.

Outputs are integer arrays: the tolerance is exact equality.
"""

import os

import numpy as np
import pytest

import corpus
from ahocorasick_tpu.automata.dfa import build_dfa as jax_build_dfa
from ahocorasick_tpu.automata.noncontiguous import compile_nfa as jax_nfa
from ahocorasick_tpu.utils.search import MatchKind as JMatchKind
from ahocorasick_tpu_torch import _build
from ahocorasick_tpu_torch.automata import native
from ahocorasick_tpu_torch.automata.dfa import build_dfa
from ahocorasick_tpu_torch.automata.noncontiguous import (
    compile_nfa,
    patterns_to_bytes,
)
from ahocorasick_tpu_torch.utils.search import MatchKind
from torch_suite import per_test_time_limit  # noqa: F401

NFA_ARRAYS = ["fail", "depth", "match_starts", "match_pids", "trans_starts",
              "trans_bytes", "trans_next", "classes", "pattern_lens"]
DFA_ARRAYS = ["trans", "classes", "match_starts", "match_pids",
              "pattern_lens", "match_count"]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _same(a, b, names, ctx):
    assert a.num_states == b.num_states, ctx
    assert a.special.__dict__ == b.special.__dict__, ctx
    for name in names:
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                      err_msg=f"{ctx}: {name}")


def test_compact_map_gate():
    edge = 1 << 24
    assert not native.native_build_safe(edge - 2)
    assert native.native_build_safe(edge - 3)
    assert native.native_build_safe(edge - 1)
    assert native.native_build_safe(0)


def test_gate_sends_edge_sets_to_python_builder(monkeypatch):
    pats = [b"abc", b"abd", b"xyz"]
    total = sum(map(len, pats))
    want = compile_nfa(pats, builder="python")
    monkeypatch.setattr(native, "_COMPACT_MAP_EDGE", total + 2)
    assert native.compile_native(pats, 0, False) is None
    got = compile_nfa(pats, builder="auto")
    _same(got, want, NFA_ARRAYS, "gate")
    with pytest.raises(RuntimeError):
        compile_nfa(pats, builder="native")


def test_library_builds_outside_native_dir():
    if not native.available():
        pytest.skip("no C++ compiler on this machine")
    so = native._build_so()
    assert os.path.dirname(so) == _build.BUILD_DIR
    assert not so.startswith(os.path.join(REPO, "native") + os.sep)
    assert os.path.basename(so).startswith("acbuild-")
    assert os.path.exists(so[:-3] + ".log")


def _pattern_sets():
    seen = set()
    for group_name in dir(corpus):
        group = getattr(corpus, group_name)
        if not (group_name.isupper() and not group_name.startswith("AC_")
                and isinstance(group, list)):
            continue
        for _name, pats, _hay, _want in group:
            key = tuple(pats)
            if key not in seen:
                seen.add(key)
                yield list(pats)


@pytest.mark.parametrize("kind", ["standard", "leftmost-first",
                                  "leftmost-longest"])
def test_nfa_and_dfa_equal_jax_package(kind):
    for ci in (False, True):
        for pats in _pattern_sets():
            pb = patterns_to_bytes(pats)
            a = compile_nfa(pb, match_kind=MatchKind(kind),
                            ascii_case_insensitive=ci)
            b = jax_nfa(pb, match_kind=JMatchKind(kind),
                        ascii_case_insensitive=ci)
            _same(a, b, NFA_ARRAYS, (pats, kind, ci))
            _same(build_dfa(a), jax_build_dfa(b), DFA_ARRAYS,
                  (pats, kind, ci))


def test_native_builder_matches_python():
    if not native.available():
        pytest.skip("no C++ compiler on this machine")
    rng = np.random.default_rng(5)
    for _ in range(20):
        pats = [bytes(rng.choice([97, 98, 99, 65], size=int(
            rng.integers(1, 6))).astype(np.uint8)) for _ in range(8)]
        for kind in MatchKind:
            a = compile_nfa(pats, match_kind=kind, builder="native")
            b = compile_nfa(pats, match_kind=kind, builder="python")
            _same(a, b, NFA_ARRAYS, (pats, kind))
