"""The ``dict-en-l10`` deployment: its generators give the numbers its
configuration states, the same output for the same seed, and a small run
of its cell is correct with the program and not with the control."""

import collections
import json
import os
import shutil
import time

import numpy as np
import pytest

from portbench import harness
from portbench.control import control_searcher
from portbench.reference import Reference

from .small import COPIED, REPO

CELL = "dict-en-l10.count.64MiB"
# Seeds the hit and near-miss rates were not tuned on.
FRESH = (2**31 + 977, 2**40 + 5)


def _json(*path):
    with open(os.path.join(REPO, *path)) as f:
        return json.load(f)


CONFIG = _json("portbench", "configs", "dict-en-l10.json")
WORKLOAD = _json("portbench", "workloads", f"{CELL}.json")


def _generator(name):
    return harness.load_named(REPO, "generators", name)


@pytest.fixture(scope="module")
def words():
    return _generator("dict_words").patterns(CONFIG["patterns"])


def test_words_have_the_sources_shape(words):
    spec = CONFIG["patterns"]
    assert len(words) == len(set(words)) == spec["count"] == 43_029
    assert words == sorted(words)
    assert all(w.isascii() and w.isalpha() and w.islower() for w in words)
    assert min(len(w) for w in words) == spec["min_len"] == 10
    assert sum(len(w) >= 15 for w in words) == spec["long_count"] == 2_663
    families = collections.Counter(w[:8] for w in words)
    assert len(families) == spec["prefixes"] == 18_743
    # A word drawn at random lies in a family of hit_family words on
    # average (E[s^2] / E[s] over the families' sizes s), +-5%.
    s = np.array(list(families.values()))
    hit = (s * s).sum() / s.sum()
    assert abs(hit / spec["hit_family"] - 1) < 0.05, hit
    assert sum(map(len, words)) == CONFIG["roofline"]["table_bytes"]
    assert words == _generator("dict_words").patterns(spec)


def _prefix_windows(hay: bytes, heads: np.ndarray, sizes: np.ndarray):
    """(byte positions whose 8-byte window is an entry's prefix, the
    summed family sizes of those windows: the cascade's expansion rows)."""
    a = np.frombuffer(hay, np.uint8).astype(np.uint64)
    key = np.zeros(len(a) - 7, np.uint64)
    for j in range(8):
        key = (key << np.uint64(8)) | a[j:len(a) - 7 + j]
    at = np.minimum(np.searchsorted(heads, key), len(heads) - 1)
    hit = heads[at] == key
    return int(hit.sum()), int(sizes[at[hit]].sum())


@pytest.mark.parametrize("seed", FRESH)
def test_prose_gives_the_sources_rates(words, seed):
    """Overlapping matches at 0.31% of byte positions (+-15%), exact
    8-byte-prefix windows at 0.86% (+-20%) and expansion rows per exact
    window at hit_family (+-15%), at 4 MiB."""
    n = 1 << 22
    hay = _generator("dict_prose").pool(WORKLOAD["text"], words, n, 1,
                                        seed)[0]
    assert len(hay) == n
    ref = Reference(words, match_kind="standard",
                    ascii_case_insensitive=False)
    rate = ref.count_matches(hay) / n
    assert 0.0031 * 0.85 < rate < 0.0031 * 1.15, rate
    families = collections.Counter(int.from_bytes(w[:8], "big")
                                   for w in words)
    heads = np.array(sorted(families), np.uint64)
    sizes = np.array([families[h] for h in sorted(families)])
    windows, rows = _prefix_windows(hay, heads, sizes)
    assert 0.0086 * 0.8 < windows / n < 0.0086 * 1.2, windows / n
    hit = CONFIG["patterns"]["hit_family"]
    assert abs(rows / windows / hit - 1) < 0.15, rows / windows


def test_prose_is_deterministic_and_misses_complete_nothing(words):
    text, pool = WORKLOAD["text"], _generator("dict_prose").pool
    a = pool(text, words, 100_003, 3, 2**33 + 1)
    assert [len(h) for h in a] == [100_003] * 3 and len(set(a)) == 3
    assert a == pool(text, words, 100_003, 3, 2**33 + 1)
    assert a != pool(text, words, 100_003, 3, 2**33 + 2)
    near = _generator("dict_prose").near_misses(words, text)
    heads = {w[:8] for w in words}
    assert len(near) > len(heads)
    assert all(w[:8] in heads for w in near)
    ref = Reference(words, match_kind="standard",
                    ascii_case_insensitive=False)
    assert ref.count_matches(b" ".join(near)) == 0
    long = _generator("dict_prose").long_words(words, text)
    assert len(set(long)) == text["long_words"]
    assert all(8 <= len(w) <= 9 and w[:8] not in heads for w in long)


def _small_root(tmp) -> str:
    """A root with the benchmark's files and the cell at 1 MiB, pool 2."""
    root = os.path.join(str(tmp), "root")
    os.makedirs(os.path.join(root, "portbench"))
    for d in COPIED:
        shutil.copytree(os.path.join(REPO, "portbench", d),
                        os.path.join(root, "portbench", d),
                        ignore=shutil.ignore_patterns("__pycache__"))
    bench = _json("BENCHMARK.json")
    small = dict(WORKLOAD, haystack_bytes=1 << 20, pool=2,
                 warmup_rounds=1, profile_calls=2)
    with open(os.path.join(root, "portbench", "workloads",
                           "dict.small.json"), "w") as f:
        json.dump(small, f)
    bench["workloads"].append(dict(
        next(w for w in bench["workloads"] if w["name"] == CELL),
        name="dict.small"))
    for m in bench["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append("dict.small")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root


def test_small_cell_is_correct_and_its_control_is_not(tmp_path):
    root = _small_root(tmp_path)

    def run(**kw):
        return harness.run("dict.small", 2**32 + 9, 1.0, False,
                           t_process=time.perf_counter(), root=root,
                           device="cpu", require_cuda=False, **kw)
    out = run()
    assert out["correct"] is True, out["checks"]
    assert set(out["metrics"]) == {"scan_GBps", "call_p95_ms", "setup_s"}
    out = run(searcher_factory=control_searcher)
    assert out["correct"] is False
    assert out["checks"]["wrong_calls"]["value"] > 0
