"""The generators are deterministic for a seed and give the stated
sizes."""

import json
import os

import pytest

from portbench import harness
from portbench.reference import Reference

from .small import DICT5K, REPO

DICT_TEXT = {"generator": "dict_text", "density": 0.002,
             "filler_words": 4000, "filler_seed": 8}


def _config(name):
    with open(os.path.join(REPO, "portbench", "configs",
                           f"{name}.json")) as f:
        return json.load(f)


def patterns_of(spec):
    return harness.load_named(REPO, "generators",
                              spec["generator"]).patterns(spec)


def haystack_pool(text, pats, size, count, seed):
    return harness.load_named(REPO, "generators", text["generator"]).pool(
        text, pats, size, count, seed)


def test_names_are_deterministic_distinct_and_sized():
    spec = dict(DICT5K["patterns"], count=3000)
    a, b = patterns_of(spec), patterns_of(spec)
    assert a == b and len(a) == 3000 == len(set(a))
    assert all(6 <= len(p) <= 12 for p in a)
    caps = sum(p[:1].isupper() for p in a) / len(a)
    assert 0.25 < caps < 0.35


def test_literal_patterns():
    pats = patterns_of(_config("name-alt1")["patterns"])
    assert pats == [b"Sherlock", b"Street"]


def test_english_gives_the_sources_match_rate():
    """name-alt1 finds 158 matches in sherlock.txt's 594,915 B; the
    English-like stand-in plants the names at that rate on average."""
    cfg = _config("name-alt1")
    pats = patterns_of(cfg["patterns"])
    ref = Reference(pats, match_kind="leftmost-first",
                    ascii_case_insensitive=False)
    text = {"generator": "english", "name_rate": 0.0015}
    pool = haystack_pool(text, pats, 594_915, 16, 2**31 + 7)
    mean = sum(len(ref.find_iter(h)) for h in pool) / len(pool)
    assert 140 < mean < 176, mean


@pytest.mark.parametrize("config,text", [
    ("name-alt1", {"generator": "english", "name_rate": 0.0015}),
    ("dict5k", DICT_TEXT),
])
def test_haystacks_are_deterministic_and_sized(config, text):
    spec = (DICT5K if config == "dict5k" else _config(config))["patterns"]
    if spec["generator"] != "literal":
        spec = dict(spec, count=2000)
    pats = patterns_of(spec)
    for seed in (0, 2**31 + 12345, 2**70 + 3, -5):
        a = haystack_pool(text, pats, 70_001, 3, seed)
        assert [len(h) for h in a] == [70_001] * 3
        assert a == haystack_pool(text, pats, 70_001, 3, seed)
        assert len(set(a)) == 3
    assert (haystack_pool(text, pats, 70_001, 3, 1)
            != haystack_pool(text, pats, 70_001, 3, 2))
    ref = Reference(pats, match_kind="standard",
                    ascii_case_insensitive=True)
    hay = haystack_pool(text, pats, 300_000, 1, 7)[0]
    assert ref.count_matches(hay) > 0  # the patterns are planted


def test_unknown_generators_raise():
    with pytest.raises(harness.HarnessError):
        patterns_of({"generator": "nope"})
    with pytest.raises(harness.HarnessError):
        haystack_pool({"generator": "nope"}, [b"a"], 10, 1, 0)
