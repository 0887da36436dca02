"""The route of a candidate-dense English-like dictionary and the counters
of the engine fallback chain.

A dictionary of words of 10-17 letters under shared 8-letter prefixes
(families; the first one of 20 words, more than the device verify's
groups hold) over prose in which entries and near misses (a prefix and
at most one letter, completing no entry) are dense enough that the
cascade declines the input as hostile, and so does the fingerprint engine,
whose candidates would verify on the host: the count takes the device
DFA walk. On the CPU: 5,000 words over 256 KiB, held against the JAX
package's native walk, with the cascade's and the host verify's candidate
floors lowered so that they decline this small haystack as they decline
large ones. On the card (``cuda``): 43,029 words over 4 MiB, held against
the port's native walk on the host, with no threshold lowered. The JAX
package is imported by the CPU tests alone.
"""

import collections

import numpy as np
import pytest

import ahocorasick_tpu_torch as T
from ahocorasick_tpu_torch.ops import cascade as TC
from ahocorasick_tpu_torch.ops import fingerprint as TF
from ahocorasick_tpu_torch.utils import log
from torch_suite import per_test_time_limit  # noqa: F401

LETTERS = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", np.uint8)
SYLLABLES = [o + v for o in b"b c d f g l m n p r s t st tr pr con in".split()
             for v in b"a e i o u ou ea".split()]
SHORT = (b"the of and to a in is you that it he was for on are as with his "
         b"they at be this have from or one had by not but what").split()


def _dictionary(seed: int, k: int) -> list:
    """k distinct sorted words: 8-letter prefixes of syllables, each with
    a family of geometric size (the first of 20) of 2-9 more letters."""
    rng = np.random.default_rng(seed)
    words = set()
    while len(words) < k:
        head = b""
        while len(head) < 8:
            head += SYLLABLES[rng.integers(len(SYLLABLES))]
        size = 20 if not words else int(rng.geometric(0.45))
        for _ in range(size):
            if len(words) < k:
                tail = LETTERS[rng.integers(0, 26, int(rng.integers(2, 10)))]
                words.add(head[:8] + tail.tobytes())
    return sorted(words)


def _prose(seed: int, words: list, n: int) -> bytes:
    """n bytes of words: entries at 0.03 a word, near misses at 0.09,
    short common words otherwise."""
    rng = np.random.default_rng(seed)
    heads = sorted({w[:8] for w in words})
    near = [h + LETTERS[rng.integers(0, 26, j)].tobytes()
            for h in heads for j in (0, 1)]
    vocab = words + near + SHORT
    r = rng.random(n // 3)
    first = np.where(r < 0.03, 0, np.where(r < 0.12, len(words),
                                           len(words) + len(near)))
    size = np.where(r < 0.03, len(words), np.where(r < 0.12, len(near),
                                                   len(SHORT)))
    idx = first + (rng.random(len(r)) * size).astype(np.int64)
    hay = b" ".join(vocab[i] for i in idx.tolist())[:n]
    assert len(hay) == n
    return hay


def _traced(fn):
    log.take()
    log.enable()
    try:
        out = fn()
    finally:
        log.disable()
    return out, log.take()


def test_sample_route_answers_and_counters(monkeypatch):
    import ahocorasick_tpu as J

    pats = _dictionary(3, 5000)
    assert max(collections.Counter(p[:8] for p in pats).values()) == 20
    hay = _prose(5, pats, 1 << 18)
    ref = J.AhoCorasick(pats, device_threshold=1 << 62)
    monkeypatch.setattr(TC, "CAND_FLOOR", 1 << 10)
    monkeypatch.setattr(TF, "HOST_CAND_FLOOR", 1 << 10)
    ac = T.AhoCorasick(pats, device="cpu")
    (first, second), recs = _traced(
        lambda: (ac.count_matches(hay), ac.count_matches(hay)))
    assert first == second == ref.count_matches(hay) > 0
    # The cascade leads (over CASCADE_MIN_PATTERNS patterns) and declines
    # the candidate-dense input; so does the fingerprint engine, whose
    # candidates would verify on the host (a family of over 16 words keeps
    # DeviceVerify out); the device walk counts. Later calls pass over
    # both hostile engines.
    for rec in recs:
        assert rec["declined.cascade"] == 1
        assert rec["declined.fingerprint"] == 1
        assert rec["served.device_walk"] == 1 and rec["passes"] >= 1
        assert "pass.verify" not in rec
        assert not [k for k in rec if k.startswith("served.fingerprint")]
    assert recs[0]["candidates"] > TF.HOST_CAND_FLOOR
    assert recs[1]["passes"] == 1 and "candidates" not in recs[1]
    assert ac._engines["cascade"].hostile
    fp = ac._engines["fingerprint"]
    assert fp.dv is None and fp.hostile
    got = [m.astuple() for m in ac.find_overlapping_iter(hay)]
    assert got == [m.astuple() for m in ref.find_overlapping_iter(hay)]
    got = [m.astuple() for m in ac.find_iter(hay)]
    assert got == [m.astuple() for m in ref.find_iter(hay)]


def test_name_alt1_shaped_set_records_no_decline():
    import ahocorasick_tpu as J

    pats = [b"Sherlock", b"Street"]
    rng = np.random.default_rng(5)
    vocab = SHORT + pats
    idx = np.where(rng.random(100_000) < 0.02,
                   len(SHORT) + rng.integers(0, 2, 100_000),
                   rng.integers(0, len(SHORT), 100_000))
    hay = b" ".join(vocab[i] for i in idx.tolist())[:300_000]
    assert len(hay) == 300_000
    ac = T.AhoCorasick(pats, match_kind=T.MatchKind.LEFTMOST_FIRST,
                       device="cpu")
    got, (rec,) = _traced(lambda: [m.astuple() for m in ac.find_iter(hay)])
    ref = J.AhoCorasick(pats, match_kind=J.MatchKind.LEFTMOST_FIRST,
                        device_threshold=1 << 62)
    assert got == [m.astuple() for m in ref.find_iter(hay)] and got
    assert rec["served.fingerprint_device"] == 1
    assert not [k for k in rec if k.startswith("declined.")]
    assert "pass.verify" not in rec


@pytest.mark.cuda
def test_whole_dictionary_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    words = _dictionary(7, 43_029)
    hay = _prose(9, words, 1 << 22)
    want = T.AhoCorasick(words, device="cpu",
                         device_threshold=1 << 62).count_matches(hay)
    ac = T.AhoCorasick(words)
    got, recs = _traced(lambda: [ac.count_matches(hay) for _ in range(2)])
    assert got == [want] * 2 and want > 0
    for rec in recs:
        assert rec["declined.cascade"] == 1
        assert rec["declined.fingerprint"] == 1
        assert rec["served.device_walk"] == 1
        assert "pass.verify" not in rec
    assert recs[1]["passes"] == 1
