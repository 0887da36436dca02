"""The plain reference against a brute-force search on small inputs, for
the three operations, with case folding, the three match kinds and the
block control."""

import numpy as np
import pytest

from portbench.reference import Reference


def _fold(b: bytes) -> bytes:
    return bytes(c + 32 if 65 <= c <= 90 else c for c in b)


def brute_all(pats, hay, ci, block=None):
    f = _fold if ci else (lambda b: b)
    out = []
    for pid, p in enumerate(pats):
        for s in range(len(hay) - len(p) + 1):
            if block and s % block + len(p) > block:
                continue
            if f(hay[s:s + len(p)]) == f(p):
                out.append((pid, s, s + len(p)))
    return sorted(out, key=lambda t: (t[2], -len(pats[t[0]]), t[0]))


def brute_iter(pats, hay, ci, kind):
    """Non-overlapping search by its definition: from the cursor, the
    leftmost start (ties by pattern id, or by length then id), or for
    standard semantics the earliest end (ties: longest, then id)."""
    allm = brute_all(pats, hay, ci)
    out, cursor = [], 0
    while True:
        cand = [t for t in allm if t[1] >= cursor]
        if not cand:
            return out
        if kind == "standard":
            e = min(t[2] for t in cand)
            best = min((t for t in cand if t[2] == e),
                       key=lambda t: (-len(pats[t[0]]), t[0]))
        else:
            s = min(t[1] for t in cand)
            at = [t for t in cand if t[1] == s]
            key = ((lambda t: t[0]) if kind == "leftmost-first"
                   else (lambda t: (-len(pats[t[0]]), t[0])))
            best = min(at, key=key)
        out.append(best)
        cursor = best[2]


def case(seed):
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"abAB", np.uint8)
    pats = []
    for _ in range(int(rng.integers(1, 12))):
        L = int(rng.integers(1, 14))
        pats.append(alpha[rng.integers(0, 4, L)].tobytes())
    pats.append(pats[0].swapcase())       # equal under folding
    pats.append(pats[-1][:max(1, len(pats[-1]) // 2)])  # a prefix
    hay = alpha[rng.integers(0, 4, int(rng.integers(0, 400)))].tobytes()
    return pats, hay


@pytest.mark.parametrize("seed", range(12))
@pytest.mark.parametrize("ci", [False, True])
def test_overlapping_and_count_match_brute_force(seed, ci):
    pats, hay = case(seed)
    ref = Reference(pats, match_kind="standard", ascii_case_insensitive=ci)
    want = brute_all(pats, hay, ci)
    assert ref.find_overlapping_iter(hay) == want
    assert ref.count_matches(hay) == len(want)


@pytest.mark.parametrize("seed", range(12))
@pytest.mark.parametrize("kind", ["standard", "leftmost-first",
                                  "leftmost-longest"])
@pytest.mark.parametrize("ci", [False, True])
def test_find_iter_matches_brute_force(seed, kind, ci):
    pats, hay = case(seed)
    ref = Reference(pats, match_kind=kind, ascii_case_insensitive=ci)
    assert ref.find_iter(hay) == brute_iter(pats, hay, ci, kind)


def test_leftmost_first_prefers_the_earlier_pattern():
    hay = b"xxSamwise and Sam"
    for pats, want in ((["Samwise", "Sam"], [(0, 2, 9), (1, 14, 17)]),
                       (["Sam", "Samwise"], [(0, 2, 5), (0, 14, 17)])):
        ref = Reference([p.encode() for p in pats],
                        match_kind="leftmost-first",
                        ascii_case_insensitive=False)
        assert ref.find_iter(hay) == want


@pytest.mark.parametrize("seed", range(6))
def test_block_control_drops_exactly_the_crossing_matches(seed):
    pats, hay = case(seed)
    ref = Reference(pats, match_kind="standard",
                    ascii_case_insensitive=True, block=16)
    assert ref.find_overlapping_iter(hay) == brute_all(pats, hay, True, 16)


def test_rejects_empty_patterns_and_unknown_kinds():
    with pytest.raises(ValueError):
        Reference([b""], match_kind="standard", ascii_case_insensitive=False)
    with pytest.raises(ValueError):
        Reference([b"a"], match_kind="x", ascii_case_insensitive=False)
