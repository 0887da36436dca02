"""The port's match selection and its `Match` objects, on the CPU.

`semantics.select_non_overlapping` picks the non-overlapping matches with
array operations where no candidate is empty, and walks the candidates one
by one where one is; `overlapping_iter`, `MatchSet.match_at` and both build
their `Match` objects a block at a time. Here both paths are held against
the port's host oracle (`oracle.find_iter`, `oracle.find_overlapping_iter`,
`oracle.find_all_overlapping`) and against a candidate-by-candidate greedy
written out below, through the facade, `stream.py` and directly; the
counters ``select.built`` and ``select.loop`` say how many objects were
built and which path ran. Haystacks are small and walked on the host: the
file takes a few seconds and runs no JAX.
"""

import dataclasses
import io
import pickle

import numpy as np
import pytest

import ahocorasick_tpu_torch as T
from ahocorasick_tpu_torch import oracle, semantics, stream
from ahocorasick_tpu_torch.utils import log
from ahocorasick_tpu_torch.utils.search import Input, Match, MatchKind

KINDS = list(MatchKind)
SEEDS = [1, 2, 3]


def _triples(ms):
    return [m.astuple() for m in ms]


def _pats(seed, n=7, alpha=b"abc", longest=5):
    """Distinct short patterns over a small alphabet: candidates overlap,
    share starts, and are prefixes and suffixes of each other."""
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < n:
        k = int(rng.integers(1, longest + 1))
        p = bytes(rng.choice(list(alpha), k).astype(np.uint8))
        if p not in out:
            out.append(p)
    return out


def _hay(seed, n=3000, alpha=b"abc"):
    rng = np.random.default_rng(seed + 100)
    return rng.choice(list(alpha), n).astype(np.uint8).tobytes()


def _ac(pats, kind, **kw):
    # device_threshold above every haystack here: the host walk serves the
    # match sets, and the selection is what is under test.
    return T.AhoCorasick(pats, match_kind=kind, device="cpu",
                         device_threshold=1 << 30, **kw)


def _oracle_find_iter(ac, inp):
    return _triples(oracle.find_iter(ac._oracle_automaton(), inp,
                                     ac._prefilter()))


def _overlapping_set(ac, hay):
    t = oracle.find_all_overlapping(ac._match_nfa, hay)
    a = np.asarray(t, dtype=np.int64).reshape(-1, 3)
    return semantics.MatchSet(a[:, 0], a[:, 1], a[:, 2])


def _greedy(ms, kind, start_at=0):
    """FindIter::next over the candidates, one at a time (automaton.rs:
    885-935): the first candidate in selection order that starts at or
    after the search position, with the empty-match rule."""
    order = semantics._selection_order(ms, kind)
    cands = [(int(ms.pids[k]), int(ms.starts[k]), int(ms.ends[k]))
             for k in order]
    out, i, j, last = [], 0, start_at, None
    while True:
        while i < len(cands) and cands[i][1] < j:
            i += 1
        if i == len(cands):
            return out
        p, s, e = cands[i]
        if s == e and last == e:
            j += 1
            while i < len(cands) and cands[i][1] < j:
                i += 1
            if i == len(cands):
                return out
            p, s, e = cands[i]
        out.append((p, s + ms.offset, e + ms.offset))
        j = last = e


def _traced(fn):
    log.take()
    log.enable()
    try:
        out = fn()
    finally:
        log.disable()
    return out, log.take()


def _counter(records, name):
    return sum(r.get(name, 0) for r in records)


# ---------------------------------------------------------------------------
# The selection against the oracle
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kind", KINDS, ids=lambda k: k.value)
def test_facade_find_iter_equals_oracle(kind, seed):
    pats, hay = _pats(seed), _hay(seed)
    ac = _ac(pats, kind)
    got = _triples(ac.find_iter(hay))
    assert got == _oracle_find_iter(ac, Input(hay))
    assert len(got) > semantics.BLOCK  # more than one block of matches
    # An Input span that starts inside the haystack.
    inp = Input(hay, start=seed * 37, end=len(hay) - 11)
    assert _triples(ac.find_iter(inp)) == _oracle_find_iter(ac, inp)
    assert ac.find(hay).astuple() == got[0]


@pytest.mark.parametrize("start_at", [0, 1, 17, 2999, 3000])
@pytest.mark.parametrize("kind", KINDS, ids=lambda k: k.value)
def test_select_direct_equals_oracle(kind, start_at):
    """select_non_overlapping on the whole overlapping set from
    ``start_at`` equals the oracle's search of the span from there."""
    pats, hay = _pats(4), _hay(4)
    ac = _ac(pats, kind)
    ms = _overlapping_set(ac, hay)
    got = _triples(semantics.select_non_overlapping(ms, kind, start_at))
    assert got == _oracle_find_iter(ac, Input(hay, start=start_at))
    assert got == _greedy(ms, kind, start_at)
    first = semantics.first_non_overlapping(ms, kind, start_at)
    assert (first.astuple() if first is not None else None) == (
        got[0] if got else None)


@pytest.mark.parametrize("seed", SEEDS)
def test_standard_empty_pattern_takes_the_loop(seed):
    pats = [b""] + _pats(seed, n=5)
    hay = _hay(seed, n=1500)
    ac = _ac(pats, MatchKind.STANDARD)
    got, recs = _traced(lambda: _triples(ac.find_iter(hay)))
    assert got == _oracle_find_iter(ac, Input(hay))
    assert _counter(recs, "select.loop") > 0
    assert _counter(recs, "select.built") == len(got)
    inp = Input(hay, start=5, end=1400)
    assert _triples(ac.find_iter(inp)) == _oracle_find_iter(ac, inp)
    ms = _overlapping_set(ac, hay)
    for start_at in (0, 3, 700):
        assert _triples(semantics.select_non_overlapping(
            ms, MatchKind.STANDARD, start_at)) == _greedy(
                ms, MatchKind.STANDARD, start_at)


@pytest.mark.parametrize("seed", SEEDS)
def test_overlapping_iter_equals_oracle(seed):
    pats, hay = _pats(seed), _hay(seed, n=2000)
    ac = _ac(pats, MatchKind.STANDARD)
    full = _triples(ac.find_overlapping_iter(hay))
    assert len(full) > semantics.BLOCK
    for inp in (Input(hay), Input(hay, start=13, end=1900)):
        got = _triples(ac.find_overlapping_iter(inp))
        want = _triples(oracle.find_overlapping_iter(ac._match_nfa, inp))
        assert got == want
    ms = _overlapping_set(ac, hay)
    assert _triples(semantics.overlapping_iter(ms)) == full == [
        ms.match_at(i).astuple() for i in range(len(ms))]
    # The stateful overlapping search on the device route serves the same
    # stream from the list that overlapping_iter builds.
    dev = T.AhoCorasick(pats, device="cpu", device_threshold=0)
    state = oracle.OverlappingState.start()
    served = []
    while True:
        dev.find_overlapping(Input(hay), state)
        if state.mat is None:
            break
        served.append(state.mat.astuple())
    assert state._dev is not None and served == full


@pytest.mark.parametrize("chunk", [7, 64, 509, 1 << 20])
@pytest.mark.parametrize("seed", SEEDS[:2])
def test_stream_find_iter_equals_oracle(seed, chunk):
    """Chunks shorter than a pattern carry a cursor past the chunk start
    (``start_at > 0``) and an offset into the next round."""
    pats = _pats(seed, longest=9)
    hay = _hay(seed, n=2500)
    ac = _ac(pats, MatchKind.STANDARD)
    got = _triples(stream.stream_find_iter(ac, io.BytesIO(hay), chunk))
    assert got == _oracle_find_iter(ac, Input(hay))


@pytest.mark.parametrize("kind", KINDS, ids=lambda k: k.value)
def test_block_boundary_inside_an_overlap_chain(kind):
    """Candidates that overlap at every selected match, so the boundary
    between the first two blocks falls inside a chain of overlaps: "aba"
    repeated, against "ab", "ba", "aba" and "b"."""
    pats = [b"ab", b"ba", b"aba", b"b"]
    hay = b"aba" * 700
    ac = _ac(pats, kind)
    ms = _overlapping_set(ac, hay)
    got = _triples(semantics.select_non_overlapping(ms, kind))
    assert len(got) > semantics.BLOCK + 1
    assert got == _greedy(ms, kind) == _oracle_find_iter(ac, Input(hay))
    edge = got[semantics.BLOCK - 1]
    assert any(s < edge[2] and e > edge[1] and (p, s, e) != edge
               for p, s, e in zip(ms.pids.tolist(), ms.starts.tolist(),
                                  ms.ends.tolist()))


@pytest.mark.parametrize("kind", KINDS, ids=lambda k: k.value)
def test_random_match_sets_equal_the_greedy(kind):
    """Random candidate sets in MatchSet order, empty candidates in one of
    three, offsets and start positions."""
    rng = np.random.default_rng(7)
    for trial in range(300):
        n = int(rng.integers(0, 40))
        ends = np.sort(rng.integers(0, 60, n))
        lens = rng.integers(0 if trial % 3 == 0 else 1, 7, n)
        starts = np.maximum(ends - lens, 0)
        if trial % 3:
            keep = starts < ends
            starts, ends = starts[keep], ends[keep]
        pids = rng.integers(0, 4, len(ends))
        o = np.lexsort((pids, starts - ends, ends))
        ms = semantics.MatchSet(pids[o], starts[o], ends[o],
                                int(rng.integers(0, 9)))
        start_at = int(rng.integers(0, 12))
        want = _greedy(ms, kind, start_at)
        assert _triples(semantics.select_non_overlapping(
            ms, kind, start_at)) == want
        first = semantics.first_non_overlapping(ms, kind, start_at)
        assert (first.astuple() if first is not None else None) == (
            want[0] if want else None)


# ---------------------------------------------------------------------------
# Early stop and the counters
# ---------------------------------------------------------------------------
def test_early_stop_builds_at_most_one_block():
    pats, hay = _pats(1), _hay(1, n=6000)
    ac = _ac(pats, MatchKind.LEFTMOST_FIRST)
    total = len(list(ac.find_iter(hay)))
    assert total > 4 * semantics.BLOCK

    def first():
        it = iter(ac.find_iter(hay))
        m = next(it)
        it.close()
        return m

    m, recs = _traced(first)
    assert m.astuple() == _oracle_find_iter(ac, Input(hay))[0]
    assert 1 <= _counter(recs, "select.built") <= semantics.BLOCK
    # Untraced, a consumer that stops early leaves the rest unbuilt too.
    it = semantics.select_non_overlapping(_overlapping_set(ac, hay),
                                          MatchKind.LEFTMOST_FIRST)
    assert next(it).astuple() == m.astuple()


@pytest.mark.parametrize("kind", KINDS, ids=lambda k: k.value)
def test_try_find_builds_one(kind):
    pats, hay = _pats(2), _hay(2)
    ac = _ac(pats, kind)
    m, recs = _traced(lambda: ac.try_find(hay))
    assert m.astuple() == _oracle_find_iter(ac, Input(hay))[0]
    assert _counter(recs, "select.built") == 1
    assert _counter(recs, "select.loop") == 0


@pytest.mark.parametrize("kind", KINDS, ids=lambda k: k.value)
def test_counters_count_the_matches_and_the_loop(kind):
    pats, hay = _pats(3), _hay(3)
    ac = _ac(pats, kind)
    got, recs = _traced(lambda: list(ac.find_iter(hay)))
    assert _counter(recs, "select.built") == len(got) > semantics.BLOCK
    assert _counter(recs, "select.loop") == 0
    if kind.is_standard():
        got, recs = _traced(lambda: list(ac.find_overlapping_iter(hay)))
        assert _counter(recs, "select.built") == len(got)


# ---------------------------------------------------------------------------
# The Match contract, for objects the block helper builds
# ---------------------------------------------------------------------------
def _built():
    pids = np.array([0, 3, 1, 2], dtype=np.int64)
    starts = np.array([0, 5, 9, 9], dtype=np.int64)
    ends = np.array([4, 5, 12, 16], dtype=np.int64)
    return semantics._build(pids, starts, ends)


@pytest.mark.parametrize("i", range(4))
def test_match_contract(i):
    m = _built()[i]
    p, s, e = m.pattern, m.start, m.end
    ref = Match(p, s, e)
    assert type(m) is Match and type(p) is int and type(s) is int
    assert m == ref and hash(m) == hash(ref) and not (m != ref)
    assert m != Match(p + 1, s, e) and m != (p, s, e)
    assert repr(m) == repr(ref) == f"Match(pattern={p}, start={s}, end={e})"
    with pytest.raises(dataclasses.FrozenInstanceError):
        m.start = 1
    with pytest.raises(dataclasses.FrozenInstanceError):
        del m.end
    assert m.astuple() == dataclasses.astuple(m) == (p, s, e)
    assert m.span == ref.span and (m.span.start, m.span.end) == (s, e)
    assert len(m) == e - s and m.is_empty() == (s == e)
    back = pickle.loads(pickle.dumps(m))
    assert back == m and type(back) is Match
    assert {m: 1}[ref] == 1
    assert dataclasses.replace(m, start=s) == ref
