"""Match-set extraction and match-semantics selection filters.

The device engine (ops/block_scan.py) produces per-position automaton
states for the *standard-semantics* automaton, whose match lists enumerate
every pattern occurrence (the suffix closure). This module turns those
states into the full overlapping match set, and implements all
non-overlapping match semantics as O(#matches) selection filters over that
set — replacing the reference's sequential search-restart loops
(automaton.rs:1284-1420 + FindIter automaton.rs:923-935) with
post-processing:

  - standard semantics: a restarted scan at ``j`` reports, at the first
    position ``e >= j`` where any pattern with ``start >= j`` ends, the
    longest such pattern. This follows from the suffix property: the
    restarted automaton's state at ``e`` matches exactly the patterns
    ending at ``e`` with length <= e - j, ordered longest-first (match
    lists are built own-match-first then failure-copied, i.e. by
    decreasing length; noncontiguous.rs:1357).
  - leftmost-first: the candidate with the smallest start wins, ties by
    pattern precedence (lowest pattern ID). Leftmost-first prefix pruning
    (noncontiguous.rs:1100-1114) is subsumed: a pruned pattern always loses
    the (start, pid) comparison to its earlier-listed prefix.
  - leftmost-longest: smallest start, ties by longest length then lowest
    pattern ID.

These filters are exact for: standard semantics always, and leftmost
semantics when no empty pattern is present (otherwise the facade falls
back to the oracle, whose walk defines the reference behavior).
"""

from __future__ import annotations

import collections
import itertools
from typing import Iterator, List, Optional

import numpy as np

from .automata.dfa import DenseDFA
from .utils import log
from .utils.search import Match, MatchKind

# Matches are built BLOCK at a time. A block's fixed cost (three slices,
# three `.tolist()`, four `map` passes: ~5 us) is ~2% of its objects'
# (~0.5 us each); blocks of 256-384 ran 5-15% slower with the garbage
# collector on, 640 and more no faster. A consumer that stops early pays
# for at most one block (a traced iterator takes log.STEP = 256 a step).
BLOCK = 512

# Match is frozen: its __setattr__ raises, its slot setters do not.
_new = object.__new__
_set_pattern = Match.pattern.__set__
_set_start = Match.start.__set__
_set_end = Match.end.__set__
_exhaust = collections.deque(maxlen=0).extend  # runs a map, keeps nothing


class MatchSet:
    """The full overlapping match set of a (sliced) haystack.

    Arrays are ordered by (end asc, state-list order), which is exactly the
    reference's overlapping iteration order. Offsets are relative to the
    slice that was scanned; `offset` shifts reported matches back into
    absolute haystack coordinates.
    """

    __slots__ = ("pids", "starts", "ends", "offset")

    def __init__(
        self,
        pids: np.ndarray,
        starts: np.ndarray,
        ends: np.ndarray,
        offset: int = 0,
    ):
        self.pids = pids
        self.starts = starts
        self.ends = ends
        self.offset = offset

    def __len__(self) -> int:
        return len(self.pids)

    def match_at(self, i: int) -> Match:
        return _build(
            self.pids[i:i + 1],
            self.starts[i:i + 1] + self.offset,
            self.ends[i:i + 1] + self.offset,
        )[0]


def _build(
    pids: np.ndarray, starts: np.ndarray, ends: np.ndarray
) -> List[Match]:
    """``Match(pids[i], starts[i], ends[i])`` for every row, without
    running the frozen dataclass's ``__init__``: each field goes in
    through its slot setter, one C-level pass per field."""
    out = list(map(_new, itertools.repeat(Match, len(pids))))
    _exhaust(map(_set_pattern, out, pids.tolist()))
    _exhaust(map(_set_start, out, starts.tolist()))
    _exhaust(map(_set_end, out, ends.tolist()))
    log.count("select.built", len(out))
    return out


def _iter_matches(
    pids: np.ndarray, starts: np.ndarray, ends: np.ndarray, offset: int
) -> Iterator[Match]:
    """The rows' matches, ``offset`` added to their starts and ends, in
    row order, built a block at a time."""
    starts, ends = starts + offset, ends + offset
    for lo in range(0, len(pids), BLOCK):
        hi = lo + BLOCK
        yield from _build(pids[lo:hi], starts[lo:hi], ends[lo:hi])


def extract_match_set(
    dfa: DenseDFA, states: np.ndarray, offset: int = 0
) -> MatchSet:
    """Expand per-position states into the full overlapping match set.

    ``states[i]`` is the automaton state after byte ``i`` (so matches there
    end at ``i + 1``); position 0 is the start state, which contributes
    matches at end 0 when the empty pattern is present.
    """
    sids = states.astype(np.int64)
    is_match = (sids >= 2) & (sids <= dfa.special.max_match_id)
    pos = np.flatnonzero(is_match)
    return extract_match_set_from_positions(
        dfa, pos + 1, sids[pos], offset
    )


def extract_match_set_from_positions(
    dfa: DenseDFA,
    ends_m: np.ndarray,
    sids_m: np.ndarray,
    offset: int = 0,
) -> MatchSet:
    """Match set from pre-compacted (end, state) pairs (ends ascending,
    1-based). Prepends the start-state row (end 0) when the start state
    is a match state — i.e. when the empty pattern is present."""
    start_id = dfa.special.start_unanchored_id
    if 2 <= start_id <= dfa.special.max_match_id:
        ends_m = np.concatenate([np.zeros(1, np.int64), ends_m])
        sids_m = np.concatenate(
            [np.full(1, start_id, np.int64), sids_m]
        )
    if len(ends_m) == 0:
        z = np.zeros(0, dtype=np.int64)
        return MatchSet(z, z, z, offset)
    sids_m = sids_m.astype(np.int64)
    ends_m = ends_m.astype(np.int64)
    offs = dfa.match_starts[sids_m].astype(np.int64)
    cnts = (dfa.match_starts[sids_m + 1] - dfa.match_starts[sids_m]).astype(
        np.int64
    )
    total = int(cnts.sum())
    # Vectorized CSR expansion preserving list order.
    cum = np.cumsum(cnts) - cnts  # exclusive prefix
    within = np.arange(total, dtype=np.int64) - np.repeat(cum, cnts)
    flat_idx = np.repeat(offs, cnts) + within
    pids = dfa.match_pids[flat_idx].astype(np.int64)
    ends = np.repeat(ends_m, cnts)
    starts = ends - dfa.pattern_lens[pids].astype(np.int64)
    return MatchSet(pids, starts, ends, offset)


def overlapping_iter(ms: MatchSet) -> Iterator[Match]:
    """The overlapping match stream (already in reference report order)."""
    yield from _iter_matches(ms.pids, ms.starts, ms.ends, ms.offset)


def _selection_order(ms: MatchSet, kind: MatchKind) -> np.ndarray:
    """Index order in which the greedy selector considers candidates."""
    if kind.is_standard():
        # Already ordered by (end, list order = length desc, pid asc).
        return np.arange(len(ms), dtype=np.int64)
    lens = ms.ends - ms.starts
    if kind is MatchKind.LEFTMOST_FIRST:
        # (start asc, pid asc); np.lexsort keys are last-key-primary.
        return np.lexsort((ms.pids, ms.starts))
    # leftmost-longest: (start asc, length desc, pid asc)
    return np.lexsort((ms.pids, -lens, ms.starts))


def _select_chain(
    starts: np.ndarray, ends: np.ndarray, start_at: int
) -> np.ndarray:
    """The greedy selection over candidates none of which is empty.

    The pick after candidate k is the first later candidate that starts
    at or after ``ends[k]``. Every candidate before k starts before the
    position the search had reached, which is below ``ends[k]``, so that
    is the first candidate of all with such a start: a search over the
    running maximum of the starts (the starts themselves under the
    leftmost kinds, where they are sorted). The chain of picks is then
    followed by doubling: ``path`` holds picks 0 .. 2^t - 1 and ``jump``
    each candidate's 2^t-th successor, with ``m`` as the end.
    """
    keys = np.maximum.accumulate(starts)
    m = len(keys)
    jump = np.append(np.searchsorted(keys, ends), m)
    path = np.searchsorted(keys, [start_at])
    while path[-1] < m:
        path = np.concatenate([path, jump[path]])
        jump = jump[jump]
    return path[path < m]


def _select_loop(
    starts: List[int], ends: List[int], start_at: int
) -> List[int]:
    """The greedy selection candidate by candidate, with the empty-match
    rule (automaton.rs:885-920)."""
    m_count = len(starts)
    sel = []
    i = 0
    j = start_at
    last_end: Optional[int] = None
    while True:
        # First candidate (in selection order) with start >= j. Entries
        # skipped here have start < j and stay disqualified forever since
        # j is non-decreasing, so the pointer never moves backwards.
        while i < m_count and starts[i] < j:
            i += 1
        if i == m_count:
            return sel
        e = ends[i]
        if starts[i] == e and last_end == e:
            # Empty match abutting the previous match: bump start by one
            # and re-select (automaton.rs:908-920).
            j += 1
            while i < m_count and starts[i] < j:
                i += 1
            if i == m_count:
                return sel
            e = ends[i]
        sel.append(i)
        # Do NOT advance the pointer past the emitted entry: an emitted
        # empty match stays selectable (j == end), exactly as a re-search
        # from the same position re-finds it in the reference; the empty
        # rule above then advances past it. Non-empty entries are skipped
        # naturally since their start < end == j.
        j = e
        last_end = e


def select_non_overlapping(
    ms: MatchSet, kind: MatchKind, start_at: int = 0
) -> Iterator[Match]:
    """Greedy non-overlapping selection, replicating FindIter::next
    (automaton.rs:923-935) including the empty-match suppression rule
    (automaton.rs:885-920).

    ``start_at`` is the initial search position relative to the scanned
    slice (usually 0). A set without empty matches takes the array path;
    one with an empty match (standard semantics with the empty pattern)
    walks its candidates one by one.
    """
    order = _selection_order(ms, kind)
    starts = ms.starts[order]
    ends = ms.ends[order]
    if (starts == ends).any():
        log.count("select.loop", len(order))
        sel = _select_loop(starts.tolist(), ends.tolist(), start_at)
    else:
        sel = _select_chain(starts, ends, start_at)
    rows = order[sel]
    yield from _iter_matches(
        ms.pids[rows], ms.starts[rows], ms.ends[rows], ms.offset
    )


def first_non_overlapping(
    ms: MatchSet, kind: MatchKind, start_at: int = 0
) -> Optional[Match]:
    """The first match of `select_non_overlapping`, built alone: the first
    candidate in selection order that starts at or after ``start_at`` (the
    empty-match rule needs an earlier match)."""
    order = _selection_order(ms, kind)
    hits = np.flatnonzero(ms.starts[order] >= start_at)
    return ms.match_at(int(order[hits[0]])) if len(hits) else None


def earliest_match(
    ms: MatchSet, start_at: int = 0
) -> Optional[Match]:
    """The "earliest" match semantics used by is_match / earliest searches:
    the first match a scanning automaton would enter (minimum end, then
    longest, then lowest pattern ID), regardless of the configured kind
    (automaton.rs:1266 forces earliest for standard; for leftmost kinds an
    earliest search also stops at the first match entered). That is the
    first standard-order candidate at or after ``start_at``."""
    return first_non_overlapping(ms, MatchKind.STANDARD, start_at)
