"""Sequential oracle engine: a faithful replica of the reference search
loops, driven by the host-side NFA.

This engine plays the role the noncontiguous NFA plays in the reference's
test matrix (src/tests.rs:686-863): a slow-but-obviously-correct engine
every fast device kernel is validated against. It is also the production
path for the cases where exact reference semantics are automaton-defined
rather than filter-expressible:

  - anchored searches (each walk is bounded by max_pattern_len transitions
    since no failure transitions are followed, automaton.rs:1354-1366), and
  - leftmost semantics when an empty pattern is present (the interaction of
    the closed start-state loop, dead-fail rule and the init-match fallback
    in try_find_fwd_imp, automaton.rs:1292-1300).

Loops mirrored:
  - try_find_fwd_imp        automaton.rs:1284-1420
  - try_find_overlapping_fwd_imp  automaton.rs:1442-1537
  - FindIter::next incl. empty-match handling  automaton.rs:885-935
"""

from __future__ import annotations

from typing import Iterator, List, Optional

from .automata.noncontiguous import NFA
from .utils.search import Input, Match


def _get_match(nfa: NFA, sid: int, index: int, at: int) -> Match:
    pid = nfa.match_pattern(sid, index)
    length = nfa.pattern_len(pid)
    return Match(pid, at - length, at)


def try_find_fwd(
    nfa: NFA, input: Input, prefilter=None
) -> Optional[Match]:
    """Replicates automaton.rs:1259-1420; with a prefilter, unanchored
    searches skip from the start state to the next candidate position
    (automaton.rs:1385-1402 — prefilters never change results, only
    where the walk spends its time)."""
    if input.is_done():
        return None
    earliest = nfa.match_kind.is_standard() or input.earliest
    anchored = input.anchored
    if anchored.is_anchored():
        prefilter = None
    sid = nfa.start_state(anchored)
    start_id = nfa.special.start_unanchored_id
    at = input.start
    h = input.haystack
    mat: Optional[Match] = None
    if nfa.is_match(sid):
        mat = _get_match(nfa, sid, 0, at)
        if earliest:
            return mat
    while at < input.end:
        if prefilter is not None and sid == start_id and mat is None:
            c = prefilter.find_in(h, at, input.end)
            if c is None:
                return mat
            at = max(at, c.start)
            if at >= input.end:
                return mat
        sid = nfa.next_state(anchored, sid, h[at])
        if nfa.is_dead(sid):
            return mat
        if nfa.is_match(sid):
            m = _get_match(nfa, sid, 0, at + 1)
            # Anchored searches ignore matches that start past the search
            # start (copied via failure transitions), automaton.rs:1379.
            if not (anchored.is_anchored() and m.start > input.start):
                mat = m
                if earliest:
                    return mat
        at += 1
    return mat


class OverlappingState:
    """Resumable overlapping-search state (automaton.rs:781-827).

    ``_dev`` backs the state with a device-computed match list
    (facade fast path); it devolves to the exact oracle walk whenever
    the caller resumes with a different input."""

    __slots__ = ("mat", "id", "at", "next_match_index", "_dev")

    def __init__(self):
        self.mat: Optional[Match] = None
        self.id: Optional[int] = None
        self.at = 0
        self.next_match_index: Optional[int] = None
        self._dev = None  # [matches, next_idx, Input, drained] device-backed

    @classmethod
    def start(cls) -> "OverlappingState":
        return cls()

    def get_match(self) -> Optional[Match]:
        return self.mat


def try_find_overlapping_fwd(
    nfa: NFA, input: Input, state: OverlappingState
) -> None:
    """Replicates automaton.rs:1442-1537."""
    state.mat = None
    if input.is_done():
        return
    h = input.haystack
    anchored = input.anchored
    if state.id is None:
        sid = nfa.start_state(anchored)
        if nfa.is_match(sid):
            i = state.next_match_index or 0
            length = nfa.match_len(sid)
            if i < length:
                state.next_match_index = i + 1
                state.mat = _get_match(nfa, sid, i, input.start)
                return
        state.at = input.start
        state.id = sid
        state.next_match_index = None
        state.mat = None
    else:
        sid = state.id
        if state.next_match_index is not None:
            i = state.next_match_index
            length = nfa.match_len(sid)
            if i < length:
                state.next_match_index = i + 1
                state.mat = _get_match(nfa, sid, i, state.at + 1)
                return
            state.at += 1
            state.next_match_index = None
            state.mat = None
    while state.at < input.end:
        sid = nfa.next_state(anchored, sid, h[state.at])
        if nfa.is_dead(sid):
            state.id = sid
            return
        if nfa.is_match(sid):
            state.id = sid
            state.next_match_index = 1
            state.mat = _get_match(nfa, sid, 0, state.at + 1)
            return
        state.at += 1
    state.id = sid


def find_iter(
    nfa: NFA, input: Input, prefilter=None
) -> Iterator[Match]:
    """Replicates FindIter (automaton.rs:857-935)."""
    last_match_end: Optional[int] = None
    current = input
    while True:
        m = try_find_fwd(nfa, current, prefilter)
        if m is None:
            return
        if m.is_empty():
            # automaton.rs:908-920: an empty match abutting the previous
            # match's end is skipped by bumping the start by one.
            if last_match_end is not None and m.end == last_match_end:
                if current.start + 1 > current.end:
                    return  # the next search would be is_done()
                current = current.span(current.start + 1, current.end)
                m = try_find_fwd(nfa, current, prefilter)
                if m is None:
                    return
        current = current.span(m.end, current.end)
        last_match_end = m.end
        yield m


def find_overlapping_iter(nfa: NFA, input: Input) -> Iterator[Match]:
    state = OverlappingState.start()
    while True:
        try_find_overlapping_fwd(nfa, input, state)
        if state.mat is None:
            return
        yield state.mat


def find_all_overlapping(nfa: NFA, haystack: bytes) -> List[tuple]:
    """Full overlapping match set as (pid, start, end) triples."""
    return [m.astuple() for m in find_overlapping_iter(nfa, Input(haystack))]
