"""Automaton adapters for set-intersection (transducer) search.

The reference ships `fst::Automaton` impls for its Aho-Corasick automata
(aho-corasick/src/transducer.rs — `Anchored` and `Unanchored` wrapper
types) so a sorted key set can be searched with Aho-Corasick pruning:
the key-set trie is walked while the AC automaton advances byte by byte,
dead states prune whole subtrees, and match states accept keys. The
reference compiles this adapter out by default (src/lib.rs:263-271);
here it is shipped active, with the `fst` crate's four-method automaton
interface (start / is_match / accept / can_match, transducer.rs:69-95)
reproduced verbatim and a self-contained sorted-key-set searcher
standing in for the external `fst` crate.

State is sticky on match (accept() returns the state unchanged once it
matches, transducer.rs:84-88): a key is accepted as soon as any prefix
of it contains (unanchored) / starts with (anchored) a pattern match.
"""

from __future__ import annotations

from typing import Iterable, Iterator, List, Union

from .utils.errors import MatchError
from .utils.search import Anchored as AcAnchored

DEAD = 0


def _automaton_of(aut):
    """Accept either the AhoCorasick facade or a host NFA backend."""
    inner = getattr(aut, "_match_nfa", None)
    return inner if inner is not None else aut


class Unanchored:
    """Unanchored Aho-Corasick search of a key set (transducer.rs:43-95).

    A key is accepted when any of its prefixes contains a pattern match
    anywhere (the automaton runs unanchored with its start self-loop).
    """

    _anchored = AcAnchored.NO

    def __init__(self, aut):
        self._outer = aut
        self._aut = _automaton_of(aut)
        # Fallible like the reference (transducer.rs:50-55): verify the
        # automaton supports this start kind by asking for a start state.
        start_kind = getattr(aut, "start_kind", None)
        if callable(start_kind):
            kind = start_kind()
            name = getattr(kind, "name", str(kind))
            want = ("ANCHORED" if self._anchored.is_anchored()
                    else "UNANCHORED")
            if name not in (want, "BOTH"):
                if self._anchored.is_anchored():
                    raise MatchError.invalid_input_anchored()
                raise MatchError.invalid_input_unanchored()

    def as_ref(self):
        """The wrapped automaton (transducer.rs:58-60)."""
        return self._outer

    def into_inner(self):
        return self._outer

    # fst::Automaton interface ------------------------------------------
    def start(self) -> int:
        return self._aut.start_state(self._anchored)

    def is_match(self, state: int) -> bool:
        return self._aut.is_match(state)

    def accept(self, state: int, byte: int) -> int:
        if self.is_match(state):
            return state  # sticky: a matched key stays matched
        return self._aut.next_state(self._anchored, state, byte)

    def can_match(self, state: int) -> bool:
        return not self._aut.is_dead(state)


class Anchored(Unanchored):
    """Anchored variant (transducer.rs:96-180): a key is accepted when a
    pattern match starts at the key's first byte (within any prefix)."""

    _anchored = AcAnchored.YES


def search_keys(
    searcher: Unanchored,
    keys: Iterable[Union[bytes, str]],
) -> Iterator[bytes]:
    """Keys of a SORTED key set accepted by the automaton wrapper.

    The stand-in for `fst::Set::search(...).into_stream()` in the
    reference's doc examples (transducer.rs:26-40): walks keys in order,
    reusing automaton states along shared prefixes (the sorted order
    makes the shared-prefix stack an implicit trie walk) and skipping
    every key under a prefix whose state is dead — the pruning that
    makes transducer search more than a per-key scan.
    """
    prev = b""
    states: List[int] = []  # states[i] = state after consuming prev[:i+1]
    skip_prefix = None  # dead prefix: keys under it are pruned wholesale
    for key in keys:
        k = key.encode() if isinstance(key, str) else bytes(key)
        if k < prev:
            raise ValueError("search_keys requires sorted keys")
        if skip_prefix is not None:
            if k[: len(skip_prefix)] == skip_prefix:
                continue
            skip_prefix = None
        # Longest common prefix with the previous key: reuse its states.
        lcp = 0
        limit = min(len(prev), len(k))
        while lcp < limit and prev[lcp] == k[lcp]:
            lcp += 1
        del states[lcp:]
        state = states[-1] if states else searcher.start()
        dead_at = None
        for i in range(lcp, len(k)):
            state = searcher.accept(state, k[i])
            states.append(state)
            if not searcher.can_match(state):
                dead_at = i
                break
        prev = k[: len(states)]
        if dead_at is not None:
            skip_prefix = k[: dead_at + 1]
            prev = skip_prefix
            continue
        if len(states) == len(k) and searcher.is_match(
            states[-1] if states else searcher.start()
        ):
            yield k
