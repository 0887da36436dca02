"""Core search types: Span, Match, MatchKind, StartKind, Anchored, Input.

TPU-native re-design of the search-type contracts of the reference crate
(see aho-corasick/src/util/search.rs:82-1148). These are plain Python
value types used at the API boundary; device code works on flat arrays.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Union


class MatchKind(enum.Enum):
    """The match semantics to use during a search.

    Mirrors the semantics contract of the reference
    (util/search.rs:1050-1114):

    - STANDARD: matches are reported in the order the underlying automaton
      observes them (earliest end first).
    - LEFTMOST_FIRST: the leftmost-starting match wins; ties are broken by
      pattern precedence (earlier-listed pattern wins).
    - LEFTMOST_LONGEST: the leftmost-starting match wins; ties are broken by
      pattern length (longest wins), then precedence.
    """

    STANDARD = "standard"
    LEFTMOST_FIRST = "leftmost-first"
    LEFTMOST_LONGEST = "leftmost-longest"

    def is_standard(self) -> bool:
        return self is MatchKind.STANDARD

    def is_leftmost(self) -> bool:
        return self in (MatchKind.LEFTMOST_FIRST, MatchKind.LEFTMOST_LONGEST)

    def is_leftmost_first(self) -> bool:
        return self is MatchKind.LEFTMOST_FIRST


class StartKind(enum.Enum):
    """The kinds of anchored starting configuration a searcher supports.

    Mirrors util/search.rs:1132-1148.
    """

    BOTH = "both"
    UNANCHORED = "unanchored"
    ANCHORED = "anchored"


class Anchored(enum.Enum):
    """Search-time anchor mode (util/search.rs:782-810)."""

    NO = "no"
    YES = "yes"

    def is_anchored(self) -> bool:
        return self is Anchored.YES


@dataclasses.dataclass(frozen=True)
class Span:
    """A half-open byte range ``[start, end)`` (util/search.rs:672-760)."""

    start: int
    end: int

    def __len__(self) -> int:
        return max(0, self.end - self.start)

    def is_empty(self) -> bool:
        return self.start >= self.end

    def contains(self, offset: int) -> bool:
        return not self.is_empty() and self.start <= offset < self.end


@dataclasses.dataclass(frozen=True, slots=True)
class Match:
    """A match: pattern ID plus the span of the haystack that matched.

    Mirrors util/search.rs:824-964. ``start``/``end`` are byte offsets into
    the haystack; ``end - start == len(patterns[pattern])``. Slotted, so
    that `semantics` can build matches in bulk through the slot setters.
    """

    pattern: int
    start: int
    end: int

    @property
    def span(self) -> Span:
        return Span(self.start, self.end)

    def is_empty(self) -> bool:
        return self.start == self.end

    def __len__(self) -> int:
        return self.end - self.start

    def astuple(self) -> tuple:
        return (self.pattern, self.start, self.end)


BytesLike = Union[bytes, bytearray, memoryview, str]


def as_bytes(haystack: BytesLike) -> bytes:
    if isinstance(haystack, str):
        return haystack.encode("utf-8")
    if isinstance(haystack, bytes):
        return haystack
    return bytes(haystack)


class Input:
    """Search configuration over a haystack.

    Mirrors util/search.rs:82-630: a haystack plus a span to search within,
    an anchor mode and an "earliest" flag. Construct with keyword arguments
    or via the fluent methods (which return new `Input`s).
    """

    __slots__ = ("haystack", "_start", "_end", "anchored", "earliest")

    def __init__(
        self,
        haystack: BytesLike,
        *,
        start: int = 0,
        end: Optional[int] = None,
        anchored: Anchored = Anchored.NO,
        earliest: bool = False,
    ):
        self.haystack = as_bytes(haystack)
        n = len(self.haystack)
        if end is None:
            end = n
        if not (0 <= start <= n and 0 <= end <= n):
            raise ValueError(
                f"span [{start}, {end}) out of bounds for haystack of length {n}"
            )
        self._start = start
        self._end = end
        self.anchored = anchored
        self.earliest = earliest

    # -- fluent API ---------------------------------------------------------
    def span(self, start: int, end: int) -> "Input":
        return Input(
            self.haystack,
            start=start,
            end=end,
            anchored=self.anchored,
            earliest=self.earliest,
        )

    def range(self, rng: range) -> "Input":
        return self.span(rng.start, rng.stop)

    def set_anchored(self, anchored: Anchored) -> "Input":
        return Input(
            self.haystack,
            start=self._start,
            end=self._end,
            anchored=anchored,
            earliest=self.earliest,
        )

    def set_earliest(self, yes: bool) -> "Input":
        return Input(
            self.haystack,
            start=self._start,
            end=self._end,
            anchored=self.anchored,
            earliest=yes,
        )

    # -- accessors ----------------------------------------------------------
    @property
    def start(self) -> int:
        return self._start

    @property
    def end(self) -> int:
        return self._end

    def get_span(self) -> Span:
        return Span(self._start, self._end)

    def is_done(self) -> bool:
        return self._start > self._end

    def __repr__(self) -> str:
        return (
            f"Input(len={len(self.haystack)}, span=[{self._start},"
            f" {self._end}), anchored={self.anchored.value},"
            f" earliest={self.earliest})"
        )


def to_input(value: Union[Input, BytesLike]) -> Input:
    """Coerce a haystack or Input into an Input (the `Into<Input>` analog)."""
    if isinstance(value, Input):
        return value
    return Input(value)
