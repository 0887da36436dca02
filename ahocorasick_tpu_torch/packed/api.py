"""Packed multi-substring search API: Config / Builder / Searcher.

The PyTorch port of the JAX package's ``packed/api.py``, with the same
names and behaviour. API parity with the reference packed engine
(src/packed/api.rs): a standalone searcher for small pattern sets
(PATTERN_LIMIT = 128, api.rs:11) supporting leftmost-first (default) and
leftmost-longest semantics (packed/mod.rs docs), with force-engine knobs
for testing and an inert searcher when an empty pattern is added
(api.rs:303-322).

Engine selection mirrors api.rs:529-546: haystacks shorter than the
vector engine's minimum length use Rabin-Karp; otherwise the default
engine is the exact bit-parallel engine (kernels G1/G2), or for sets
beyond its bounds the fingerprint engine (G5/G6), with Teddy (teddy.py)
for filter-hostile inputs and when forced.

Extension: ``Config.device`` names the torch device the engines run on
(default ``"cuda"``, which raises without a CUDA device; ``"cpu"`` runs
the kernels' plain PyTorch versions), as the facade's builder does.
"""

from __future__ import annotations

import enum
from typing import Iterable, Iterator, List, Optional, Sequence

import numpy as np

from ..ahocorasick import _resolve_device
from ..ops.bitap import BitapEngine
from ..ops.fingerprint import FingerprintEngine
from ..utils.search import Match, Span, as_bytes
from .rabinkarp import RabinKarp
from .teddy import TeddySearcher

PATTERN_LIMIT = 128


class MatchKind(enum.Enum):
    """Packed engines only support leftmost semantics (packed/api.rs:28)."""

    LEFTMOST_FIRST = "leftmost-first"
    LEFTMOST_LONGEST = "leftmost-longest"


class Config:
    def __init__(self):
        self._kind = MatchKind.LEFTMOST_FIRST
        self._force: Optional[str] = None  # None | "teddy" | "rabinkarp"
        self._device = "cuda"

    def match_kind(self, kind: MatchKind) -> "Config":
        self._kind = kind
        return self

    def only_teddy(self, yes: bool) -> "Config":
        self._force = "teddy" if yes else None
        return self

    def only_rabin_karp(self, yes: bool) -> "Config":
        self._force = "rabinkarp" if yes else None
        return self

    def device(self, device) -> "Config":
        """Extension: the torch device the engines run on ("cuda",
        "cuda:1", "cpu"); the default "cuda" raises at build time when no
        CUDA device is present."""
        self._device = device
        return self

    def builder(self) -> "Builder":
        return Builder(self)


class Builder:
    def __init__(self, config: Optional[Config] = None):
        self.config = config or Config()
        self._patterns: List[bytes] = []
        self._inert = False

    def add(self, pattern) -> "Builder":
        p = as_bytes(pattern)
        if len(p) == 0:
            # An empty pattern inerts the whole searcher (api.rs:303-322).
            self._inert = True
        elif len(self._patterns) >= PATTERN_LIMIT:
            self._inert = True
        else:
            self._patterns.append(p)
        return self

    def extend(self, patterns: Iterable) -> "Builder":
        for p in patterns:
            self.add(p)
        return self

    def __len__(self) -> int:
        return len(self._patterns)

    def minimum_len(self) -> int:
        return min((len(p) for p in self._patterns), default=0)

    def build(self) -> Optional["Searcher"]:
        if self._inert or not self._patterns:
            return None
        return Searcher(self._patterns, self.config)


class Searcher:
    """A leftmost-semantics multi-substring searcher."""

    def __init__(self, patterns: Sequence[bytes], config: Config):
        self.patterns = list(patterns)
        self.kind = config._kind
        self._force = config._force
        self.device = _resolve_device(config._device)
        # Priority order: leftmost-first = insertion order; leftmost-
        # longest = length-descending then insertion (packed/pattern.rs:
        # 84-97).
        ids = list(range(len(patterns)))
        if self.kind is MatchKind.LEFTMOST_LONGEST:
            ids.sort(key=lambda i: (-len(patterns[i]), i))
        self._order = ids
        self._rank_arr = np.zeros(len(patterns), dtype=np.int64)
        for r, pid in enumerate(ids):
            self._rank_arr[pid] = r
        self._teddy = (
            TeddySearcher(patterns, self.device)
            if self._force != "rabinkarp" else None
        )
        self._rk = RabinKarp(patterns, ids)
        self._min_len = min(len(p) for p in patterns)
        # Default engine: the exact bit-parallel kernels (ops/bitap.py)
        # cover the packed regime (<=128 patterns) directly; sets beyond
        # its 2048-byte bound ride the bucketed fingerprint engine
        # (ops/fingerprint.py — the production Teddy analog, device
        # verification included). Teddy and Rabin-Karp remain as
        # forceable backends (packed/api.rs:137-188 test-only knobs).
        self._bitap = None
        self._fp = None
        # The fingerprint engine (bucket planning, cuckoo verify tables)
        # is built lazily on first _match_set use: searchers that only
        # ever see short haystacks route to Rabin-Karp and never pay for
        # it (the reference builds Teddy eagerly but Teddy construction
        # is just mask fills, api.rs:529-546).
        self._fp_checked = False
        if self._force is None and BitapEngine.eligible(list(patterns)):
            self._bitap = BitapEngine(list(patterns), False, self.device)
        self._lens = np.array([len(p) for p in patterns], np.int64)

    def _fp_engine(self):
        if not self._fp_checked:
            self._fp_checked = True
            if (self._force is None and self._bitap is None
                    and FingerprintEngine.eligible(self.patterns)):
                self._fp = FingerprintEngine(self.patterns, False,
                                             self.device)
        return self._fp

    def _match_set(self, h: bytes):
        """Full overlapping (pids, starts, ends) via the active engine."""
        if self._bitap is not None:
            pids, ends = self._bitap.match_pairs(h)
            return pids, ends - self._lens[pids], ends
        fp = self._fp_engine()
        if fp is not None:
            got = fp.match_pairs(h)
            if got is not None:
                pids, ends = got
                return pids, ends - self._lens[pids], ends
            # Filter-hostile input: fall through to Teddy.
        return self._teddy.find_matches(h)

    @classmethod
    def new(cls, patterns: Iterable) -> Optional["Searcher"]:
        return Builder().extend(patterns).build()

    @classmethod
    def config(cls) -> Config:
        return Config()

    @classmethod
    def builder(cls) -> Builder:
        return Builder()

    def minimum_len(self) -> int:
        """Minimum haystack length for the vector engine (api.rs:627)."""
        return self._teddy.minimum_len if self._teddy else 0

    def memory_usage(self) -> int:
        """Heap bytes of the tables of every constructed engine — the
        analog of the reference's per-engine accounting (api.rs:633-638).
        Covers whichever engines are actually active (bitap /
        fingerprint / Teddy / Rabin-Karp), counted as the JAX package
        counts them."""
        total = sum(len(p) for p in self.patterns)
        if self._teddy:
            total += self._teddy.tables.m_lo.nbytes * 2
            total += self._teddy._pmat.nbytes + self._teddy._pmask.nbytes
        if self._bitap is not None:
            t = self._bitap.tables
            total += (t.lo.nbytes + t.hi.nbytes + t.start.nbytes
                      + t.end.nbytes + t.endbit_pid.nbytes)
        if self._fp is not None:
            t = self._fp.tables
            total += (t.lo.nbytes + t.hi.nbytes + t.start.nbytes
                      + t.end.nbytes)
            if self._fp.dv is not None:
                for (_m, _a, _b, _logT, tk, _gmax, gr) in (
                    self._fp.dv.classes.values()
                ):
                    total += tk.nbytes + gr.nbytes
        total += self._rank_arr.nbytes + self._lens.nbytes
        return total

    def match_kind(self) -> MatchKind:
        return self.kind

    # ------------------------------------------------------------------
    def _use_rk(self, n: int) -> bool:
        return (
            self._force == "rabinkarp"
            or self._teddy is None
            or n < max(self._teddy.minimum_len, 1)
        )

    def _teddy_find_from(
        self, haystack: bytes, at: int
    ) -> Optional[Match]:
        pids, starts, ends = self._match_set(haystack)
        keep = starts >= at
        pids, starts, ends = pids[keep], starts[keep], ends[keep]
        if len(pids) == 0:
            return None
        # Leftmost selection: min start, then priority rank.
        ranks = self._rank_arr[pids]
        best = np.lexsort((ranks, starts))[0]
        return Match(int(pids[best]), int(starts[best]), int(ends[best]))

    def find(self, haystack) -> Optional[Match]:
        return self.find_in(haystack, None)

    def find_in(self, haystack, span: Optional[Span]) -> Optional[Match]:
        """First (leftmost) match within span (api.rs:529-546)."""
        h = as_bytes(haystack)
        if span is None:
            span = Span(0, len(h))
        sub = h[span.start:span.end]
        if self._use_rk(len(sub)):
            got = self._rk.find_at(sub, 0)
            if got is None:
                return None
            pid, s, e = got
            return Match(pid, s + span.start, e + span.start)
        m = self._teddy_find_from(sub, 0)
        if m is None:
            return None
        return Match(m.pattern, m.start + span.start, m.end + span.start)

    def find_iter(self, haystack) -> Iterator[Match]:
        """Non-overlapping leftmost matches (api.rs:580-610)."""
        h = as_bytes(haystack)
        n = len(h)
        if self._use_rk(n):
            at = 0
            while at <= n - self._min_len:
                got = self._rk.find_at(h, at)
                if got is None:
                    return
                pid, s, e = got
                yield Match(pid, s, e)
                at = e
            return
        # One full-match-set pass; greedy non-overlapping selection.
        pids, starts, ends = self._match_set(h)
        if len(pids) == 0:
            return
        ranks = self._rank_arr[pids]
        order = np.lexsort((ranks, starts))
        j = 0
        for i in order:
            s, e = int(starts[i]), int(ends[i])
            if s >= j:
                yield Match(int(pids[i]), s, e)
                j = e
