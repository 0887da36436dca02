"""Rabin-Karp rolling-hash fallback searcher.

Mirrors the role of the reference's packed Rabin-Karp
(src/packed/rabinkarp.rs): the fallback used when a haystack is too short
for the vectorized Teddy engine. 64 hash buckets keyed on a rolling hash
of the first ``min_len`` pattern bytes (rabinkarp.rs:55-82); the order of
patterns within a bucket follows the packed search order so that the
first verified hit respects the configured match kind
(rabinkarp.rs:39-46). Host-side by design — it only ever runs on tiny
haystacks.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

NUM_BUCKETS = 64
HASH_BASE = 256


class RabinKarp:
    def __init__(self, patterns: Sequence[bytes], order: Sequence[int]):
        """``order`` is the pattern priority order (see api.py): buckets
        list (hash, pid) entries in that order."""
        assert patterns and all(len(p) > 0 for p in patterns)
        self.patterns = list(patterns)
        self.hash_len = min(len(p) for p in patterns)
        self.buckets: List[List[Tuple[int, int]]] = [
            [] for _ in range(NUM_BUCKETS)
        ]
        for pid in order:
            p = patterns[pid]
            h = self._hash(p[: self.hash_len])
            self.buckets[h % NUM_BUCKETS].append((h, pid))

    def _hash(self, window: bytes) -> int:
        h = 0
        for b in window:
            h = (h * HASH_BASE + b) & 0xFFFFFFFF
        return h

    def find_at(
        self, haystack: bytes, at: int
    ) -> Optional[Tuple[int, int, int]]:
        """First match at or after ``at`` in packed priority order
        (rabinkarp.rs:86-116): scan positions left to right; at each
        position probe the hash bucket and verify candidates in bucket
        order."""
        n = len(haystack)
        hl = self.hash_len
        if n - at < hl:
            return None
        pow_msb = pow(HASH_BASE, hl - 1, 1 << 32)
        h = self._hash(haystack[at:at + hl])
        i = at
        while True:
            for cand_hash, pid in self.buckets[h % NUM_BUCKETS]:
                if cand_hash == h:
                    p = self.patterns[pid]
                    if haystack[i:i + len(p)] == p:
                        return (pid, i, i + len(p))
            if i + hl >= n:
                return None
            # Roll the hash window one byte right.
            h = (
                (h - haystack[i] * pow_msb) * HASH_BASE
                + haystack[i + hl]
            ) & 0xFFFFFFFF
            i += 1
