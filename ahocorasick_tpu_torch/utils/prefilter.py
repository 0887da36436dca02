"""Host-side prefilter framework — the analog of util/prefilter.rs.

The reference accelerates its sequential automaton walk by skipping ahead
to candidate positions with SIMD substring/byte scans (memmem, memchr1/2/3
over start bytes or heuristically rare bytes; util/prefilter.rs:163-305).
On TPU the device engines make prefilters unnecessary for bulk scans, but
the *host* paths (anchored searches, tiny haystacks, the oracle) walk
byte-at-a-time in Python; these prefilters vectorize their skip-ahead with
numpy, playing exactly the reference's role.

Candidate kinds mirror util/prefilter.rs:72-94: a prefilter may report a
confirmed match (single-pattern memmem) or a possible start position.

Selection heuristics (Builder, mirroring util/prefilter.rs:163-305):
  1. one pattern -> memmem (bytes.find; exact),
  2. <= 3 distinct first bytes -> start-bytes scan,
  3. <= 3 heuristically rare bytes (per BYTE_FREQUENCIES rank, each at
     some offset <= 255 within its pattern) -> rare-bytes scan with
     per-byte max-offset backoff,
  4. otherwise none (the automaton runs unassisted).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

# Heuristic byte "commonness" ranks (0 = rarest, 255 = most common) for
# text-ish haystacks. Unlike the reference's corpus-derived table
# (util/byte_frequencies.rs) this one is generated from a simple model:
# ASCII controls and high bytes are rare; letters, digits, space and
# common punctuation are frequent, with vowels/space at the top.
def _build_byte_frequencies() -> np.ndarray:
    f = np.zeros(256, np.int32)
    f[:] = 10                      # high bytes / controls: rare
    f[0x80:] = 20                  # UTF-8 continuation range: uncommon
    f[0x09] = 140                  # tab
    f[0x0A] = 160                  # newline
    for b in range(0x21, 0x30):    # punctuation
        f[b] = 60
    f[0x2E] = 120                  # '.'
    f[0x2C] = 120                  # ','
    for b in range(0x30, 0x3A):    # digits
        f[b] = 100
    for b in range(0x3A, 0x41):
        f[b] = 50
    for b in range(0x41, 0x5B):    # uppercase
        f[b] = 90
    for b in range(0x5B, 0x61):
        f[b] = 40
    # lowercase by rough English letter frequency
    common = b"etaoinshrdlcumwfgypbvkjxqz"
    for rank, ch in enumerate(common):
        f[ch] = 240 - rank * 6
    f[0x20] = 255                  # space
    return np.clip(f, 0, 255).astype(np.uint8)


BYTE_FREQUENCIES = _build_byte_frequencies()


class Candidate:
    """Prefilter result (util/prefilter.rs:72-94)."""

    __slots__ = ("kind", "start", "end")

    def __init__(self, kind: str, start: int, end: int = -1):
        self.kind = kind  # "match" | "possible-start"
        self.start = start
        self.end = end


class Memmem:
    """Single-pattern exact scan; candidates are confirmed matches."""

    def __init__(self, pattern: bytes):
        self.pattern = pattern

    def find_in(self, h: bytes, start: int, end: int) -> Optional[Candidate]:
        i = h.find(self.pattern, start, end)
        if i < 0:
            return None
        return Candidate("match", i, i + len(self.pattern))

    def memory_usage(self) -> int:
        return len(self.pattern)


class StartBytes:
    """<=3 distinct pattern start bytes -> next occurrence of any."""

    def __init__(self, byts: List[int]):
        self.bytes = bytes(sorted(byts))

    def find_in(self, h: bytes, start: int, end: int) -> Optional[Candidate]:
        best = -1
        for b in self.bytes:
            i = h.find(b, start, end)
            if i >= 0 and (best < 0 or i < best):
                best = i
        if best < 0:
            return None
        return Candidate("possible-start", best)

    def memory_usage(self) -> int:
        return len(self.bytes)


class RareBytes:
    """<=3 heuristically rare bytes, each at a bounded pattern offset.

    A hit at haystack position i for rare byte b with max offset o means a
    match could start as early as i - o (util/prefilter.rs:413-731)."""

    def __init__(self, byte_offsets: List[Tuple[int, int]]):
        self.byte_offsets = byte_offsets  # [(byte, max_offset)]

    def find_in(self, h: bytes, start: int, end: int) -> Optional[Candidate]:
        best = None
        for b, off in self.byte_offsets:
            i = h.find(b, start, end)
            if i >= 0:
                s = max(0, i - off)
                if best is None or s < best:
                    best = s
        if best is None:
            return None
        return Candidate("possible-start", best)

    def memory_usage(self) -> int:
        return 2 * len(self.byte_offsets)


RARE_THRESHOLD = 100  # frequency rank below which a byte counts as rare


def build(patterns: List[bytes],
          case_insensitive: bool = False) -> Optional[object]:
    """Heuristic prefilter selection (util/prefilter.rs:163-305)."""
    if not patterns or any(len(p) == 0 for p in patterns):
        return None

    def fold(b: int) -> List[int]:
        if case_insensitive and 0x61 <= (b | 0x20) <= 0x7A:
            return [b | 0x20, b & ~0x20]
        return [b]

    if len(patterns) == 1 and not case_insensitive:
        return Memmem(patterns[0])

    # start bytes
    starts = set()
    for p in patterns:
        starts.update(fold(p[0]))
    if len(starts) <= 3:
        # Only worthwhile when the start bytes are not ubiquitous.
        if max(int(BYTE_FREQUENCIES[b]) for b in starts) <= 250:
            return StartBytes(sorted(starts))

    # rare bytes: pick, per pattern, its rarest byte within offset 255;
    # accept when the union across patterns is <= 3 distinct bytes.
    chosen = {}
    for p in patterns:
        window = p[:256]
        ranks = [min(int(BYTE_FREQUENCIES[v]) for v in fold(b))
                 for b in window]
        o = int(np.argmin(ranks))
        if ranks[o] > RARE_THRESHOLD:
            return None
        for v in fold(window[o]):
            chosen[v] = max(chosen.get(v, 0), o)
        if len(chosen) > 3:
            return None
    return RareBytes(sorted(chosen.items()))
