"""Two-stage staged count and extraction: prefix-chain flags, then an exact
rescan of the flagged streams.

The PyTorch port of the JAX package's ``ops/staged.py``; host logic,
thresholds, stream layout (``_layout``) and output layouts are copied
unchanged.

Stage 1 — fingerprint flags (kernel G3, ``staged_kernels.staged_flags``).
Each pattern contributes its first ``min(4, len)`` bytes as an
exact-prefix chain; all fingerprints pack into ``Kf`` limbs (typically 1
against the full set's K). One pass over the pad-byte padded haystack ORs
fingerprint end hits per stream, including the halo warm-up, so a full
match ending just inside a stream's countable region (whose fingerprint
lands in the halo) still flags it. An absent fingerprint hit proves the
stream has no full-match end: a match of pattern p ending at e contains
p's fingerprint ending at e - len + f <= e, and >= e - (H - 1), so it lies
inside the stream's scanned window (H >= max_pattern_len - 1 >= len - f).

Stage 2 — exact rescan of candidates (kernel G4,
``staged_kernels.staged_gathered``). The flagged streams are compacted
(``select_nonzero_words``) and the full-K masked scan runs over them, each
lane carrying its original stream id and reading that stream's row of the
upload itself, so position masking and counting are unchanged. (The JAX
package gathers the candidate rows into a stream-major copy first; the
Hopper kernels need no copy: the engine keeps the upload as it lies,
``rows [ns, Wb]``, and both stages read it.) Extraction also writes end
words for the candidate streams only and decodes them with
``decode_match_words(..., stream_map=cand)``.

Candidate overflow (more flagged streams than ``cap``) grows ``cap``;
past the number of streams the engine returns None and the caller falls
back to the single-pass bit-parallel engine.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..utils import log
from . import staged_kernels as _kernels
from .bitap import (
    LANES,
    BitapEngine,
    BitapTables,
    _pow2,
    _round_tiles,
    decode_match_words,
    stage,
)
from .compaction import select_nonzero_words

# Streams shorter than the full engine's: smaller blocks keep the
# per-stream candidate probability low on sparse inputs.
STAGED_L = 512
# Below this haystack size the single-pass engine wins (staging adds a
# fixed two-kernel + compaction overhead).
STAGED_MIN = 1 << 22
FINGERPRINT_BYTES = 4


def _fingerprints(patterns: List[bytes]) -> List[bytes]:
    return [p[:FINGERPRINT_BYTES] for p in patterns]


class StagedHaystack:
    """Device-resident staged-engine haystack: upload once, count many
    times (the production repeated-search path)."""

    __slots__ = ("n", "L", "Lc", "tiles", "rows")

    def __init__(self, n, L, Lc, tiles, rows):
        self.n = n
        self.L = L
        self.Lc = Lc
        self.tiles = tiles
        self.rows = rows        # [ns, L/4] int32 words, row s = stream s


class StagedEngine:
    """Count and extraction engine: fingerprint prefilter + exact
    rescan, on ``device``."""

    def __init__(self, patterns: List[bytes], case_insensitive: bool,
                 device="cuda"):
        self.patterns = patterns
        self.device = torch.device(device)
        self.full = BitapTables(patterns, case_insensitive)
        self.fp = BitapTables(_fingerprints(patterns), case_insensitive)
        h = max(self.full.max_pattern_len - 1, 1)
        self.halo = max(_pow2(h), 4)
        # Extraction caps persist per engine instance: settled once,
        # repeated searches take the first cap that fits.
        self._cap_s = 0
        self._cap_w = 0

    @classmethod
    def eligible(cls, patterns: List[bytes], n: int,
                 case_insensitive: bool = False) -> bool:
        return n >= STAGED_MIN and cls.set_eligible(patterns,
                                                    case_insensitive)

    @classmethod
    def set_eligible(cls, patterns: List[bytes],
                     case_insensitive: bool = False) -> bool:
        """The pattern set's part of `eligible`: whatever the size."""
        if not BitapEngine.eligible(patterns):
            return False
        fp = _fingerprints(patterns)
        # Staging pays off when fingerprints are materially cheaper.
        kf = (sum(len(p) for p in fp) + 31) // 32
        k = (sum(len(p) for p in patterns) + 31) // 32
        if kf * 2 > k:
            return False
        # Both stages run pad-padded (no position masking in stage 1).
        tables = BitapTables(patterns, case_insensitive)
        return tables.pad_byte is not None

    def _layout(self, n: int) -> Tuple[int, int, int]:
        L = max(self.halo, STAGED_L)
        tiles = max(1, _round_tiles(-(-n // (LANES * L))))
        Lc = min(L, 512)
        return L, Lc, tiles

    def _args(self):
        return (self.fp.device_tensors(self.device),
                self.full.device_tensors(self.device))

    @log.spanned("prepare")
    def prepare(self, hs: bytes) -> StagedHaystack:
        """Upload a haystack, padded with the pad byte to whole streams."""
        n = len(hs)
        L, Lc, tiles = self._layout(max(n, 1))
        ns = tiles * LANES
        pad = self.full.pad_byte
        assert pad is not None
        rows = stage(hs, ns * L, pad, self.device)
        return StagedHaystack(n, L, Lc, tiles, rows.view(ns, L // 4))

    # ------------------------------------------------------------------
    # The two stages
    # ------------------------------------------------------------------
    def flags(self, ph: StagedHaystack) -> torch.Tensor:
        """Stage 1: per-stream flag words [tiles, 8, 128] (G3)."""
        (lo, hi, sm, em), _ = self._args()
        log.count("passes")
        return _kernels.staged_flags(lo, hi, sm, em, ph.rows, self.halo)

    def candidates(self, ph: StagedHaystack,
                   cap: int) -> Tuple[int, torch.Tensor]:
        """(number of flagged streams, cand [cap]): the first ``cap``
        flagged stream ids in order, -1 past the count."""
        fl = self.flags(ph).reshape(-1)
        ncand, widx, _, live = select_nonzero_words(fl, cap)
        return ncand, torch.where(live, widx, -1)

    def rescan(self, ph: StagedHaystack, cand: torch.Tensor, extract: bool):
        """Stage 2 over the candidate streams (G4): (counts, words)."""
        _, (lo, hi, sm, em) = self._args()
        sid = cand.to(torch.int32).reshape(-1, 8, 128)
        return _kernels.staged_gathered(
            lo, hi, sm, em, self.full.end_limbs, sid, ph.rows, self.halo, 0,
            ph.n, extract,
        )

    # ------------------------------------------------------------------
    @log.spanned("pass")
    def match_pairs(self, hs):
        """All overlapping matches as (pids, ends), or None on candidate
        overflow (caller falls back).

        End words are written only for flagged candidate streams, so on
        match-sparse inputs the extraction costs about a count."""
        ph = hs if isinstance(hs, StagedHaystack) else None
        if ph is None:
            if len(hs) == 0:
                return np.zeros(0, np.int64), np.zeros(0, np.int64)
            ph = self.prepare(hs)
        if ph.n == 0:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        t = self.full
        Ke = len(t.end_limbs)
        L = ph.L
        ns = ph.tiles * LANES
        cap = max(self._cap_s, max(LANES, _pow2(ns // 8)))
        cap_w = max(self._cap_w, 4096)
        while cap <= ns:
            ncand, cand = self.candidates(ph, cap)
            if ncand > cap:
                cap = max(cap * 2, _pow2(ncand))
                continue
            counts, words = self.rescan(ph, cand, extract=True)
            flat = words.reshape(-1)
            while True:
                nnzw, wix, vals, _ = select_nonzero_words(flat, cap_w)
                if nnzw <= cap_w:
                    break
                cap_w = max(64, _pow2(nnzw))
            break
        else:
            return None
        self._cap_s = max(self._cap_s, cap)
        self._cap_w = max(self._cap_w, cap_w)
        with log.read():
            total = int(counts.sum())
        if total == 0:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        words_size = (cap // LANES) * L * Ke * LANES
        with log.read(3):
            wix, vals, cand = (x.cpu().numpy() for x in (wix, vals, cand))
        return decode_match_words(
            t, wix, vals.view(np.uint32), L, Ke, words_size,
            end_limbs=t.end_limbs, stream_map=cand,
        )

    @log.spanned("pass")
    def count_matches(self, hs) -> Optional[int]:
        """Exact overlapping-match count, or None when the candidate set
        overflowed the gather capacity (caller falls back)."""
        ph = hs if isinstance(hs, StagedHaystack) else None
        if ph is None:
            if len(hs) == 0:
                return 0
            ph = self.prepare(hs)
        if ph.n == 0:
            return 0
        ns = ph.tiles * LANES
        # Start with an optimistic rescan budget and grow on overflow:
        # the gather + stage-2 cost is proportional to cap, and most
        # workloads flag well under an eighth of the streams.
        cap = max(LANES, _pow2(ns // 8))
        while cap <= ns:
            ncand, cand = self.candidates(ph, cap)
            if ncand <= cap:
                counts, _ = self.rescan(ph, cand, extract=False)
                with log.read():
                    return int(counts.sum())
            cap = max(cap * 2, _pow2(ncand))
        return None
