"""Teddy: per-position nybble fingerprints, then exact verification.

The PyTorch port of the JAX package's ``packed/teddy.py``. The reference's
Teddy (src/packed/teddy/README.md, generic.rs) fingerprints each position
with per-nybble PSHUFB lookups ANDed across 1-4 fingerprint bytes, mapping
patterns into 8 (Slim) or 16 (Fat) buckets; candidate positions are then
verified against the patterns in the flagged bucket (generic.rs:820-870).

The JAX package writes the 16-entry nybble lookup as a one-hot matmul:
``(onehot(lo_nybble(h[i+j])) @ M_lo[j])[b] > 0`` with ``M_lo[j]`` a
``[16, BUCKETS]`` 0/1 mask. Each one-hot row has a single nonzero, so that
product is the mask's row ``M_lo[j][lo_nybble(h[i+j])]`` itself; here the
row is read by an index, with the 8 buckets of a row packed into the bits
of one byte (``_bucket_bits``): the same candidate mask, bit for bit,
with one byte per position and fingerprint byte where the float32 one-hot
operands would take 64.

Candidate positions are compacted on the device (``torch.nonzero``, one
read back to the host) and verified on the host with vectorized window
compares (numpy, as in the JAX package); verified matches feed the same
leftmost selection as the core engine.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

BUCKETS = 8
MAX_FINGERPRINT = 4


class TeddyTables:
    """Host-built mask tables + bucket assignment."""

    def __init__(self, patterns: Sequence[bytes]):
        assert patterns and all(len(p) > 0 for p in patterns)
        self.patterns = list(patterns)
        self.min_len = min(len(p) for p in patterns)
        self.max_len = max(len(p) for p in patterns)
        self.mask_len = min(MAX_FINGERPRINT, self.min_len)
        # Bucket assignment: the reference groups patterns sharing a low
        # nybble of their first fingerprint byte (required there to keep
        # intra-bucket priority); our verification recovers exact
        # semantics via the leftmost filters, so buckets only affect
        # performance. Group by first-byte low nybble mod BUCKETS to keep
        # the masks sparse.
        self.buckets: List[List[int]] = [[] for _ in range(BUCKETS)]
        for pid, p in enumerate(patterns):
            self.buckets[(p[0] & 0xF) % BUCKETS].append(pid)
        # Masks [F, 16, BUCKETS] for low and high nybbles.
        f = self.mask_len
        m_lo = np.zeros((f, 16, BUCKETS), dtype=np.float32)
        m_hi = np.zeros((f, 16, BUCKETS), dtype=np.float32)
        for b, pids in enumerate(self.buckets):
            for pid in pids:
                p = patterns[pid]
                for j in range(f):
                    m_lo[j, p[j] & 0xF, b] = 1.0
                    m_hi[j, p[j] >> 4, b] = 1.0
        self.m_lo = m_lo
        self.m_hi = m_hi


def _bucket(n: int) -> int:
    return 1 << max(int(max(n, 1) - 1).bit_length(), 12)


def _bucket_bits(m: np.ndarray) -> np.ndarray:
    """[F, 16, BUCKETS] 0/1 masks as [F, 16] uint8: bit b of entry
    [j, v] is set where bucket b accepts nybble v at fingerprint byte j."""
    w = (1 << np.arange(BUCKETS)).astype(np.uint8)
    return ((m > 0).astype(np.uint8) * w).sum(axis=2).astype(np.uint8)


def _fingerprint(h: torch.Tensor, lo_bits: torch.Tensor,
                 hi_bits: torch.Tensor, n: int, f: int) -> torch.Tensor:
    """Per-position candidate mask: some bucket's fingerprint matches at
    start position i. ``h`` is the uint8 buffer [n_pad]; ``lo_bits`` /
    ``hi_bits`` the [F, 16] uint8 bucket bits; positions at or past ``n``
    (the valid start count) are masked. Returns bool [n_pad].

    Position i looks at byte i + j for fingerprint byte j; the JAX
    version's ``roll`` wraps the last j positions onto the buffer's head,
    and those lie past ``n`` whenever the buffer holds the haystack."""
    hb = h.to(torch.int64)
    lo, hi = hb & 0xF, hb >> 4
    cand = None
    for j in range(f):
        hit = (lo_bits[j][torch.roll(lo, -j)]
               & hi_bits[j][torch.roll(hi, -j)])
        cand = hit if cand is None else (cand & hit)
    idx = torch.arange(h.shape[0], device=h.device)
    return (cand != 0) & (idx < n)


class TeddySearcher:
    """Fingerprint-then-verify multi-substring searcher; the fingerprint
    runs on ``device``."""

    def __init__(self, patterns: Sequence[bytes], device="cuda"):
        self.tables = TeddyTables(patterns)
        self.device = torch.device(device)
        t = self.tables
        self._lo_bits = torch.from_numpy(_bucket_bits(t.m_lo)).to(
            self.device)
        self._hi_bits = torch.from_numpy(_bucket_bits(t.m_hi)).to(
            self.device)
        # Host verification tables: padded pattern matrix [K, max_len].
        k = len(t.patterns)
        self._plens = np.array([len(p) for p in t.patterns], dtype=np.int64)
        self._pmat = np.zeros((k, t.max_len), dtype=np.uint8)
        self._pmask = np.zeros((k, t.max_len), dtype=bool)
        for i, p in enumerate(t.patterns):
            self._pmat[i, : len(p)] = np.frombuffer(p, dtype=np.uint8)
            self._pmask[i, : len(p)] = True

    @property
    def minimum_len(self) -> int:
        # Like the reference, the vector engine needs a minimum haystack
        # (teddy/builder.rs minimum_len); ours is the fingerprint length
        # (roll wraparound is masked via the n bound).
        return self.tables.mask_len

    def candidate_mask(self, haystack: bytes) -> torch.Tensor:
        """The candidate mask [n_pad] bool on the device (n_pad the
        power-of-two bucket of the haystack, at least 4,096)."""
        n = len(haystack)
        buf = np.zeros(_bucket(n), dtype=np.uint8)
        buf[:n] = np.frombuffer(haystack, dtype=np.uint8)
        return _fingerprint(torch.from_numpy(buf).to(self.device),
                            self._lo_bits, self._hi_bits,
                            n - self.tables.mask_len + 1,
                            self.tables.mask_len)

    def candidates(self, haystack: bytes) -> np.ndarray:
        """Candidate match-start positions (ascending)."""
        if len(haystack) < self.tables.mask_len:
            return np.zeros(0, dtype=np.int64)
        return torch.nonzero(self.candidate_mask(haystack)).flatten() \
            .cpu().numpy()

    def verify(
        self, haystack: bytes, starts: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Exact window compare of every pattern at every candidate start.

        Returns (pids, starts, ends) of true matches, sorted by
        (start, pid). Vectorized host compare: candidates are sparse in
        realistic inputs (that is the point of the fingerprint).
        """
        if len(starts) == 0:
            z = np.zeros(0, dtype=np.int64)
            return z, z, z
        h = np.frombuffer(haystack, dtype=np.uint8)
        n = len(h)
        ml = self.tables.max_len
        # Gather candidate windows [C, max_len] (clip + mask tail).
        idx = starts[:, None] + np.arange(ml)[None, :]
        win = h[np.clip(idx, 0, n - 1)]
        in_range = idx < n
        # [C, K, max_len] compare (bool); K<=128, C sparse.
        eq = (win[:, None, :] == self._pmat[None, :, :]) & in_range[:, None, :]
        ok = np.all(eq | ~self._pmask[None, :, :], axis=2)
        ci, ki = np.nonzero(ok)
        pids = ki.astype(np.int64)
        ss = starts[ci]
        ends = ss + self._plens[ki]
        order = np.lexsort((pids, ss))
        return pids[order], ss[order], ends[order]

    def find_matches(self, haystack: bytes) -> Tuple[np.ndarray, ...]:
        """All (pid, start, end) matches of any pattern (sorted by
        (start, pid))."""
        return self.verify(haystack, self.candidates(haystack))
