"""The plain reference: multi-pattern search by exact window lookup.

Plain PyTorch (CPU or CUDA tensors), written from the semantics of the
`aho-corasick` crate (BurntSushi/aho-corasick 1.1.3) and independent of
the program: it imports nothing of ``ahocorasick_tpu_torch`` or of the JAX
package and takes nothing the program made.

Every occurrence of a pattern of length L is a window of L haystack bytes
equal to it (after ASCII case folding where the search folds). The
windows are packed four bytes to a word; each word is looked up in the
sorted words of the patterns of that length, level by level (the rank of
the prefix found so far, shifted left 32 bits, plus the next word), so a
window survives a level only while its prefix is some pattern's prefix.
The survivors of the last level are the matches; equal folded patterns
each report their own match, as the crate does.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

MATCH_KINDS = ("standard", "leftmost-first", "leftmost-longest")


def fold(x: torch.Tensor) -> torch.Tensor:
    """ASCII upper case to lower case, other bytes unchanged (uint8)."""
    upper = (x >= 65) & (x <= 90)
    return torch.where(upper, x + 32, x)


def _pack4(a: np.ndarray) -> np.ndarray:
    """Little-endian words of the 4-byte (or shorter, zero-extended)
    groups of each row of a [rows, k] uint8 array: [rows, ceil(k/4)]."""
    rows, k = a.shape
    parts = -(-k // 4)
    pad = np.zeros((rows, parts * 4), np.int64)
    pad[:, :k] = a
    pad = pad.reshape(rows, parts, 4)
    return (pad[..., 0] | pad[..., 1] << 8 | pad[..., 2] << 16
            | pad[..., 3] << 24)


class _Length:
    """The patterns of one length: per level, the sorted distinct keys;
    for the last level's ranks, a CSR of the pattern ids that share the
    key (ascending)."""

    def __init__(self, L: int, pids: np.ndarray, rows: np.ndarray, device):
        self.L = L
        words = _pack4(rows)                       # [m, levels]
        self.levels = []
        rank = np.zeros(len(pids), np.int64)
        for k in range(words.shape[1]):
            key = (rank << 32) | words[:, k]
            uniq, rank = np.unique(key, return_inverse=True)
            self.levels.append(torch.from_numpy(uniq).to(device))
        order = np.lexsort((pids, rank))
        counts = np.bincount(rank, minlength=len(uniq))
        self.start = torch.from_numpy(np.cumsum(counts) - counts).to(device)
        self.count = torch.from_numpy(counts).to(device)
        self.pids = torch.from_numpy(pids[order]).to(device)


class Reference:
    """All matches of ``patterns`` (non-empty bytes) in a haystack, with
    the crate's semantics: ``match_kind`` one of MATCH_KINDS, ASCII case
    folding where ``ascii_case_insensitive``.

    ``block`` (None for the reference) searches the haystack as
    independent blocks of that many bytes, dropping every match that
    crosses a block's end: a control that breaks the guarantee that every
    match is reported."""

    def __init__(self, patterns: List[bytes], *, match_kind: str,
                 ascii_case_insensitive: bool, device="cpu",
                 block: int = None):
        if match_kind not in MATCH_KINDS:
            raise ValueError(f"unknown match kind {match_kind!r}")
        if not patterns or any(len(p) == 0 for p in patterns):
            raise ValueError("the reference takes non-empty patterns")
        self.patterns = list(patterns)
        self.match_kind = match_kind
        self.ci = ascii_case_insensitive
        self.device = torch.device(device)
        self.block = block
        self.plens = np.array([len(p) for p in patterns], np.int64)
        by_len: Dict[int, List[int]] = {}
        for pid, p in enumerate(patterns):
            by_len.setdefault(len(p), []).append(pid)
        self.lengths = []
        for L, ids in sorted(by_len.items()):
            rows = np.frombuffer(b"".join(patterns[i] for i in ids),
                                 np.uint8).reshape(len(ids), L)
            if self.ci:
                rows = fold(torch.from_numpy(rows.copy())).numpy()
            self.lengths.append(_Length(L, np.array(ids, np.int64), rows,
                                        self.device))

    # ------------------------------------------------------------------
    def matches(self, hay: bytes) -> Tuple[np.ndarray, np.ndarray,
                                           np.ndarray]:
        """Every overlapping match as (pids, starts, ends) int64 arrays in
        the crate's overlapping report order: end ascending, then length
        descending, then pattern id ascending."""
        n = len(hay)
        x = torch.frombuffer(bytearray(hay), dtype=torch.uint8)
        x = x.to(self.device)
        if self.ci:
            x = fold(x)
        # word[i]: bytes i..i+3 little-endian, zero past the end.
        x64 = torch.cat([x.to(torch.int64),
                         torch.zeros(3, dtype=torch.int64,
                                     device=self.device)])
        word = (x64[:n] | x64[1:n + 1] << 8 | x64[2:n + 2] << 16
                | x64[3:n + 3] << 24)
        out_p, out_s = [], []
        for t in self.lengths:
            L = t.L
            if L > n:
                continue
            pos = torch.arange(n - L + 1, device=self.device)
            if self.block is not None:
                pos = pos[(pos % self.block) + L <= self.block]
            rank = torch.zeros_like(pos)
            for k, keys in enumerate(t.levels):
                r = min(4, L - 4 * k)
                w = word[pos + 4 * k]
                if r < 4:
                    w = w & ((1 << (8 * r)) - 1)
                key = (rank << 32) | w
                at = torch.searchsorted(keys, key).clamp_(max=len(keys) - 1)
                hit = keys[at] == key
                pos, rank = pos[hit], at[hit]
            cnt = t.count[rank]
            first = torch.repeat_interleave(t.start[rank], cnt)
            within = (torch.arange(len(first), device=self.device)
                      - torch.repeat_interleave(torch.cumsum(cnt, 0) - cnt,
                                                cnt))
            out_p.append(t.pids[first + within])
            out_s.append(torch.repeat_interleave(pos, cnt))
        if not out_p:
            z = np.zeros(0, np.int64)
            return z, z, z
        pids = torch.cat(out_p).cpu().numpy()
        starts = torch.cat(out_s).cpu().numpy()
        ends = starts + self.plens[pids]
        order = np.lexsort((pids, -self.plens[pids], ends))
        return pids[order], starts[order], ends[order]

    def count_matches(self, hay: bytes) -> int:
        return len(self.matches(hay)[0])

    def find_overlapping_iter(self, hay: bytes) -> List[Tuple[int, int,
                                                            int]]:
        p, s, e = self.matches(hay)
        return list(zip(p.tolist(), s.tolist(), e.tolist()))

    def find_iter(self, hay: bytes) -> List[Tuple[int, int, int]]:
        """Non-overlapping matches under the match kind: after each
        reported match the search resumes at its end. Standard semantics
        report the match that ends first (ties: the overlapping order);
        leftmost semantics the one that starts first, ties by pattern id
        (leftmost-first) or by length, then pattern id
        (leftmost-longest)."""
        p, s, e = self.matches(hay)
        if self.match_kind == "leftmost-first":
            order = np.lexsort((p, s))
        elif self.match_kind == "leftmost-longest":
            order = np.lexsort((p, -self.plens[p], s))
        else:
            order = np.arange(len(p))
        out, cursor = [], 0
        for pid, st, en in zip(p[order].tolist(), s[order].tolist(),
                               e[order].tolist()):
            if st >= cursor:
                out.append((pid, st, en))
                cursor = en
        return out
