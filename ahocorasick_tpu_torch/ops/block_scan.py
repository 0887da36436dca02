"""Blocked parallel DFA walk on the device, and the host scalar walk.

The PyTorch port of the JAX package's ``ops/block_scan.py``. It recasts the
reference's sequential byte-at-a-time DFA walk (one dependent table lookup
per byte) as a lane-parallel blocked walk.

The unanchored Aho-Corasick automaton has the *suffix property*: the state
after scanning ``h[0..i]`` from the start state equals the state after
scanning only the last ``D`` bytes (``D = max_pattern_len``), because a
state is exactly the longest suffix of the scanned text that is a trie
path, and trie paths are at most ``D`` long. So the haystack is split into
B blocks of L bytes; each block's per-position states are computed
independently by walking from the start state over the block plus a
``D``-byte left halo. All B walks advance in lockstep: ``halo + L`` steps,
each one gather ``trans_flat[state * A + class]`` over the ``[B]`` state
vector. Block sizes, halo rounding and padding are the JAX package's.

On the card each walk is one kernel (ops/walk_kernels.py, csrc/dfa_walk.cu),
as in the JAX package it is one compiled ``lax.scan``: W1 writes the
per-position states (``match_positions``, ``scan_states``), W2 sums the
match counts inside the walk with no state array (``count_matches``); the
kernels cut the buffer into finer sub-blocks than the JAX layout, which the
suffix property allows. On the CPU the plain versions walk the JAX layout,
one torch step per byte of a block. The walk is still not the production
route: it serves the forced ``dfa-scan`` / ``device-only`` modes and the
facade's last resort when the native walk is unavailable, and a gather per
byte stays far below the filter engines (PERF.md: the dict1k 64 MiB count,
its kernel against the fingerprint route's). Production traffic takes the
bit-parallel, staged, fingerprint and cascade engines, or the native
interleaved C++ walk (automata/native.py).

The output is the full per-position state sequence, from which the
entire overlapping match set is derived (states index CSR match lists);
all match semantics are then O(#matches) filters (semantics.py).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..automata.dfa import DenseDFA
from ..utils import log
from . import walk_kernels as WK
from .bitap import upload


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _size_bucket(n: int) -> int:
    """Bucket haystack lengths: next power of two, minimum 4 KiB
    (power-of-two padding keeps block/lane splits exact)."""
    n = max(n, 4096)
    return 1 << (n - 1).bit_length()


def choose_block_len(n: int, halo: int) -> int:
    """Pick the serial block length L for an n-byte (power-of-two) buffer.

    The lane count B = n / L is a power of two from 1,024 to 8,192: more
    lanes (smaller L) until the halo overhead (halo/L) passes ~12%.
    """
    n = _size_bucket(n)
    lanes = 1024
    while lanes * 2 <= n // 128 and n // (lanes * 2) >= 8 * halo:
        lanes *= 2
    lanes = min(lanes, 8192)
    return max(n // lanes, 128)


def pack_haystack(haystack: bytes, halo: int):
    """The walk's host buffer: the haystack zero-padded to its size bucket,
    rounded up to whole blocks; returns (buf uint8, n, block_len, halo),
    the halo clamped to the bucket."""
    n = len(haystack)
    padded = _size_bucket(n)
    halo = min(halo, padded)
    block_len = choose_block_len(padded, halo)
    buf = np.zeros(_round_up(padded, block_len), dtype=np.uint8)
    buf[:n] = np.frombuffer(haystack, dtype=np.uint8)
    return buf, n, block_len, halo


def scan_states_host(dfa: DenseDFA, haystack: bytes) -> np.ndarray:
    """Host scalar reference walk over the dense table.

    Returns the per-position states: ``out[i]`` is the state after
    consuming ``haystack[i]`` from the unanchored start state, the same
    states as `DeviceAutomaton.scan_states`.
    """
    classes = dfa.classes.astype(np.int64)
    trans = dfa.trans
    n = len(haystack)
    out = np.empty(n, dtype=np.int32)
    s = dfa.special.start_unanchored_id
    c = classes[np.frombuffer(haystack, dtype=np.uint8)] if n else None
    for i in range(n):
        s = trans[s, c[i]]
        out[i] = s
    return out


class DeviceAutomaton:
    """Device-resident dense DFA tables + the blocked walk, on ``device``."""

    def __init__(self, dfa: DenseDFA, device="cuda"):
        self.dfa = dfa
        self.device = torch.device(device)
        self.alphabet_len = dfa.alphabet_len
        self.num_states = dfa.num_states
        self.start_id = dfa.special.start_unanchored_id
        self.max_match_id = dfa.special.max_match_id
        # Round the halo up to a power of two: a larger halo is still
        # correct (the suffix property needs *at least* max_pattern_len
        # bytes), and the block sizes stay the JAX package's.
        h = int(dfa.max_pattern_len)
        self.halo = h if h == 0 else 1 << (h - 1).bit_length()
        self.trans_flat = torch.from_numpy(
            dfa.trans.reshape(-1).astype(np.int32)).to(self.device)
        self.classes = torch.from_numpy(
            dfa.classes.astype(np.int32)).to(self.device)
        mc = (dfa.match_starts[1:] - dfa.match_starts[:-1]).astype(np.int64)
        self.match_count = torch.from_numpy(mc).to(self.device)

    # ------------------------------------------------------------------
    @log.spanned("prepare")
    def _prepare(self, haystack: bytes):
        """Pad the haystack into a bucketed device buffer; returns
        (buf, n, block_len, halo)."""
        with log.span("prepare.pack"):
            buf, n, block_len, halo = pack_haystack(haystack, self.halo)
        return upload(buf, self.device), n, block_len, halo

    def _states(self, haystack: bytes) -> Tuple[torch.Tensor, int]:
        buf, n, block_len, halo = self._prepare(haystack)
        log.count("passes")
        states = WK.walk_states(self.trans_flat, self.classes, buf,
                                self.alphabet_len, self.start_id, block_len,
                                halo)
        return states, n

    @log.spanned("pass")
    def match_positions(self, haystack: bytes):
        """Compacted match positions: (ends, state_ids) as host arrays.

        Runs the blocked walk on the device and compacts the (position,
        state) pairs of match states there, so only O(#matches) data comes
        back — the per-position states never leave the device. ``ends``
        are 1-based match end offsets (the start-state row at end 0 is the
        caller's concern)."""
        if len(haystack) == 0:
            return (np.zeros(0, np.int64), np.zeros(0, np.int64))
        states, n = self._states(haystack)
        pos, sids = _compact_matches(states, n, self.max_match_id)
        with log.read(2):
            return pos.cpu().numpy() + 1, sids.cpu().numpy()

    @log.spanned("pass")
    def scan_states(self, haystack: bytes) -> np.ndarray:
        """Per-position automaton states for an unanchored scan.

        Returns int32 array of length ``len(haystack)`` where entry ``i`` is
        the state after consuming byte ``i`` (the state "at position i+1").
        The state at position 0 is the start state (known statically).
        """
        if len(haystack) == 0:
            return np.zeros(0, dtype=np.int32)
        states, n = self._states(haystack)
        with log.read():
            return states[:n].cpu().numpy()

    @log.spanned("pass")
    def count_matches(self, haystack: bytes) -> int:
        """Total number of matches (overlapping semantics), summed inside
        the walk (W2 on the card): no state array is stored."""
        extra = 0
        # position 0 (start state) contributes when the empty pattern matches
        if 2 <= self.start_id <= self.max_match_id:
            extra = int(self.dfa.match_starts[self.start_id + 1]
                        - self.dfa.match_starts[self.start_id])
        if len(haystack) == 0:
            return extra
        buf, n, block_len, halo = self._prepare(haystack)
        log.count("passes")
        total = WK.walk_count(self.trans_flat, self.classes, buf,
                              self.alphabet_len, self.start_id, block_len,
                              halo, self.match_count, 0, n)
        with log.read():
            return int(total) + extra


def _compact_matches(states: torch.Tensor, n: int, max_match_id: int):
    """(positions, states) of the match states among the first n
    positions, in position order (int64)."""
    mask = (states[:n] >= 2) & (states[:n] <= max_match_id)
    with log.read():  # the count of match positions sizes the output
        pos = torch.nonzero(mask).flatten()
    return pos, states[pos].to(torch.int64)
