"""Contiguous NFA: the compressed single-array automaton backend.

The reference's contiguous NFA re-encodes the noncontiguous automaton
into one `Vec<u32>` where a state ID is its offset into the array, with
per-state formats chosen by shape (dense / one-transition / sparse;
aho-corasick/src/nfa/contiguous.rs:452-479, built from the
noncontiguous NFA at contiguous.rs:937-1009). This module provides the
same backend for this framework — used by the host walk paths when the
builder forces ``kind=CONTIGUOUS_NFA`` (and as the memory-efficient
representation for very large pattern sets, where the dense DFA table
is prohibitive: the reference's 100k-title example is 1.6 GB dense vs
21 MB contiguous, ahocorasick.rs:46-55).

Encoding (own design, one int32 word stream):

  - Offsets 0 and 1 are the DEAD and FAIL sentinels (one dummy word
    each), preserving the reference's DEAD=0 convention.
  - A state at offset ``o``:
      repr[o]   = kind(2 bits) | is_match(1 bit) | payload(29 bits)
                  kind 0: one transition, payload = input class
                  kind 1: sparse,        payload = transition count
                  kind 2: dense,         payload unused
      repr[o+1] = failure link (offset)
      if is_match: repr[o+2] = match CSR start, repr[o+3] = match count
      transitions:
        kind 0: one word: next offset
        kind 1: count words: (class << 24) | next   — next < 2^24, the
                same ID ceiling as the reference (contiguous.rs:414-418)
        kind 2: alphabet_len words indexed by class
  - Match pattern IDs are shared with the source NFA's CSR arrays (they
    are identical data; duplicating them would be pure waste).

States near the root (depth < dense_depth, default 3 as in the
reference, nfa/noncontiguous.rs:856) use the dense format since they are
hit constantly; deep states are one-transition or sparse.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..utils.errors import BuildError
from ..utils.search import Anchored, MatchKind
from .noncontiguous import DEAD, FAIL, NFA, Special

_ONE, _SPARSE, _DENSE = 0, 1, 2
_NEXT_LIMIT = 1 << 24


class ContiguousNFA:
    """Compressed automaton implementing the host Automaton protocol."""

    def __init__(self):
        self.repr: np.ndarray = np.zeros(2, np.int32)
        self.classes: np.ndarray = np.zeros(256, np.uint8)
        self.alphabet_len = 1
        self.match_kind = MatchKind.STANDARD
        self.match_pids: np.ndarray = np.zeros(0, np.int32)
        self.pattern_lens: np.ndarray = np.zeros(0, np.int32)
        self.min_pattern_len = 0
        self.max_pattern_len = 0
        self.num_states = 0
        self.special: Optional[Special] = None
        self.start_unanchored = 0
        self.start_anchored = 0

    # ------------------------------------------------------------------
    # Introspection
    # ------------------------------------------------------------------
    def memory_usage(self) -> int:
        return (
            self.repr.nbytes + self.classes.nbytes
            + self.match_pids.nbytes + self.pattern_lens.nbytes
        )

    def patterns_len(self) -> int:
        return int(len(self.pattern_lens))

    def pattern_len(self, pid: int) -> int:
        return int(self.pattern_lens[pid])

    # ------------------------------------------------------------------
    # Automaton protocol (oracle.py drives this)
    # ------------------------------------------------------------------
    def start_state(self, anchored: Anchored) -> int:
        return (
            self.start_anchored
            if anchored.is_anchored()
            else self.start_unanchored
        )

    def is_dead(self, sid: int) -> bool:
        return sid == DEAD

    def is_match(self, sid: int) -> bool:
        return sid > 1 and bool(self.repr[sid] & 4)

    def match_len(self, sid: int) -> int:
        return int(self.repr[sid + 3]) if self.repr[sid] & 4 else 0

    def match_pattern(self, sid: int, index: int) -> int:
        return int(self.match_pids[self.repr[sid + 2] + index])

    def _follow(self, sid: int, cls: int) -> int:
        """Trie edge by input class; FAIL when absent."""
        h = int(self.repr[sid])
        kind = h & 3
        base = sid + (4 if h & 4 else 2)
        if kind == _ONE:
            return int(self.repr[base]) if (h >> 3) == cls else FAIL
        if kind == _DENSE:
            return int(self.repr[base + cls])
        count = h >> 3
        seg = self.repr[base:base + count]
        # arithmetic >> would sign-extend classes >= 128; mask it off
        keys = (seg >> 24) & 0xFF
        i = np.searchsorted(keys, cls)
        if i < count and keys[i] == cls:
            return int(seg[i] & 0xFFFFFF)
        return FAIL

    def next_state(self, anchored: Anchored, sid: int, byte: int) -> int:
        cls = int(self.classes[byte])
        while True:
            if sid == DEAD:
                return DEAD
            nxt = self._follow(sid, cls)
            if nxt != FAIL:
                return nxt
            if anchored.is_anchored():
                return DEAD
            sid = int(self.repr[sid + 1])


def build_contiguous(nfa: NFA, dense_depth: int = 3) -> ContiguousNFA:
    """Re-encode a noncontiguous NFA (contiguous.rs:937-1009 analog).

    Two passes: emit every state with original IDs in the link slots,
    then remap links through the offset table (the remapper role,
    util/remapper.rs)."""
    c = ContiguousNFA()
    c.classes = nfa.classes
    c.alphabet_len = nfa.alphabet_len
    c.match_kind = nfa.match_kind
    c.match_pids = nfa.match_pids
    c.pattern_lens = nfa.pattern_lens
    c.min_pattern_len = nfa.min_pattern_len
    c.max_pattern_len = nfa.max_pattern_len
    c.num_states = nfa.num_states
    c.special = nfa.special

    N = nfa.num_states
    words = [np.zeros(2, np.int64)]  # DEAD, FAIL dummy words
    offsets = np.zeros(N, np.int64)
    pos = 2
    cls_of = nfa.classes.astype(np.int64)
    link_slots = []  # indices (into the final array) holding state IDs

    for sid in range(2, N):
        offsets[sid] = pos
        t0, t1 = int(nfa.trans_starts[sid]), int(nfa.trans_starts[sid + 1])
        tb = cls_of[nfa.trans_bytes[t0:t1]]
        tn = nfa.trans_next[t0:t1].astype(np.int64)
        # byte-sorted edges may repeat per class; classes preserve order
        ucls, first = np.unique(tb, return_index=True)
        tn = tn[first]
        ntrans = len(ucls)
        m0, m1 = int(nfa.match_starts[sid]), int(nfa.match_starts[sid + 1])
        is_match = m1 > m0
        dense = int(nfa.depth[sid]) < dense_depth
        if dense:
            kind, payload = _DENSE, 0
        elif ntrans == 1:
            kind, payload = _ONE, int(ucls[0])
        else:
            kind, payload = _SPARSE, ntrans
        hdr_len = 4 if is_match else 2
        st = np.zeros(
            hdr_len
            + (c.alphabet_len if dense else (1 if kind == _ONE else ntrans)),
            np.int64,
        )
        st[0] = kind | (4 if is_match else 0) | (payload << 3)
        st[1] = int(nfa.fail[sid])
        link_slots.append(pos + 1)
        if is_match:
            st[2] = m0
            st[3] = m1 - m0
        if dense:
            body = np.full(c.alphabet_len, FAIL, np.int64)
            body[ucls] = tn
            st[hdr_len:] = body
            nz = np.flatnonzero(body != FAIL)
            link_slots.extend((pos + hdr_len + nz).tolist())
        elif kind == _ONE:
            st[hdr_len] = tn[0]
            link_slots.append(pos + hdr_len)
        else:
            st[hdr_len:] = tn  # class tag folded in after remap
        words.append(st)
        pos += len(st)

    flat = np.concatenate(words)
    if pos >= _NEXT_LIMIT:
        # State IDs in the contiguous encoding are word offsets into
        # `repr`, capped at 2^24-1 (cf. contiguous.rs:414-418).
        raise BuildError.state_id_overflow(_NEXT_LIMIT - 1, pos)
    # Remap original state IDs -> offsets. DEAD(0)/FAIL(1) map to selves.
    remap = np.zeros(N, np.int64)
    remap[0], remap[1] = DEAD, FAIL
    remap[2:] = offsets[2:]
    for idx in link_slots:
        flat[idx] = remap[flat[idx]]
    # Sparse bodies: remap nexts and fold the class tags now.
    pos2 = 2
    for sid in range(2, N):
        h = int(flat[pos2])
        kind = h & 3
        hdr_len = 4 if h & 4 else 2
        if kind == _SPARSE:
            ntrans = h >> 3
            base = pos2 + hdr_len
            t0 = int(nfa.trans_starts[sid])
            t1 = int(nfa.trans_starts[sid + 1])
            tb = cls_of[nfa.trans_bytes[t0:t1]]
            ucls, first = np.unique(tb, return_index=True)
            nexts = remap[nfa.trans_next[t0:t1].astype(np.int64)[first]]
            flat[base:base + ntrans] = (ucls << 24) | nexts
            body_len = ntrans
        elif kind == _ONE:
            body_len = 1
        else:
            body_len = c.alphabet_len
        pos2 += hdr_len + body_len
    assert pos2 == pos, (pos2, pos)
    c.repr = flat.astype(np.int32)
    c.start_unanchored = int(remap[nfa.special.start_unanchored_id])
    c.start_anchored = int(remap[nfa.special.start_anchored_id])
    # Protocol shim: oracle's prefilter check reads
    # special.start_unanchored_id in this automaton's ID space.
    c.special = Special(
        max_match_id=-1,
        start_unanchored_id=c.start_unanchored,
        start_anchored_id=c.start_anchored,
    )
    return c
