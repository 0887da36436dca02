"""Dense DFA compilation: failure transitions resolved at build time.

Compiles the sparse `NFA` (see noncontiguous.py) into a flat
`[num_states, alphabet_len]` int32 transition table in which every failure
transition has been pre-resolved, mirroring the behavioral contract of the
reference dense DFA (aho-corasick/src/dfa.rs:431-607): a search step is
a single table lookup `trans[state, byte_class]`.

TPU-first differences from the reference:
  - No premultiplied state IDs (the device engine computes the flat gather
    index itself) and no interleaved anchored copy (dfa.rs:441-460 doubles
    the table for StartKind::Both); anchored searches walk the NFA's trie
    edges directly on the host (oracle.py) — they are bounded by
    max_pattern_len transitions — so only the unanchored table is
    materialized at all.
  - Per-match-state pattern lists are CSR arrays (match_starts/match_pids)
    instead of Vec<Vec<PatternID>> (dfa.rs:99), ready for device gathers.

The table is built level-by-level over trie depth with vectorized row
inheritance: a state's row starts as a copy of its failure state's row
(strictly smaller depth) and its own trie edges overwrite. This reproduces
exactly the reference's build-time failure resolution (dfa.rs:556-593).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..utils.search import MatchKind
from .noncontiguous import DEAD, FAIL, NFA, Special


@dataclasses.dataclass
class DenseDFA:
    """Flat dense transition tables + match metadata, host (numpy) side."""

    trans: np.ndarray          # [N, A] int32, unanchored (failures resolved)
    classes: np.ndarray        # [256] uint8
    alphabet_len: int
    num_states: int
    special: Special
    match_starts: np.ndarray   # [N+1] int32 CSR
    match_pids: np.ndarray     # [nnz] int32
    pattern_lens: np.ndarray   # [P] int32
    min_pattern_len: int
    max_pattern_len: int
    match_kind: MatchKind

    def memory_usage(self) -> int:
        return (
            self.trans.nbytes
            + self.classes.nbytes + self.match_starts.nbytes
            + self.match_pids.nbytes + self.pattern_lens.nbytes
        )

    @property
    def match_count(self) -> np.ndarray:
        return self.match_starts[1:] - self.match_starts[:-1]


def build_dfa(nfa: NFA) -> DenseDFA:
    n = nfa.num_states
    a = nfa.alphabet_len
    classes = nfa.classes.astype(np.int32)

    # Per-state trie edges as (state, class, next) triples from the CSR.
    counts = (nfa.trans_starts[1:] - nfa.trans_starts[:-1]).astype(np.int64)
    edge_state = np.repeat(np.arange(n, dtype=np.int32), counts)
    edge_class = classes[nfa.trans_bytes]
    edge_next = nfa.trans_next

    trans = np.zeros((n, a), dtype=np.int32)  # DEAD-filled

    depth = nfa.depth.copy()
    # Sentinels and the start states take part in level 0 so that every
    # other state can inherit from its failure state (strictly smaller
    # depth). DEAD/FAIL rows stay all-DEAD.
    order_depth = depth.copy()
    order_depth[DEAD] = -1
    order_depth[FAIL] = -1
    su, sa = nfa.special.start_unanchored_id, nfa.special.start_anchored_id
    order_depth[su] = 0
    order_depth[sa] = 0

    max_depth = int(order_depth.max()) if n else 0
    # Precompute edge grouping by the depth of the source state.
    edge_depth = order_depth[edge_state]
    edge_order = np.argsort(edge_depth, kind="stable")
    edge_state = edge_state[edge_order]
    edge_class = edge_class[edge_order]
    edge_next = edge_next[edge_order]
    edge_depth = edge_depth[edge_order]
    level_bounds = np.searchsorted(edge_depth, np.arange(max_depth + 2))

    fail = nfa.fail
    for d in range(0, max_depth + 1):
        sids = np.flatnonzero(order_depth == d)
        if d > 0 and len(sids):
            trans[sids] = trans[fail[sids]]
        lo, hi = level_bounds[d], level_bounds[d + 1]
        if hi > lo:
            trans[edge_state[lo:hi], edge_class[lo:hi]] = edge_next[lo:hi]

    # The unanchored start row in the NFA already materializes the
    # self-loop (or its DEAD-closed variant), so the scatter above covered
    # all classes for the root; nothing more to do. The anchored table is
    # trie-only with missing entries DEAD, which the zeros-init provides.

    return DenseDFA(
        trans=trans,
        classes=nfa.classes,
        alphabet_len=a,
        num_states=n,
        special=nfa.special,
        match_starts=nfa.match_starts,
        match_pids=nfa.match_pids,
        pattern_lens=nfa.pattern_lens,
        min_pattern_len=nfa.min_pattern_len,
        max_pattern_len=nfa.max_pattern_len,
        match_kind=nfa.match_kind,
    )
