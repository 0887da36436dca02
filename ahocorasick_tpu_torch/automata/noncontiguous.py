"""Trie + BFS failure-link construction (host side).

This is the single construction path of the framework: every other automaton
representation (dense DFA device tables, anchored tables) is compiled from
the `NFA` built here, mirroring the role of the reference's noncontiguous
NFA (aho-corasick/src/nfa/noncontiguous.rs — behavioral contract only;
the data layout here is our own, flat numpy arrays for TPU compilation).

Behavioral contracts replicated exactly (with reference citations):

- Trie construction with ASCII case-folding twin transitions
  (noncontiguous.rs:1120-1141) and leftmost-first prefix pruning: a pattern
  whose proper prefix is an earlier-listed pattern is never added
  (noncontiguous.rs:1100-1114).
- BFS failure fill in byte-sorted child order (transition lists are kept
  byte-sorted, noncontiguous.rs:381-423), with the leftmost "dead fail"
  rule: under leftmost semantics any match state gets fail=DEAD and
  receives no copied matches (noncontiguous.rs:1296-1350).
- Match copying: when a state's failure is resolved, the failure state's
  match list is appended to the state's list (noncontiguous.rs:1357); under
  standard semantics every dequeued state also receives a copy of the start
  state's matches (noncontiguous.rs:1359-1371). Copy timing (and hence
  list order and any duplicates) is replicated faithfully, since match list
  order defines overlapping-iteration order.
- The unanchored start state has an implicit self-loop on all bytes with no
  trie edge (noncontiguous.rs:1597-1606), which is closed (redirected to
  DEAD) when the start state is a match state under leftmost semantics
  (noncontiguous.rs:1620-1638).
- The anchored start state shares the unanchored start's transitions and
  matches but has fail=DEAD (noncontiguous.rs:1561-1586).
- Byte classes: bytes not distinguished by any pattern share an equivalence
  class (util/alphabet.rs:191-251).

State ID layout after construction (our own, chosen so that match/dead
checks are single integer comparisons on device, in the spirit of
util/special.rs):

    0 = DEAD, 1 = reserved (FAIL sentinel, never reachable),
    2 .. 2+num_match_states-1 = match states (includes the start states
        when the empty pattern is present),
    then the start states (if not match states), then non-match states.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

from ..utils.errors import BuildError
from ..utils.search import Anchored, MatchKind

DEAD = 0
FAIL = 1

# Patterns and state counts are bounded by int32 device arrays; keep the
# reference's SmallIndex-style bound (util/primitives.rs:92-117).
MAX_SMALL_INDEX = 2**31 - 2


def opposite_ascii_case(b: int) -> int:
    """util/prefilter.rs:909 — the other case of an ASCII letter, else b."""
    if 0x41 <= b <= 0x5A:  # A-Z
        return b + 32
    if 0x61 <= b <= 0x7A:  # a-z
        return b - 32
    return b


class _ByteClassSet:
    """Accumulates byte ranges that must be distinguished.

    Mirrors the semantics of util/alphabet.rs:191-251: `set_range(b, b)`
    marks b as needing its own class; maximal runs of unmarked bytes share
    a class. Always produces at least one class; bytes 0..255 are covered.
    """

    def __init__(self):
        # boundary[i] == True means a class boundary AFTER byte i.
        self.boundary = np.zeros(256, dtype=bool)
        self.any_set = False

    def set_range(self, start: int, end: int) -> None:
        self.any_set = True
        if start > 0:
            self.boundary[start - 1] = True
        self.boundary[end] = True

    def byte_classes(self) -> np.ndarray:
        """Return a [256] uint8 map byte -> class index."""
        classes = np.zeros(256, dtype=np.uint8)
        if not self.any_set:
            # One class for everything (e.g. no patterns).
            return classes
        cls = 0
        for b in range(256):
            classes[b] = cls
            if self.boundary[b] and b < 255:
                cls += 1
        return classes


@dataclasses.dataclass
class Special:
    """Special state ID bookkeeping (util/special.rs:10-28)."""

    max_match_id: int  # largest state ID that is a match state (or 1 if none)
    start_unanchored_id: int
    start_anchored_id: int

    def is_match(self, sid: int) -> bool:
        return 2 <= sid <= self.max_match_id


class NFA:
    """The compiled Aho-Corasick automaton in flat array form.

    Arrays (all numpy, host side):
      - pattern_lens[P]           int32, length of each pattern
      - fail[N]                   int32, failure link per state (DEAD-rooted
                                  for leftmost match states)
      - match_starts[N+1]         int32 CSR offsets into match_pids
      - match_pids[nnz_m]         int32, per-state pattern IDs in report order
      - trans_starts[N+1]         int32 CSR offsets into trans_bytes/trans_next
      - trans_bytes[nnz_t]        uint8, byte-sorted
      - trans_next[nnz_t]         int32
      - depth[N]                  int32
      - classes[256]              uint8 byte -> equivalence class
    """

    def __init__(self):
        self.match_kind: MatchKind = MatchKind.STANDARD
        self.ascii_case_insensitive = False
        self.pattern_lens: np.ndarray = np.zeros(0, np.int32)
        self.min_pattern_len = 0
        self.max_pattern_len = 0
        self.num_states = 0
        self.fail: np.ndarray = np.zeros(0, np.int32)
        self.match_starts: np.ndarray = np.zeros(1, np.int32)
        self.match_pids: np.ndarray = np.zeros(0, np.int32)
        self.trans_starts: np.ndarray = np.zeros(1, np.int32)
        self.trans_bytes: np.ndarray = np.zeros(0, np.uint8)
        self.trans_next: np.ndarray = np.zeros(0, np.int32)
        self.depth: np.ndarray = np.zeros(0, np.int32)
        self.classes: np.ndarray = np.zeros(256, np.uint8)
        self.alphabet_len = 1
        self.special = Special(1, 2, 3)
        # True when the unanchored start state keeps its self-loop
        # (everything except leftmost + empty-pattern, see module docs).
        self.start_loop_open = True

    # ------------------------------------------------------------------
    # Introspection (parity with reference getters, ahocorasick.rs:1846-2024)
    # ------------------------------------------------------------------
    def patterns_len(self) -> int:
        return int(len(self.pattern_lens))

    def pattern_len(self, pid: int) -> int:
        return int(self.pattern_lens[pid])

    def memory_usage(self) -> int:
        total = 0
        for arr in (
            self.pattern_lens, self.fail, self.match_starts, self.match_pids,
            self.trans_starts, self.trans_bytes, self.trans_next, self.depth,
            self.classes,
        ):
            total += arr.nbytes
        return total

    # ------------------------------------------------------------------
    # Automaton protocol (host-side; the oracle engine drives this)
    # ------------------------------------------------------------------
    def start_state(self, anchored: Anchored) -> int:
        if anchored.is_anchored():
            return self.special.start_anchored_id
        return self.special.start_unanchored_id

    def is_dead(self, sid: int) -> bool:
        return sid == DEAD

    def is_match(self, sid: int) -> bool:
        return self.special.is_match(sid)

    def match_len(self, sid: int) -> int:
        return int(self.match_starts[sid + 1] - self.match_starts[sid])

    def match_pattern(self, sid: int, index: int) -> int:
        return int(self.match_pids[self.match_starts[sid] + index])

    def follow_transition(self, sid: int, byte: int) -> int:
        """Trie edge lookup; returns FAIL when no edge is defined.

        The unanchored start state's self-loop (and its closed-loop variant)
        is materialized in the transition arrays, so this is a pure lookup.
        """
        lo = self.trans_starts[sid]
        hi = self.trans_starts[sid + 1]
        i = lo + np.searchsorted(self.trans_bytes[lo:hi], byte)
        if i < hi and self.trans_bytes[i] == byte:
            return int(self.trans_next[i])
        return FAIL

    def next_state(self, anchored: Anchored, sid: int, byte: int) -> int:
        """One transition incl. failure resolution (noncontiguous.rs:601-626).

        The DEAD state is a sink (the reference materializes a full
        self-loop on it, noncontiguous.rs:1643-1646; we special-case it).
        """
        while True:
            if sid == DEAD:
                return DEAD
            nxt = self.follow_transition(sid, byte)
            if nxt != FAIL:
                return nxt
            if anchored.is_anchored():
                return DEAD
            sid = int(self.fail[sid])

    def state_matches(self, sid: int) -> np.ndarray:
        return self.match_pids[self.match_starts[sid]:self.match_starts[sid + 1]]


_KIND_IDX = {
    MatchKind.STANDARD: 0,
    MatchKind.LEFTMOST_FIRST: 1,
    MatchKind.LEFTMOST_LONGEST: 2,
}


def compile_nfa(
    patterns: Sequence[bytes],
    *,
    match_kind: MatchKind = MatchKind.STANDARD,
    ascii_case_insensitive: bool = False,
    builder: str = "auto",
) -> NFA:
    """Build the automaton. See module docstring for the contract.

    ``builder``: "auto" uses the native C++ builder (csrc/acbuild.cc)
    when available, falling back to the pure-Python path; "python" and
    "native" force one. Both produce bit-identical arrays.
    """
    if builder not in ("auto", "python", "native"):
        raise ValueError(f"unknown builder {builder!r}")
    if builder != "python":
        from . import native as _native

        out = (
            _native.compile_native(
                list(patterns), _KIND_IDX[match_kind], ascii_case_insensitive
            )
            if _native.available()
            else None
        )
        if out is not None:
            nfa = NFA()
            nfa.match_kind = match_kind
            nfa.ascii_case_insensitive = ascii_case_insensitive
            nfa.pattern_lens = out["pattern_lens"]
            nfa.min_pattern_len = out["min_pattern_len"]
            nfa.max_pattern_len = out["max_pattern_len"]
            nfa.num_states = out["num_states"]
            nfa.fail = out["fail"]
            nfa.depth = out["depth"]
            nfa.match_starts = out["match_starts"]
            nfa.match_pids = out["match_pids"]
            nfa.trans_starts = out["trans_starts"]
            nfa.trans_bytes = out["trans_bytes"]
            nfa.trans_next = out["trans_next"]
            nfa.classes = out["classes"]
            nfa.alphabet_len = out["alphabet_len"]
            nfa.special = Special(
                out["max_match_id"],
                out["start_unanchored_id"],
                out["start_anchored_id"],
            )
            nfa.start_loop_open = out["start_loop_open"]
            return nfa
        if builder == "native":
            raise RuntimeError("native builder unavailable")
    is_leftmost = match_kind.is_leftmost()
    is_leftmost_first = match_kind.is_leftmost_first()

    if len(patterns) > MAX_SMALL_INDEX:
        raise BuildError.pattern_id_overflow(MAX_SMALL_INDEX, len(patterns))

    # --- trie build (noncontiguous.rs:1057-1150) ----------------------
    # Host-local state ids: 0 is the unanchored start (root). The anchored
    # start and DEAD/FAIL sentinels are materialized during flattening.
    trans: List[Dict[int, int]] = [{}]
    depth: List[int] = [0]
    own_matches: List[List[int]] = [[]]
    byteset = _ByteClassSet()
    pattern_lens = np.zeros(len(patterns), dtype=np.int32)
    min_len, max_len = MAX_SMALL_INDEX, 0

    def alloc_state(d: int) -> int:
        trans.append({})
        depth.append(d)
        own_matches.append([])
        return len(trans) - 1

    for pid, pat in enumerate(patterns):
        if len(pat) > MAX_SMALL_INDEX:
            raise BuildError.pattern_too_long(pid, len(pat))
        pattern_lens[pid] = len(pat)
        min_len = min(min_len, len(pat))
        max_len = max(max_len, len(pat))
        prev = 0
        saw_match = False
        pruned = False
        for d, b in enumerate(pat):
            # Leftmost-first prefix pruning (noncontiguous.rs:1100-1114):
            # checked against states STRICTLY BEFORE the pattern's end.
            saw_match = saw_match or bool(own_matches[prev])
            if is_leftmost_first and saw_match:
                pruned = True
                break
            byteset.set_range(b, b)
            if ascii_case_insensitive:
                ob = opposite_ascii_case(b)
                byteset.set_range(ob, ob)
            nxt = trans[prev].get(b)
            if nxt is None:
                nxt = alloc_state(d + 1)
                trans[prev][b] = nxt
                if ascii_case_insensitive:
                    trans[prev][opposite_ascii_case(b)] = nxt
            prev = nxt
        if not pruned:
            own_matches[prev].append(pid)

    if len(patterns) == 0:
        min_len = 0

    # State-id-overflow contract (util/primitives.rs:92-117): the trie
    # states plus the DEAD/FAIL sentinels and the anchored start copy must
    # all be representable as SmallIndex IDs.
    if len(trans) + 3 > MAX_SMALL_INDEX:
        raise BuildError.state_id_overflow(MAX_SMALL_INDEX, len(trans) + 3)

    classes = byteset.byte_classes()
    alphabet_len = int(classes.max()) + 1

    # --- failure fill BFS (noncontiguous.rs:1275-1374) ----------------
    # Semantics of follow during BFS: the unanchored start state behaves as
    # if it has a self-loop on every byte without a trie edge
    # (add_unanchored_start_state_loop runs before fill_failure_transitions,
    # see SURVEY §3.1), so failure chains always terminate at the root.
    n_host = len(trans)
    ROOT = 0
    HOST_DEAD = -1  # host-local dead marker in fail[]
    fail = [ROOT] * n_host
    matches: List[List[int]] = [list(m) for m in own_matches]

    def follow_host(sid: int, byte: int) -> Optional[int]:
        nxt = trans[sid].get(byte)
        if nxt is not None:
            return nxt
        if sid == ROOT:
            return ROOT  # self-loop
        return None

    queue = deque()
    seen = set() if ascii_case_insensitive else None
    # First loop: the root's children, in byte-sorted order (the root is a
    # "full" state in the reference, so iteration is by byte value;
    # noncontiguous.rs:1282-1307).
    for b in sorted(trans[ROOT]):
        nxt = trans[ROOT][b]
        if nxt == ROOT or (seen is not None and nxt in seen):
            continue
        queue.append(nxt)
        if seen is not None:
            seen.add(nxt)
        if is_leftmost and matches[nxt]:
            fail[nxt] = HOST_DEAD
    while queue:
        sid = queue.popleft()
        for b in sorted(trans[sid]):
            nxt = trans[sid][b]
            if seen is not None and nxt in seen:
                continue
            queue.append(nxt)
            if seen is not None:
                seen.add(nxt)
            if is_leftmost and matches[nxt]:
                fail[nxt] = HOST_DEAD
                continue
            f = fail[sid]
            if f == HOST_DEAD:
                # Dead-fail propagation: the reference's DEAD state has a
                # self-loop on every byte (noncontiguous.rs:1643-1646), so
                # children of dead-failed states get fail=DEAD and copy
                # nothing.
                fail[nxt] = HOST_DEAD
                continue
            while True:
                nf = follow_host(f, b)
                if nf is not None:
                    break
                f = fail[f]
                if f == HOST_DEAD:
                    nf = HOST_DEAD
                    break
            fail[nxt] = nf
            if nf != HOST_DEAD:
                matches[nxt].extend(matches[nf])  # copy_matches timing quirk
        if not is_leftmost:
            # Standard semantics: every state reports the start state's
            # matches (empty-pattern closure), copied at dequeue time
            # (noncontiguous.rs:1359-1371).
            matches[sid].extend(matches[ROOT])

    # --- start-state loop handling ------------------------------------
    # close_start_state_loop_for_leftmost (noncontiguous.rs:1620-1638)
    start_loop_open = not (is_leftmost and bool(matches[ROOT]))

    # --- flatten into final ID layout ---------------------------------
    # Final IDs: 0=DEAD, 1=FAIL(reserved), then match states, then start
    # states (unanchored, anchored) if they are not match states, then
    # non-match states. The anchored start is a copy of the root with
    # fail=DEAD (noncontiguous.rs:1561-1586).
    is_match_state = [bool(m) for m in matches]
    match_ids = [s for s in range(n_host) if is_match_state[s]]
    # Order within groups: keep host allocation order, but ensure the root
    # comes last within its group so start ids are contiguous & recordable.
    root_is_match = is_match_state[ROOT]
    if root_is_match:
        match_ids.remove(ROOT)
    nonmatch_ids = [
        s for s in range(n_host) if not is_match_state[s] and s != ROOT
    ]

    remap = np.zeros(n_host, dtype=np.int32)
    next_id = 2
    for s in match_ids:
        remap[s] = next_id
        next_id += 1
    # start states: unanchored (the root) then the anchored copy.
    remap[ROOT] = next_id
    start_unanchored_id = next_id
    start_anchored_id = next_id + 1
    next_id += 2
    if root_is_match:
        max_match_id = start_anchored_id
    else:
        max_match_id = 1 + len(match_ids)
    for s in nonmatch_ids:
        remap[s] = next_id
        next_id += 1
    num_states = next_id

    nfa = NFA()
    nfa.match_kind = match_kind
    nfa.ascii_case_insensitive = ascii_case_insensitive
    nfa.pattern_lens = pattern_lens
    nfa.min_pattern_len = int(min_len)
    nfa.max_pattern_len = int(max_len)
    nfa.num_states = num_states
    nfa.classes = classes
    nfa.alphabet_len = alphabet_len
    nfa.special = Special(max_match_id, start_unanchored_id, start_anchored_id)
    nfa.start_loop_open = start_loop_open

    # fail links
    out_fail = np.zeros(num_states, dtype=np.int32)
    for s in range(n_host):
        f = fail[s]
        out_fail[remap[s]] = DEAD if f == HOST_DEAD else remap[f]
    # Reference: start states' fail. Unanchored root fail -> itself
    # conceptually (never consulted when the loop is open); anchored fail ->
    # DEAD always.
    out_fail[start_unanchored_id] = (
        start_unanchored_id if start_loop_open else DEAD
    )
    out_fail[start_anchored_id] = DEAD
    nfa.fail = out_fail

    # depth
    out_depth = np.zeros(num_states, dtype=np.int32)
    for s in range(n_host):
        out_depth[remap[s]] = depth[s]
    nfa.depth = out_depth

    # match CSR (anchored start shares the root's matches,
    # noncontiguous.rs:1577)
    counts = np.zeros(num_states + 1, dtype=np.int64)
    for s in range(n_host):
        counts[remap[s] + 1] = len(matches[s])
    counts[start_anchored_id + 1] = len(matches[ROOT])
    match_starts = np.cumsum(counts).astype(np.int32)
    match_pids = np.zeros(int(match_starts[-1]), dtype=np.int32)
    for s in range(n_host):
        lo = match_starts[remap[s]]
        match_pids[lo:lo + len(matches[s])] = matches[s]
    lo = match_starts[start_anchored_id]
    match_pids[lo:lo + len(matches[ROOT])] = matches[ROOT]
    nfa.match_starts = match_starts
    nfa.match_pids = match_pids

    # transition CSR. The unanchored start's self-loop entries are
    # materialized: bytes with no trie edge map to the root (loop open) or
    # DEAD (loop closed). The anchored start has the same trie edges but NO
    # loop entries (missing edge -> FAIL -> next_state returns DEAD for
    # anchored searches).
    tcounts = np.zeros(num_states + 1, dtype=np.int64)
    for s in range(n_host):
        if s == ROOT:
            tcounts[remap[s] + 1] = 256
        else:
            tcounts[remap[s] + 1] = len(trans[s])
    tcounts[start_anchored_id + 1] = len(trans[ROOT])
    trans_starts = np.cumsum(tcounts).astype(np.int32)
    nnz = int(trans_starts[-1])
    trans_bytes = np.zeros(nnz, dtype=np.uint8)
    trans_next = np.zeros(nnz, dtype=np.int32)
    for s in range(n_host):
        lo = trans_starts[remap[s]]
        if s == ROOT:
            loop_target = start_unanchored_id if start_loop_open else DEAD
            row = np.full(256, loop_target, dtype=np.int32)
            for b, nxt in trans[ROOT].items():
                row[b] = remap[nxt]
            trans_bytes[lo:lo + 256] = np.arange(256, dtype=np.uint8)
            trans_next[lo:lo + 256] = row
        else:
            items = sorted(trans[s].items())
            for i, (b, nxt) in enumerate(items):
                trans_bytes[lo + i] = b
                trans_next[lo + i] = remap[nxt]
    lo = trans_starts[start_anchored_id]
    items = sorted(trans[ROOT].items())
    for i, (b, nxt) in enumerate(items):
        trans_bytes[lo + i] = b
        trans_next[lo + i] = remap[nxt]
    nfa.trans_starts = trans_starts
    nfa.trans_bytes = trans_bytes
    nfa.trans_next = trans_next

    return nfa


def patterns_to_bytes(patterns: Iterable) -> List[bytes]:
    """Normalize a pattern iterable to a list of bytes."""
    out = []
    for p in patterns:
        if isinstance(p, str):
            out.append(p.encode("utf-8"))
        elif isinstance(p, bytes):
            out.append(p)
        else:
            out.append(bytes(p))
    return out
