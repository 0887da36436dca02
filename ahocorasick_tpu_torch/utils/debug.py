"""Automaton pretty-printers — the reference's primary debugging tool.

Mirrors the rich Debug impls the reference ships (full-automaton dumps:
nfa/noncontiguous.rs:1691-1762, dfa.rs:305-381) and the
`sparse_transitions` range-collapsing helper (automaton.rs:1583-1608).
Reachable via `AhoCorasick.debug_str()` and `cli.py --debug`.
"""

from __future__ import annotations

from typing import Iterable, Iterator, List, Optional, Tuple

import numpy as np


def debug_byte(b: int) -> str:
    """Printable rendering of a byte (util/debug.rs DebugByte)."""
    if b == 0x5C:
        return "\\\\"
    if 0x20 <= b <= 0x7E:
        return chr(b)
    return f"\\x{b:02X}"


def sparse_transitions(
    pairs: Iterable[Tuple[int, int]]
) -> Iterator[Tuple[int, int, int]]:
    """Collapse (byte, next) pairs into (start, end, next) ranges —
    consecutive bytes mapping to the same next state merge
    (automaton.rs:1583-1608)."""
    cur: Optional[Tuple[int, int, int]] = None
    for byte, nxt in pairs:
        if cur is None:
            cur = (byte, byte, nxt)
            continue
        ps, pe, pn = cur
        if pn == nxt and byte == pe + 1:
            cur = (ps, byte, pn)
        else:
            yield cur
            cur = (byte, byte, nxt)
    if cur is not None:
        yield cur


def _fmt_ranges(ranges: Iterable[Tuple[int, int, int]]) -> List[str]:
    out = []
    for s, e, n in ranges:
        if s == e:
            out.append(f"{debug_byte(s)} => {n}")
        else:
            out.append(f"{debug_byte(s)}-{debug_byte(e)} => {n}")
    return out


def _state_prefix(sid: int, special, match_pids: List[int]) -> str:
    mark = "*" if match_pids else " "
    tag = ""
    if sid == special.start_unanchored_id:
        tag = ">"
    elif sid == special.start_anchored_id:
        tag = "^"
    pids = f"({','.join(map(str, match_pids))})" if match_pids else ""
    return f"{mark}{tag}{sid:06}{pids}:"


def format_nfa(nfa, max_states: Optional[int] = None) -> str:
    """Full noncontiguous-NFA dump (nfa/noncontiguous.rs:1691-1762)."""
    lines = [
        "noncontiguous::NFA(",
        f"match_kind: {nfa.match_kind.value}",
        f"state count: {nfa.num_states}",
        f"pattern count: {nfa.patterns_len()}",
        f"pattern lens: {nfa.min_pattern_len}..={nfa.max_pattern_len}",
        f"alphabet len: {nfa.alphabet_len}",
        f"special: max_match_id={nfa.special.max_match_id}, "
        f"start_unanchored={nfa.special.start_unanchored_id}, "
        f"start_anchored={nfa.special.start_anchored_id}",
        f"memory usage: {nfa.memory_usage()} bytes",
    ]
    n = nfa.num_states if max_states is None else min(
        nfa.num_states, max_states
    )
    for sid in range(n):
        t0, t1 = int(nfa.trans_starts[sid]), int(nfa.trans_starts[sid + 1])
        pairs = zip(
            nfa.trans_bytes[t0:t1].tolist(), nfa.trans_next[t0:t1].tolist()
        )
        parts = _fmt_ranges(sparse_transitions(pairs))
        m0, m1 = int(nfa.match_starts[sid]), int(nfa.match_starts[sid + 1])
        pids = nfa.match_pids[m0:m1].tolist()
        fail = int(nfa.fail[sid])
        if fail != 0 or parts:
            parts.append(f"fail => {fail}")
        lines.append(
            f"{_state_prefix(sid, nfa.special, pids)} "
            + ", ".join(parts)
        )
    if n < nfa.num_states:
        lines.append(f"... ({nfa.num_states - n} more states)")
    lines.append(")")
    return "\n".join(lines)


def format_dfa(dfa, max_states: Optional[int] = None) -> str:
    """Full dense-DFA dump (dfa.rs:305-381): per state, byte ranges
    (mapped back through the byte classes) collapsed per target."""
    lines = [
        "dfa::DFA(",
        f"match_kind: {dfa.match_kind.value}",
        f"state count: {dfa.num_states}",
        f"alphabet len: {dfa.alphabet_len}",
        f"table: {dfa.trans.shape[0]} x {dfa.trans.shape[1]} int32",
        f"special: max_match_id={dfa.special.max_match_id}, "
        f"start_unanchored={dfa.special.start_unanchored_id}, "
        f"start_anchored={dfa.special.start_anchored_id}",
        f"memory usage: {dfa.memory_usage()} bytes",
    ]
    classes = dfa.classes.astype(np.int64)
    n = dfa.num_states if max_states is None else min(
        dfa.num_states, max_states
    )
    for sid in range(n):
        row = dfa.trans[sid]
        pairs = ((b, int(row[classes[b]])) for b in range(256))
        ranges = [
            (s, e, nx) for (s, e, nx) in sparse_transitions(pairs)
            if nx != 0
        ]
        parts = _fmt_ranges(ranges)
        m0, m1 = int(dfa.match_starts[sid]), int(dfa.match_starts[sid + 1])
        pids = dfa.match_pids[m0:m1].tolist()
        lines.append(
            f"{_state_prefix(sid, dfa.special, pids)} "
            + ", ".join(parts)
        )
    if n < dfa.num_states:
        lines.append(f"... ({dfa.num_states - n} more states)")
    lines.append(")")
    return "\n".join(lines)
