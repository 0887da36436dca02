"""Checkpoint/restore of compiled searchers (extension).

The reference has no automaton serialization (SURVEY §5: no serde); its
resumability is search-granular. Here every automaton is a set of flat
numpy arrays, so a compiled `AhoCorasick` round-trips through one
``.npz`` file: patterns, builder configuration, and the compiled NFA/DFA
tables — load() restores a ready searcher without re-running trie
construction or the BFS failure fill. Device/bitap tables are re-derived
lazily on first use (they are cheap projections of the saved arrays).

The file format is the JAX package's, array for array, so a file written
by either package's ``save`` loads in the other. ``from_arrays`` builds a
searcher from the same arrays held in a dict (for instance the arrays of
a JAX searcher, collected with ``to_arrays``).
"""

from __future__ import annotations

import numpy as np

from .automata.dfa import DenseDFA
from .automata.noncontiguous import NFA, Special
from .utils.search import MatchKind, StartKind

_KINDS = [MatchKind.STANDARD, MatchKind.LEFTMOST_FIRST,
          MatchKind.LEFTMOST_LONGEST]
_STARTS = [StartKind.BOTH, StartKind.UNANCHORED, StartKind.ANCHORED]


def _index(members, member) -> int:
    """Position of an enum member by value, so members of the JAX
    package's identically valued enums are accepted too."""
    return [m.value for m in members].index(member.value)


_NFA_ARRAYS = (
    "pattern_lens", "fail", "match_starts", "match_pids",
    "trans_starts", "trans_bytes", "trans_next", "depth", "classes",
)
_NFA_SCALARS = (
    "min_pattern_len", "max_pattern_len", "num_states", "alphabet_len",
    "start_loop_open",
)
_DFA_ARRAYS = (
    "trans", "classes", "match_starts", "match_pids", "pattern_lens",
)


def _pack_nfa(prefix: str, nfa: NFA, out: dict) -> None:
    for name in _NFA_ARRAYS:
        out[f"{prefix}{name}"] = getattr(nfa, name)
    sc = [int(getattr(nfa, name)) for name in _NFA_SCALARS]
    sp = nfa.special
    sc += [sp.max_match_id, sp.start_unanchored_id, sp.start_anchored_id,
           _index(_KINDS, nfa.match_kind), int(nfa.ascii_case_insensitive)]
    out[f"{prefix}scalars"] = np.asarray(sc, np.int64)


def _unpack_nfa(prefix: str, z) -> NFA:
    nfa = NFA()
    for name in _NFA_ARRAYS:
        setattr(nfa, name, z[f"{prefix}{name}"])
    sc = z[f"{prefix}scalars"]
    for i, name in enumerate(_NFA_SCALARS):
        setattr(
            nfa, name,
            bool(sc[i]) if name == "start_loop_open" else int(sc[i]),
        )
    nfa.special = Special(int(sc[5]), int(sc[6]), int(sc[7]))
    nfa.match_kind = _KINDS[int(sc[8])]
    nfa.ascii_case_insensitive = bool(sc[9])
    return nfa


def save(ac, path: str) -> None:
    """Serialize a compiled AhoCorasick searcher to ``path`` (.npz)."""
    np.savez_compressed(path, **to_arrays(ac))


def to_arrays(ac) -> dict:
    """The searcher's patterns, configuration and compiled tables as a
    dict of numpy arrays (the ``.npz`` layout). Works on a searcher of
    either package: it reads only attributes both define."""
    out = {}
    pats = ac._patterns
    # Patterns as one byte blob + offsets (npz has no ragged arrays).
    blob = b"".join(pats)
    out["pat_blob"] = np.frombuffer(blob, np.uint8).copy()
    out["pat_offsets"] = np.cumsum(
        [0] + [len(p) for p in pats]
    ).astype(np.int64)
    from .ahocorasick import AhoCorasickKind

    out["config"] = np.asarray(
        [
            _index(_KINDS, ac._match_kind),
            _index(_STARTS, ac._start_kind),
            int(ac._case_insensitive),
            int(ac._prefilter_enabled),
            int(ac._byte_classes),
            int(ac._device_threshold),
            _index(list(AhoCorasickKind), ac._kind),
            int(ac._dense_depth),
        ],
        np.int64,
    )
    out["engine_mode"] = np.frombuffer(
        ac._engine_mode.encode(), np.uint8
    ).copy()
    _pack_nfa("nfa_", ac._nfa, out)
    if ac._match_nfa is not ac._nfa:
        _pack_nfa("mnfa_", ac._match_nfa, out)
    d = ac._dfa
    for name in _DFA_ARRAYS:
        out[f"dfa_{name}"] = getattr(d, name)
    out["dfa_scalars"] = np.asarray(
        [d.alphabet_len, d.num_states, d.min_pattern_len,
         d.max_pattern_len, _index(_KINDS, d.match_kind),
         d.special.max_match_id, d.special.start_unanchored_id,
         d.special.start_anchored_id],
        np.int64,
    )
    return out


def load(path: str, device="cuda"):
    """Restore a searcher saved with `save` — no recompilation."""
    with np.load(path) as z:
        return from_arrays({k: z[k] for k in z.files}, device=device)


def from_arrays(z: dict, device="cuda"):
    """A searcher on ``device`` from the arrays `to_arrays` returns."""
    from .ahocorasick import (
        AhoCorasick,
        AhoCorasickKind,
        _check_engine,
        _resolve_device,
    )

    offs = z["pat_offsets"]
    blob = z["pat_blob"].tobytes()
    patterns = [
        blob[int(offs[i]):int(offs[i + 1])]
        for i in range(len(offs) - 1)
    ]
    cfg = z["config"]
    ac = object.__new__(AhoCorasick)
    ac._patterns = patterns
    ac._match_kind = _KINDS[int(cfg[0])]
    ac._start_kind = _STARTS[int(cfg[1])]
    ac._case_insensitive = bool(cfg[2])
    ac._prefilter_enabled = bool(cfg[3])
    ac._byte_classes = bool(cfg[4])
    ac._device_threshold = int(cfg[5])
    ac._engine_mode = z["engine_mode"].tobytes().decode()
    _check_engine(ac._engine_mode)
    ac._torch_device = _resolve_device(device)
    ac._nfa = _unpack_nfa("nfa_", z)
    if "mnfa_scalars" in z:
        ac._match_nfa = _unpack_nfa("mnfa_", z)
    else:
        ac._match_nfa = ac._nfa
    sc = z["dfa_scalars"]
    ac._dfa = DenseDFA(
        trans=z["dfa_trans"],
        classes=z["dfa_classes"],
        alphabet_len=int(sc[0]),
        num_states=int(sc[1]),
        special=Special(int(sc[5]), int(sc[6]), int(sc[7])),
        match_starts=z["dfa_match_starts"],
        match_pids=z["dfa_match_pids"],
        pattern_lens=z["dfa_pattern_lens"],
        min_pattern_len=int(sc[2]),
        max_pattern_len=int(sc[3]),
        match_kind=_KINDS[int(sc[4])],
    )
    ac._engines = {}
    ac._eligibility = {}
    ac._pre = None
    ac._pre_checked = False
    ac._dense_depth = int(cfg[7])
    ac._contig = None
    ac._has_empty = bool(
        len(ac._nfa.pattern_lens)
        and int(ac._nfa.pattern_lens.min()) == 0
    )
    ac._kind = list(AhoCorasickKind)[int(cfg[6])]
    return ac
