"""ctypes bindings for the native C++ construction path (csrc/acbuild.cc).

The shared library is compiled on demand with g++ into the package's
build directory (see `_build.py`), named by a hash of the source; if the
toolchain is unavailable the Python builder in noncontiguous.py is used
instead — both produce bit-identical arrays.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import List, Optional

import numpy as np

from .. import _build

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_failed = False

_SRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "csrc", "acbuild.cc",
)
_CXX_FLAGS = ["-O2", "-shared", "-fPIC", "-pthread", "-std=c++17"]

# acbuild.cc picks its compact 24-bit trie map when
# total_bytes + 2 <= 1 << 24. At equality the largest host-state id is
# 2^24 - 1, the map's occupied-slot tag wraps to 0 (its empty marker) and
# the build silently corrupts the automaton. Such sets go to the Python
# builder instead.
_COMPACT_MAP_EDGE = 1 << 24


def native_build_safe(total_bytes: int) -> bool:
    """False for the one pattern-byte total the native builder gets wrong."""
    return total_bytes + 2 != _COMPACT_MAP_EDGE


class _AcSizes(ctypes.Structure):
    _fields_ = [
        ("num_states", ctypes.c_int32),
        ("alphabet_len", ctypes.c_int32),
        ("max_match_id", ctypes.c_int32),
        ("start_unanchored_id", ctypes.c_int32),
        ("start_anchored_id", ctypes.c_int32),
        ("start_loop_open", ctypes.c_int32),
        ("min_pattern_len", ctypes.c_int32),
        ("max_pattern_len", ctypes.c_int32),
        ("match_nnz", ctypes.c_int64),
        ("trans_nnz", ctypes.c_int64),
    ]


def _build_so() -> Optional[str]:
    try:
        return _build.build_shared(_SRC, "acbuild", ["g++"] + _CXX_FLAGS)
    except (OSError, subprocess.SubprocessError):
        return None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _lib_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _lib_failed:
            return None
        so = _build_so() if os.path.exists(_SRC) else None
        if so is None:
            _lib_failed = True
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            _lib_failed = True
            return None
        lib.ac_compile.restype = ctypes.c_void_p
        lib.ac_compile.argtypes = [
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_int64,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(_AcSizes),
        ]
        lib.ac_copy.restype = None
        lib.ac_copy.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 9
        lib.ac_free.argtypes = [ctypes.c_void_p]
        lib.ac_dfa_count.restype = ctypes.c_int64
        lib.ac_dfa_count.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int64,
        ]
        lib.ac_dfa_positions.restype = ctypes.c_int64
        lib.ac_dfa_positions.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64,
        ]
        lib.ac_dfa_count_mt.restype = ctypes.c_int64
        lib.ac_dfa_count_mt.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int64, ctypes.c_int32,
        ]
        lib.ac_dfa_positions_mt.restype = ctypes.c_int64
        lib.ac_dfa_positions_mt.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
        ]
        _lib = lib
        return lib


def _default_threads(n: int) -> int:
    """Host shard count for the native walk.

    The walk on large automatons is DRAM-latency-bound (one dependent
    table load per byte; a 123k-word DFA is ~100 MB of transitions), so
    oversubscribing cores buys memory-level parallelism: measured
    0.154 -> 0.220 GB/s going 1 -> 4x-cores threads on the english-123k
    dictionary. Small inputs stay single-threaded (thread startup is
    ~100 us each)."""
    if n < (1 << 18):
        return 1
    return max(1, min(4 * (os.cpu_count() or 1), 16))


def available() -> bool:
    return _load() is not None


def dfa_count(dfa, haystack: bytes,
              n_threads: Optional[int] = None) -> Optional[int]:
    """Native dense-DFA overlapping-match count (~1 GB/s/core).

    The host fallback for pattern sets beyond the bit-parallel kernel's
    bounds (the reference's own execution model, dfa.rs:218-226), sharded
    across host cores with halo warmup for large inputs.
    Returns None when the native library is unavailable.
    """
    lib = _load()
    if lib is None:
        return None
    trans = np.ascontiguousarray(dfa.trans, np.int32)
    classes = np.ascontiguousarray(dfa.classes, np.uint8)
    mc = np.ascontiguousarray(dfa.match_count, np.int32)
    hay = np.frombuffer(haystack, np.uint8)
    if n_threads is None:
        n_threads = _default_threads(len(hay))
    return int(lib.ac_dfa_count_mt(
        trans.ctypes.data, classes.ctypes.data, mc.ctypes.data,
        hay.ctypes.data if len(hay) else None, len(hay),
        dfa.alphabet_len, dfa.special.start_unanchored_id,
        max(dfa.max_pattern_len - 1, 0), n_threads,
    ))


def dfa_positions(dfa, haystack: bytes,
                  n_threads: Optional[int] = None):
    """Native scan emitting compacted (1-based end, state) match
    positions, the host analog of DeviceAutomaton.match_positions —
    sharded across host cores with halo warmup for large inputs.
    Returns None when the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    trans = np.ascontiguousarray(dfa.trans, np.int32)
    classes = np.ascontiguousarray(dfa.classes, np.uint8)
    hay = np.frombuffer(haystack, np.uint8)
    if n_threads is None:
        n_threads = _default_threads(len(hay))
    cap = 4096
    while True:
        out_pos = np.zeros(cap, np.int64)
        out_sid = np.zeros(cap, np.int32)
        cnt = int(lib.ac_dfa_positions_mt(
            trans.ctypes.data, classes.ctypes.data,
            hay.ctypes.data if len(hay) else None, len(hay),
            dfa.alphabet_len, dfa.special.start_unanchored_id,
            dfa.special.max_match_id,
            max(dfa.max_pattern_len - 1, 0),
            out_pos.ctypes.data, out_sid.ctypes.data, cap, n_threads,
        ))
        if cnt <= cap:
            return out_pos[:cnt], out_sid[:cnt].astype(np.int64)
        cap = 1 << (cnt - 1).bit_length()


def compile_native(patterns: List[bytes], match_kind_idx: int,
                   case_insensitive: bool):
    """Run the native builder; returns the flat arrays or None if the
    native library is unavailable or the set sits on the builder's
    compact-map edge (`native_build_safe`)."""
    concat = b"".join(patterns)
    if not native_build_safe(len(concat)):
        return None
    lib = _load()
    if lib is None:
        return None
    offsets = np.zeros(len(patterns) + 1, dtype=np.int64)
    np.cumsum([len(p) for p in patterns], out=offsets[1:])
    buf = np.frombuffer(concat, dtype=np.uint8) if concat else np.zeros(
        0, np.uint8
    )
    sizes = _AcSizes()
    handle = lib.ac_compile(
        buf.ctypes.data if len(buf) else None,
        offsets.ctypes.data,
        len(patterns),
        match_kind_idx,
        1 if case_insensitive else 0,
        ctypes.byref(sizes),
    )
    try:
        # np.empty: every array is fully overwritten by ac_copy, and
        # the zero-fill pass alone costs ~15 ms of page-touch time on
        # the 100k-pattern build (~50 MB of outputs).
        n = sizes.num_states
        fail = np.empty(n, np.int32)
        depth = np.empty(n, np.int32)
        match_starts = np.empty(n + 1, np.int32)
        match_pids = np.empty(sizes.match_nnz, np.int32)
        trans_starts = np.empty(n + 1, np.int32)
        trans_bytes = np.empty(sizes.trans_nnz, np.uint8)
        trans_next = np.empty(sizes.trans_nnz, np.int32)
        classes = np.empty(256, np.uint8)
        pattern_lens = np.empty(len(patterns), np.int32)
        lib.ac_copy(
            handle,
            fail.ctypes.data,
            depth.ctypes.data,
            match_starts.ctypes.data,
            match_pids.ctypes.data,
            trans_starts.ctypes.data,
            trans_bytes.ctypes.data,
            trans_next.ctypes.data,
            classes.ctypes.data,
            pattern_lens.ctypes.data,
        )
    finally:
        lib.ac_free(handle)
    return {
        "num_states": n,
        "alphabet_len": sizes.alphabet_len,
        "max_match_id": sizes.max_match_id,
        "start_unanchored_id": sizes.start_unanchored_id,
        "start_anchored_id": sizes.start_anchored_id,
        "start_loop_open": bool(sizes.start_loop_open),
        "min_pattern_len": sizes.min_pattern_len,
        "max_pattern_len": sizes.max_pattern_len,
        "fail": fail,
        "depth": depth,
        "match_starts": match_starts,
        "match_pids": match_pids,
        "trans_starts": trans_starts,
        "trans_bytes": trans_bytes,
        "trans_next": trans_next,
        "classes": classes,
        "pattern_lens": pattern_lens,
    }
