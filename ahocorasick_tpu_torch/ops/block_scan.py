"""Host scalar walk over the dense DFA table.

The port's copy of `scan_states_host` from the JAX package's blocked DFA
scan module. The device walk itself (`DeviceAutomaton`) is not ported
yet; the facade calls this walk for haystacks below its device threshold
when the native walk is unavailable.
"""

from __future__ import annotations

import numpy as np

from ..automata.dfa import DenseDFA


def scan_states_host(dfa: DenseDFA, haystack: bytes) -> np.ndarray:
    """Host scalar reference walk over the dense table.

    Returns the per-position states: ``out[i]`` is the state after
    consuming ``haystack[i]`` from the unanchored start state.
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
