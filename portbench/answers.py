"""How the operations keep and compare their answers: a list of matches
(Match objects or (pattern, start, end) tuples) as an int64 array [k, 3],
which the garbage collector never tracks, and the gap between two such
lists."""

import numpy as np


def as_array(result) -> np.ndarray:
    if len(result) and hasattr(result[0], "pattern"):
        flat = (v for m in result for v in (m.pattern, m.start, m.end))
    else:
        flat = (v for t in result for v in t)
    return np.fromiter(flat, np.int64, 3 * len(result)).reshape(-1, 3)


def list_gap(got: np.ndarray, want) -> int:
    """Triples of ``got`` that differ from ``want``'s at the same place,
    plus the difference in length: 0 where the lists are equal."""
    ref = as_array(want)
    m = min(len(got), len(ref))
    return (int((got[:m] != ref[:m]).any(axis=1).sum())
            + abs(len(got) - len(ref)))
