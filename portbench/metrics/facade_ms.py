"""facade_ms: self time per call of the facade and semantics layer
(`ahocorasick.py`, `semantics.py`): the call's time outside every engine
span (routing, the leftmost-first selection or overlapping order, Match
objects). Left out where no engine span was laid or none opened."""

from statistics import fmean


def read(run):
    spans = run.spans or []
    if not any("engine" in c for c in spans):
        return None
    return fmean(c.get("facade", 0.0) for c in spans) * 1e3
