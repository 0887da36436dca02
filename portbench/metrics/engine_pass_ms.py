"""engine_pass_ms: self time per call of the engines' `count_matches` /
`match_pairs` without their `prepare`: launches, the pass's read, cap
growth, decode, the host tail (`_host_pairs`, the lexsort). Left out
where no engine span opened."""

from statistics import fmean


def read(run):
    spans = run.spans or []
    if not any("engine" in c for c in spans):
        return None
    return fmean(c.get("engine", 0.0) for c in spans) * 1e3
