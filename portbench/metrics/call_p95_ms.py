"""call_p95_ms: the 95th percentile (nearest rank) of every window call's
time, host clock from the call until its result is consumed and the
device has finished."""

import math


def read(run):
    if not run.durations:
        return None
    d = sorted(run.durations)
    return d[math.ceil(0.95 * len(d)) - 1] * 1e3
