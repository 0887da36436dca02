"""scan_GBps: haystack bytes of the calls completed in the window over
the window's whole time, 1 GB = 10^9 B (host clock)."""


def read(run):
    if not run.durations or run.window_s <= 0:
        return None
    return run.bytes_done / run.window_s / 1e9
