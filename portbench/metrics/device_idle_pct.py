"""device_idle_pct: the share of the profiled calls' host time in which
no kernel, copy or memset runs on the device."""


def read(run):
    p = run.profile or {}
    if "busy_s" not in p or not p["window_s"]:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
