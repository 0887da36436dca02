"""kernel_ms: summed kernel device time per profiled call (copies and
memsets not counted)."""


def read(run):
    p = run.profile or {}
    if not p.get("kernel_s") or not p["calls"]:
        return None
    return p["kernel_s"] / p["calls"] * 1e3
