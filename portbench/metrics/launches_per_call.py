"""launches_per_call: device kernels per call in the profiled calls
(copies and memsets not counted)."""


def read(run):
    p = run.profile or {}
    if "launches" not in p or not p["calls"]:
        return None
    return p["launches"] / p["calls"]
