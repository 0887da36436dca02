"""kernels_roofline: the least device time of the profiled calls over
their summed kernel time, in percent. The least time of a call is the
larger of its bytes over the memory rate and the filter's shift-AND
operations over the SMs' rates (portbench/roofline.py), from the
configuration's frozen limb count and table bytes and the matches the
reference finds; it counts the work, not the kernels that do it."""

from portbench.roofline import call_bound_s


def read(run):
    p = run.profile or {}
    if not p.get("kernel_s") or not run.sm_hz:
        return None
    roof = run.config["roofline"]
    least = sum(call_bound_s(run.pool_bytes[i], roof["filter_limbs"],
                             roof["table_bytes"], run.matches[i], run.sm_hz)
                for i in run.profile_pool)
    return 100.0 * least / p["kernel_s"]
