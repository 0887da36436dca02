"""dict_roofline: the least device time of the profiled calls over their
summed kernel time, in percent. The least time of a call counts bytes
only: its n haystack bytes, the set's pattern bytes (``table_bytes``)
and 8 B for each match the reference finds, over the memory rate
(portbench/roofline.py). It counts the work, not the kernels that do
it, so a filter and verify and a device walk are read against the same
yardstick."""

from portbench.roofline import HBM_BYTES_PER_S, RESULT_BYTES


def read(run):
    p = run.profile or {}
    if not p.get("kernel_s"):
        return None
    table = run.config["roofline"]["table_bytes"]
    moved = sum(run.pool_bytes[i] + table + RESULT_BYTES * run.matches[i]
                for i in run.profile_pool)
    return 100.0 * moved / HBM_BYTES_PER_S / p["kernel_s"]
