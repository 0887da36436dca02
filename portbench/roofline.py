"""The least device time of a call: the yardstick of `kernels_roofline`.

Frozen copies of the card smoke test's `step_cycles`, `bound` and
`card_rates` and of its Hopper rates, so that a later change to the
program or to that script never moves the yardstick. The inputs come
from the configuration's file (the filter's limb count K and its table
bytes) and from the workload (n, the haystack bytes), never from the
program.
"""

from __future__ import annotations

import subprocess

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
# Per SM and clock on Hopper (CUDA C++ Programming Guide, throughput of
# native arithmetic instructions, compute capability 9.0): 32-bit logic,
# shifts and adds 64; population count 16; shared memory 32 four-byte
# loads (128 bytes); four schedulers issue one warp instruction each.
ALU_PER_CLK = 64
POPC_PER_CLK = 16
LDS_PER_CLK = 32
ISSUE_PER_CLK = 128
RESULT_BYTES = 8  # per match: a 4-byte pattern id and a 4-byte end


def step_cycles(K: int, popc: bool) -> float:
    """SM cycles per scanned byte that a shift-AND step over K limbs needs
    at the least on Hopper, each class of operation over its own rate:
    per byte, two integer operations (the two nybble indices); per limb, a
    funnel shift (m << 1 with the carry of the limb below), two
    three-input logic operations ((x | start) & lo & hi), two shared-memory
    loads (lo, hi) and the output: one logic operation (any |= m & end),
    or, for a count (``popc``), m & end, a popc and half an add (one
    three-input add sums two popcs)."""
    alu = 2 + K * (3 + (1.5 if popc else 1))
    pop = K if popc else 0
    lds = 2 * K
    return max(alu / ALU_PER_CLK, pop / POPC_PER_CLK, lds / LDS_PER_CLK,
               (alu + pop + lds) / ISSUE_PER_CLK)


def call_bound_s(n: int, K: int, table_bytes: int, matches: int,
                 sm_hz: float) -> float:
    """Least device seconds of one call over n haystack bytes: the larger
    of the bytes it must move (the n bytes and the filter's tables read
    once, the matches' results written once) over the memory rate, and
    the filter's shift-AND operations at K limbs (a bitmap: no popc) over
    ``sm_hz``, the SM cycles per second of the whole card. It counts the
    work the call needs, not the kernels that do it."""
    moved = n + table_bytes + RESULT_BYTES * matches
    return max(moved / HBM_BYTES_PER_S, n * step_cycles(K, False) / sm_hz)


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def card_rates():
    """(nvidia-smi name and power limit, SM cycles per second of the whole
    card at its maximum SM clock)."""
    import torch
    max_mhz = float(smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return smi("name,power.limit"), sms * max_mhz * 1e6
