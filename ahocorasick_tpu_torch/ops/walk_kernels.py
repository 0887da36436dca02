"""Wrappers of the blocked DFA walk's Hopper kernels (csrc/dfa_walk.cu),
with their plain PyTorch versions.

The JAX package runs each walk as one ``lax.scan`` over ``halo + L``
steps; here each is one kernel:

- ``walk_states`` (W1, the port of ``ops/block_scan.py::_scan_states_jit``):
  the state after every byte of the unanchored walk, int32 ``[n_pad]``;
- ``walk_count`` (W2, the port of ``ops/block_scan.py::_count_matches_jit``
  and ``parallel/shard.py::count_kernel``): the same walk, summing
  ``match_count[state]`` over the positions of a window ``[n0, n1)``, with
  no state array; a 0-d int64 tensor.

Both take the JAX layout's ``block_len`` and ``halo``: the plain versions
walk blocks of ``block_len`` bytes in lockstep, as the JAX package does,
one torch step per byte of a block. The kernels cut the buffer finer, one
thread per sub-block of ``walk_plan(n_pad, halo)`` bytes; by the suffix
property (``ops/block_scan.py``) every block length gives the same states
once each block walks a halo of at least ``max_pattern_len`` bytes. Halo
steps before the buffer's start are skipped in both, also where the halo
is longer than a block.

On a CPU tensor a wrapper computes the plain version; on a CUDA tensor it
launches the kernel or raises. Launches are counted in ``walk_launches``
(W1) and ``count_launches`` (W2), and each one's last launch kept in
``walk_shape`` and ``count_shape``: (bytes, threads, sub-block bytes,
halo, table in shared memory).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import _build
from .._build import I, LL, P
from .bitap_kernels import launch

THREADS = 512                 # threads per block of either kernel
TARGET_THREADS = 1 << 18      # about the H100's resident slots (132 x 2,048)
MIN_SUB = 16                  # one 16-byte vector of haystack bytes
SHARED_TABLE_BYTES = 40 * 1024  # tables up to this size go to shared memory
MAX_INDEX = (1 << 31) - 1     # the kernels index the table with int32

walk_launches = 0
count_launches = 0
walk_shape: Optional[Tuple[int, int, int, int, bool]] = None
count_shape: Optional[Tuple[int, int, int, int, bool]] = None

LIBRARY = _build.CudaLibrary("dfa_walk.cu", {
    "walk_states": (P, LL, P, P, LL, I, I, LL, I, I, P, P),
    "walk_count": (P, LL, P, P, LL, I, I, LL, I, I, P, LL, LL, P, P),
}, headers=())


def reset_counts() -> None:
    global walk_launches, count_launches
    walk_launches = count_launches = 0


def walk_plan(n_pad: int, halo: int) -> int:
    """The kernels' sub-block length for an ``n_pad``-byte buffer: a power
    of two of at least 16 bytes and 8 x ``halo`` (the halo walk adds at
    most 1/8), otherwise small enough that the buffer gives about
    ``TARGET_THREADS`` threads (256 bytes at 64 MiB)."""
    sub = max(MIN_SUB, 8 * halo, -(-n_pad // TARGET_THREADS))
    return 1 << (sub - 1).bit_length()


def count_blocks(n_pad: int, sub: int) -> int:
    """Blocks of THREADS threads in a launch over sub-blocks of ``sub``."""
    return -(-(-(-n_pad // sub)) // THREADS)


def table_in_shared(trans_flat: torch.Tensor) -> bool:
    """Whether a launch copies the table into shared memory."""
    return trans_flat.numel() * 4 <= SHARED_TABLE_BYTES


def _check(trans_flat, classes, buf, A: int, start: int,
           match_count=None) -> torch.device:
    """The tables and the buffer as the kernels read them; returns the
    device."""
    dev = buf.device
    for name, t, dtype in (("trans_flat", trans_flat, torch.int32),
                           ("classes", classes, torch.int32),
                           ("buf", buf, torch.uint8),
                           ("match_count", match_count, torch.int64)):
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.dim() != 1:
            raise ValueError(f"{name} must be 1-D")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    sa = trans_flat.numel()
    if sa > MAX_INDEX:
        raise ValueError(f"a table of {sa} entries passes the kernels' "
                         f"int32 index")
    if A < 1 or sa % A or not 0 <= start < sa // A or classes.numel() != 256:
        raise ValueError(f"a table of {sa} entries, {A} classes, start "
                         f"{start} and {classes.numel()} byte classes")
    if match_count is not None and match_count.numel() != sa // A:
        raise ValueError("match_count needs one entry per state")
    if dev.type == "cuda":
        for name, t in (("trans_flat", trans_flat), ("classes", classes),
                        ("buf", buf), ("match_count", match_count)):
            if t is not None and not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
        if buf.numel() % 16 or buf.data_ptr() % 16 or not buf.numel():
            raise ValueError("the kernels take a 16-byte aligned buffer of "
                             "whole 16-byte words")
    return dev


# ---------------------------------------------------------------------------
# W1: per-position states
# ---------------------------------------------------------------------------
def walk_states(trans_flat: torch.Tensor, classes: torch.Tensor,
                buf: torch.Tensor, A: int, start: int, block_len: int,
                halo: int) -> torch.Tensor:
    """W1: the states [n_pad] int32 of the uint8 buffer ``buf``: ``out[i]``
    is the state after byte i, each block of ``block_len`` bytes (on the
    card: each sub-block of ``walk_plan``) walked from ``start`` over the
    ``halo`` bytes before it."""
    dev = _check(trans_flat, classes, buf, A, start)
    if dev.type == "cpu":
        return walk_states_plain(trans_flat, classes, buf, A, start,
                                 block_len, halo)
    return _states_on_card(trans_flat, classes, buf, A, start, halo,
                           walk_plan(buf.numel(), halo),
                           table_in_shared(trans_flat))


def _states_on_card(trans_flat, classes, buf, A: int, start: int,
                    halo: int, sub: int, shared: bool) -> torch.Tensor:
    """W1's launch on checked CUDA tensors: one thread per sub-block of
    ``sub`` bytes, the table in shared memory or not as ``shared`` says
    (``walk_states`` passes ``walk_plan`` and ``table_in_shared``; the
    card tests pass the JAX layout's blocks and the other place too)."""
    global walk_launches, walk_shape
    n = buf.numel()
    out = torch.empty(n, dtype=torch.int32, device=buf.device)
    launch(buf.device, LIBRARY.load().walk_states, "walk_states",
           trans_flat.data_ptr(), trans_flat.numel(), classes.data_ptr(),
           buf.data_ptr(), n, A, start, sub, halo, int(shared),
           out.data_ptr())
    walk_launches += 1
    walk_shape = (n, -(-n // sub), sub, halo, shared)
    return out


def walk_states_plain(trans_flat: torch.Tensor, classes: torch.Tensor,
                      buf: torch.Tensor, A: int, start: int, block_len: int,
                      halo: int) -> torch.Tensor:
    """Plain PyTorch version of W1, any device: the B blocks walk in
    lockstep, one ``index_select`` per byte step of a block.

    Block b walks the ``halo`` bytes before it, then its own ``block_len``
    bytes, recording each state. Halo steps that fall before the buffer's
    start are skipped (the state stays the start state), as the JAX count
    jit's ``valid = idx >= 0`` does: with a halo longer than a block this
    covers the first ``ceil(halo / block_len)`` blocks, not block 0 only.
    A last block shorter than ``block_len`` walks padding past the end,
    whose states are dropped."""
    n = buf.numel()
    c = classes[buf.to(torch.int64)]  # [n] int32
    nb = -(-n // block_len)
    if nb * block_len != n:
        c = torch.nn.functional.pad(c, (0, nb * block_len - n))
    body = c.reshape(nb, block_len).T.contiguous()  # [L, B]
    s = torch.full((nb,), start, dtype=torch.int32, device=c.device)
    if halo:
        # Block b's halo step t reads c[b*L - halo + t], also where the
        # halo is longer than a block (the JAX package's roll-and-reshape
        # windows cover halo <= block_len only).
        starts = torch.arange(nb, device=c.device) * block_len
        offs = torch.arange(-halo, 0, device=c.device)
        idx = starts[None, :] + offs[:, None]  # [halo, B]
        valid = idx >= 0
        halo_part = c[idx.clamp_min(0)]
        for t in range(halo):
            s2 = torch.index_select(
                trans_flat, 0, torch.add(halo_part[t], s, alpha=A))
            s = torch.where(valid[t], s2, s)
    states = torch.empty((block_len, nb), dtype=torch.int32, device=c.device)
    for t in range(block_len):
        torch.index_select(trans_flat, 0, torch.add(body[t], s, alpha=A),
                           out=states[t])
        s = states[t]
    return states.T.reshape(-1)[:n]


# ---------------------------------------------------------------------------
# W2: the count over a window
# ---------------------------------------------------------------------------
def walk_count(trans_flat: torch.Tensor, classes: torch.Tensor,
               buf: torch.Tensor, A: int, start: int, block_len: int,
               halo: int, match_count: torch.Tensor, n0: int,
               n1: int) -> torch.Tensor:
    """W2: the sum of ``match_count[state]`` (int64 [S]) over the positions
    ``[n0, n1)`` of the walk ``walk_states`` takes, as a 0-d int64 tensor;
    on the card the states are never stored: each block of threads writes
    one partial sum, and the partials are summed here."""
    dev = _check(trans_flat, classes, buf, A, start, match_count)
    n = buf.numel()
    if not 0 <= n0 <= n1 <= n:
        raise ValueError(f"window [{n0}, {n1}) outside the {n}-byte buffer")
    if dev.type == "cpu":
        return walk_count_plain(trans_flat, classes, buf, A, start,
                                block_len, halo, match_count, n0, n1)
    return _count_on_card(trans_flat, classes, buf, A, start, halo,
                          match_count, n0, n1, walk_plan(n, halo),
                          table_in_shared(trans_flat))


def _count_on_card(trans_flat, classes, buf, A: int, start: int, halo: int,
                   match_count, n0: int, n1: int, sub: int,
                   shared: bool) -> torch.Tensor:
    """W2's launch on checked CUDA tensors, as ``_states_on_card`` (and
    chip_smoke.py times both places of the table on one input)."""
    global count_launches, count_shape
    n = buf.numel()
    partials = torch.empty(count_blocks(n, sub), dtype=torch.int64,
                           device=buf.device)
    launch(buf.device, LIBRARY.load().walk_count, "walk_count",
           trans_flat.data_ptr(), trans_flat.numel(), classes.data_ptr(),
           buf.data_ptr(), n, A, start, sub, halo, int(shared),
           match_count.data_ptr(), n0, n1, partials.data_ptr())
    count_launches += 1
    count_shape = (n, -(-n // sub), sub, halo, shared)
    return partials.sum()


def walk_count_plain(trans_flat: torch.Tensor, classes: torch.Tensor,
                     buf: torch.Tensor, A: int, start: int, block_len: int,
                     halo: int, match_count: torch.Tensor, n0: int,
                     n1: int) -> torch.Tensor:
    """Plain PyTorch version of W2, any device: the states of
    ``walk_states_plain``, then the window's sum of their match counts."""
    states = walk_states_plain(trans_flat, classes, buf, A, start,
                               block_len, halo)
    return match_count[states[n0:n1].to(torch.int64)].sum()
