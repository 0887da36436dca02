"""Wrappers of the fingerprint engine's Hopper kernels
(csrc/fingerprint.cu), with their plain PyTorch version.

``fp_bitmap_generic`` runs kernel G5 (the port of the JAX package's
``ops/fingerprint.py::_make_fp_kernel``): bucket-chain tables at run time,
positions masked to ``[n0, n)``. ``fp_bitmap_baked`` runs kernel G6 (the
port of ``_make_fp_baked_kernel``): a haystack padded with the set's
strong pad byte, no mask. Both return per-lane candidate counts
``[tiles, 8, 128]`` and the candidate bitmap ``[tiles, L/32, 8, 128]``
int32: bit ``t % 32`` of word ``t / 32`` of a stream is set where some
bucket chain ends at position ``t``.

On a CPU tensor a wrapper computes the plain version; on a CUDA tensor it
launches the kernel or raises. Launches are counted in
``generic_launches`` (G5) and ``baked_launches`` (G6), and the
``(threads, P, Ls)`` of each one's last launch kept in ``generic_plan`` and
``baked_plan``. The kernels hold at most 64 limbs in registers, all that
``FingerprintTables`` packs; a launch with more raises ``ValueError``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import _build
from .._build import I, LL, P
from .bitap_kernels import (
    MAX_REG_LIMBS,
    PlainScan,
    check_scan_args,
    launch,
    or_limbs,
    resident_threads,
    segment_plan,
    to_i32,
)

generic_launches = 0
baked_launches = 0
generic_plan: Optional[Tuple[int, int, int]] = None
baked_plan: Optional[Tuple[int, int, int]] = None

LIBRARY = _build.CudaLibrary("fingerprint.cu", {
    "fp_bitmap": (P, P, P, P, I, P, I, P, I, I, I, I, LL, LL, P, P, P),
})


def reset_counts() -> None:
    global generic_launches, baked_launches
    generic_launches = 0
    baked_launches = 0


def _bitmap(lo, hi, sm, em, halo, body,
            window: Optional[Tuple[int, int]]):
    """((counts, bitmap), the launch's (threads, P, Ls) or None on the
    CPU)."""
    K, Hw, Wb, tiles = check_scan_args(lo, hi, sm, em, halo, body)
    if Wb % 8:
        raise ValueError(f"the stream length 4*{Wb} must be a multiple of "
                         f"32 (one bitmap word per 32 positions)")
    dev = body.device
    if dev.type == "cpu":
        return fp_bitmap_plain(lo, hi, sm, em, halo, body, window), None
    if K > MAX_REG_LIMBS:
        raise ValueError(f"the bitmap kernels hold at most {MAX_REG_LIMBS} "
                         f"limbs, got K={K}")
    lib = LIBRARY.load()
    S = tiles * 1024
    nseg, Ls = segment_plan(4 * Wb, 4 * Hw, S, 32, resident_threads(dev))
    # Zeroed: the segments of a stream add into its count.
    counts = torch.zeros((tiles, 8, 128), dtype=torch.int32, device=dev)
    bitmap = torch.empty((tiles, Wb // 8, 8, 128), dtype=torch.int32,
                         device=dev)
    n0, n = window if window is not None else (0, 0)
    launch(dev, lib.fp_bitmap, "fp_bitmap",
           lo.data_ptr(), hi.data_ptr(), sm.data_ptr(), em.data_ptr(), K,
           halo.data_ptr(), Hw, body.data_ptr(), Wb, S, nseg,
           int(window is not None), n0, n, counts.data_ptr(),
           bitmap.data_ptr())
    return (counts, bitmap), (S * nseg, nseg, Ls)


def fp_bitmap_generic(lo, hi, sm, em, halo, body, n0: int, n: int):
    """G5: (counts [tiles,8,128], bitmap [tiles,L/32,8,128]), positions
    masked to [n0, n)."""
    global generic_launches, generic_plan
    out, plan = _bitmap(lo, hi, sm, em, halo, body, (n0, n))
    if plan is not None:
        generic_launches += 1
        generic_plan = plan
    return out


def fp_bitmap_baked(lo, hi, sm, em, halo, body):
    """G6: (counts [tiles,8,128], bitmap [tiles,L/32,8,128]) of a
    strong-pad-byte padded haystack, no mask."""
    global baked_launches, baked_plan
    out, plan = _bitmap(lo, hi, sm, em, halo, body, None)
    if plan is not None:
        baked_launches += 1
        baked_plan = plan
    return out


def fp_bitmap_plain(lo, hi, sm, em, halo, body,
                    window: Optional[Tuple[int, int]]):
    """Plain PyTorch version of G5 (``window`` = (n0, n)) and G6
    (``window`` None), any device."""
    S = body.shape[1] * 128
    tiles = S // 1024
    L = 4 * body.shape[0]
    dev = body.device
    ps = PlainScan(lo, hi, sm, em, S)
    ps.halo(halo)
    ps.m[:, 0] = 0  # stream 0's halo wraps around the buffer end
    pos0 = torch.arange(S, dtype=torch.int64, device=dev) * L
    counts = torch.zeros(S, dtype=torch.int64, device=dev)
    bitmap = torch.empty((L // 32, S), dtype=torch.int64, device=dev)
    acc = torch.zeros(S, dtype=torch.int64, device=dev)
    for t, b in ps.bytes(body):
        hit = (or_limbs(ps.step(b) & ps.em) != 0).to(torch.int64)
        if window is not None:
            pos = pos0 + t
            hit = hit * ((pos >= window[0]) & (pos < window[1]))
        acc |= hit << (t % 32)
        counts += hit
        if t % 32 == 31:
            bitmap[t // 32] = acc
            acc = torch.zeros_like(acc)
    bitmap = bitmap.reshape(L // 32, tiles, 1024).permute(1, 0, 2)
    return (counts.to(torch.int32).reshape(tiles, 8, 128),
            to_i32(bitmap.reshape(tiles, L // 32, 8, 128)))
