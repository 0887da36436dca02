"""Wrappers of the staged engine's Hopper kernels (csrc/staged.cu), with
their plain PyTorch versions.

``staged_flags`` runs kernel G3 (the port of the JAX package's
``ops/staged.py::_make_flags_kernel``): per stream, the OR of the prefix
chains' end hits over halo and body, on a pad-byte padded haystack.
``staged_gathered`` runs kernel G4 (the port of ``_make_gathered_kernel``):
the exact scan over gathered candidate streams, each lane carrying its
original stream id (-1 for a pad lane), positions masked to ``[n0, n)``
in original coordinates.

Layouts are the JAX package's (see ``bitap_kernels``): flags and counts
``[tiles, 8, 128]`` int32, ``sid [tiles_c, 8, 128]`` int32, words
``[tiles_c, L, Ke, 8, 128]``. On a CPU tensor a wrapper computes its
kernel's plain version; on a CUDA tensor it launches the kernel or raises.
Launches are counted in ``flags_launches`` and ``gathered_launches``.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .. import _build
from .._build import I, LL, P
from .bitap_kernels import (
    PlainScan,
    check_scan_args,
    launch,
    or_limbs,
    ptr,
    scan_plain,
    spill_state,
    to_i32,
)

flags_launches = 0
gathered_launches = 0

LIBRARY = _build.CudaLibrary("staged.cu", {
    "staged_flags": (P, P, P, P, I, P, I, P, I, I, P, P, P),
    "staged_gathered": (P, P, P, P, I, I, P, P, I, P, I, I, LL, LL, P, P, P,
                        P),
})


def reset_counts() -> None:
    global flags_launches, gathered_launches
    flags_launches = 0
    gathered_launches = 0


# ---------------------------------------------------------------------------
# G3: stage-1 flags
# ---------------------------------------------------------------------------
def staged_flags(lo, hi, sm, em, halo, body) -> torch.Tensor:
    """Per-stream flag words [tiles, 8, 128] int32."""
    global flags_launches
    K, Hw, Wb, tiles = check_scan_args(lo, hi, sm, em, halo, body)
    dev = body.device
    if dev.type == "cpu":
        return staged_flags_plain(lo, hi, sm, em, halo, body)
    lib = LIBRARY.load()
    S = tiles * 1024
    flags = torch.empty((tiles, 8, 128), dtype=torch.int32, device=dev)
    launch(dev, lib.staged_flags, "staged_flags",
           lo.data_ptr(), hi.data_ptr(), sm.data_ptr(), em.data_ptr(), K,
           halo.data_ptr(), Hw, body.data_ptr(), Wb, S, flags.data_ptr(),
           ptr(spill_state(dev, K, S)))
    flags_launches += 1
    return flags


def staged_flags_plain(lo, hi, sm, em, halo, body) -> torch.Tensor:
    """Plain PyTorch version of G3 (same output, any device)."""
    S = body.shape[1] * 128
    ps = PlainScan(lo, hi, sm, em, S)
    fl = torch.zeros(S, dtype=torch.int64, device=body.device)

    def hit(m):
        nonlocal fl
        fl = fl | or_limbs(m & ps.em)

    ps.halo(halo, hit)
    ps.m[:, 0] = 0  # stream 0's halo wraps around: no history, no flag
    fl[0] = 0
    for _, b in ps.bytes(body):
        hit(ps.step(b))
    return to_i32(fl).reshape(S // 1024, 8, 128)


# ---------------------------------------------------------------------------
# G4: stage-2 exact scan over gathered candidate streams
# ---------------------------------------------------------------------------
def _check_sid(sid, body):
    if sid.dtype != torch.int32 or not sid.is_contiguous():
        raise TypeError("sid must be contiguous int32")
    if sid.device != body.device:
        raise ValueError(f"sid is on {sid.device}, body on {body.device}")
    if sid.numel() != body.shape[1] * 128:
        raise ValueError(f"sid must hold one id per lane "
                         f"({body.shape[1] * 128}), got {sid.numel()}")


def staged_gathered(lo, hi, sm, em, end_limbs: Sequence[int], sid, halo,
                    body, n0: int, n: int, extract: bool):
    """(counts [tiles_c,8,128], words [tiles_c,L,Ke,8,128] or None), with
    ``Ke = len(end_limbs)``."""
    global gathered_launches
    K, Hw, Wb, tiles = check_scan_args(lo, hi, sm, em, halo, body)
    _check_sid(sid, body)
    dev = body.device
    if dev.type == "cpu":
        return staged_gathered_plain(lo, hi, sm, em, end_limbs, sid, halo,
                                     body, n0, n, extract)
    Ke = len(end_limbs)
    if Ke < 1:
        raise ValueError("a gathered scan needs at least one end-bearing "
                         "limb")
    lib = LIBRARY.load()
    S = tiles * 1024
    counts = torch.empty((tiles, 8, 128), dtype=torch.int32, device=dev)
    words = (torch.empty((tiles, 4 * Wb, Ke, 8, 128), dtype=torch.int32,
                         device=dev) if extract else None)
    launch(dev, lib.staged_gathered, "staged_gathered",
           lo.data_ptr(), hi.data_ptr(), sm.data_ptr(), em.data_ptr(), K, Ke,
           sid.data_ptr(), halo.data_ptr(), Hw, body.data_ptr(), Wb, S, n0,
           n, counts.data_ptr(), ptr(words), ptr(spill_state(dev, K, S)))
    gathered_launches += 1
    return counts, words


def staged_gathered_plain(lo, hi, sm, em, end_limbs: Sequence[int], sid,
                          halo, body, n0: int, n: int, extract: bool):
    """Plain PyTorch version of G4 (same outputs, any device)."""
    return scan_plain(lo, hi, sm, em, halo, body, (n0, n), list(end_limbs),
                      extract, sid=sid)
