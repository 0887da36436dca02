"""Wrappers of the staged engine's Hopper kernels (csrc/staged.cu), with
their plain PyTorch versions.

``staged_flags`` runs kernel G3 (the port of the JAX package's
``ops/staged.py::_make_flags_kernel``): per stream, the OR of the prefix
chains' end hits over halo and body, on a pad-byte padded haystack.
``staged_gathered`` runs kernel G4 (the port of ``_make_gathered_kernel``):
the exact scan over candidate streams, each lane carrying its original
stream id (-1 for a pad lane), positions masked to ``[n0, n)`` in original
coordinates.

Both read the haystack words as uploaded: ``rows [ns, Wb]`` int32, row s
holding the L = 4 * Wb bytes of stream s; the halo of stream s is the last
``H`` bytes of row s - 1 (stream 0's wrap around the buffer). The JAX
kernels read a stream-major copy of the rows (and G4 a gathered one of the
candidates); the plain versions build those copies and run the JAX
kernels' arithmetic on them. Outputs keep the JAX package's layouts (see
``bitap_kernels``): flags and counts ``[tiles, 8, 128]`` int32, ``sid
[tiles_c, 8, 128]`` int32, words ``[tiles_c, L, Ke, 8, 128]``.

On a CPU tensor a wrapper computes its kernel's plain version; on a CUDA
tensor it launches the kernel or raises. Launches are counted in
``flags_launches`` and ``gathered_launches``; the ``(threads, P, Ls, G)``
of the last launch is kept in ``flags_plan`` and ``gathered_plan`` (the
kernels cut each stream into P segments of Ls bytes and, beyond 64 limbs,
give each (segment, stream) a limb group of G lanes: ``scan_plan``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from .. import _build
from .._build import I, LL, P
from .bitap_kernels import (
    GROUP_THREADS,
    PlainScan,
    check_tables,
    check_tensors,
    launch,
    or_limbs,
    ptr,
    resident_threads,
    scan_plain,
    scan_plan,
    tables_in_shared,
    to_i32,
)

flags_launches = 0
gathered_launches = 0
flags_plan: Optional[Tuple[int, int, int, int]] = None
gathered_plan: Optional[Tuple[int, int, int, int]] = None

# Segments of the staged kernels are whole ring slots: 32 bytes, one
# sector of a thread's run of row-major words (csrc/shift_and.cuh).
SEGMENT_ALIGN = 32
# Slots per ring column of the row-major ring (kRunRing).
RUN_RING = 3

LIBRARY = _build.CudaLibrary("staged.cu", {
    "staged_flags": (P, P, P, P, I, P, I, I, I, I, I, I, I, P, P),
    "staged_gathered": (P, P, P, P, I, I, P, P, I, I, I, I, I, I, I, LL, LL,
                        P, P, P),
})


def _group_ring_bytes(G: int) -> int:
    """Shared-memory bytes of a limb-group block's ring (group_ring_quads
    in csrc/shift_and.cuh): RUN_RING slots of 32 bytes per column, one
    column per stream of the block."""
    return RUN_RING * 32 * (GROUP_THREADS // G)


def _plan(lo, hi, K: int, Wb: int, H: int, S: int, dev):
    """(P, Ls, G, KR, tables in shared memory) of a launch over S lanes of
    4 * Wb bytes."""
    P, Ls, G, KR = scan_plan(4 * Wb, H, S, K, resident_threads(dev),
                             SEGMENT_ALIGN)
    shared = tables_in_shared(lo, hi, K, G, KR, _group_ring_bytes(G))
    return P, Ls, G, KR, shared


def reset_counts() -> None:
    global flags_launches, gathered_launches
    flags_launches = 0
    gathered_launches = 0


def _check_rows(lo, hi, sm, em, rows, H: int) -> Tuple[int, int, int, int]:
    """Validate the inputs of a staged scan; returns (K, Hw, Wb, ns)."""
    check_tensors("rows", rows, lo=lo, hi=hi, start=sm, end=em)
    K = check_tables(lo, hi, sm, em)
    if rows.dim() != 2 or rows.shape[0] % 1024 or rows.shape[1] % 8:
        raise ValueError(f"rows must be [tiles*1024, Wb] with Wb a multiple "
                         f"of 8, got {tuple(rows.shape)}")
    ns, Wb = rows.shape
    if H % 4 or not 0 <= H <= 4 * Wb:
        raise ValueError(f"halo {H} must be a multiple of 4 within a row "
                         f"({4 * Wb} bytes)")
    return K, H // 4, Wb, ns


def stream_major(rows, H: int, streams=None):
    """(halo [Hw, S/128, 128], body [Wb, S/128, 128]): the JAX package's
    stream-major layout of the streams ``streams`` (all by default) of the
    row-major words; halo row s holds the H bytes before stream s."""
    ns, Wb = rows.shape
    Hw = H // 4
    hrows = torch.roll(rows.reshape(-1), Hw).reshape(ns, Wb)[:, :Hw]
    body = rows
    if streams is not None:
        hrows, body = hrows[streams], rows[streams]
    S = body.shape[0]
    return (hrows.T.reshape(Hw, S // 128, 128).contiguous(),
            body.T.reshape(Wb, S // 128, 128).contiguous())


# ---------------------------------------------------------------------------
# G3: stage-1 flags
# ---------------------------------------------------------------------------
def staged_flags(lo, hi, sm, em, rows, H: int) -> torch.Tensor:
    """Per-stream flag words [tiles, 8, 128] int32 of ``rows [ns, Wb]``
    with an ``H``-byte halo."""
    global flags_launches, flags_plan
    K, Hw, Wb, ns = _check_rows(lo, hi, sm, em, rows, H)
    dev = rows.device
    if dev.type == "cpu":
        return staged_flags_plain(lo, hi, sm, em, rows, H)
    lib = LIBRARY.load()
    nseg, Ls, G, KR, shared = _plan(lo, hi, K, Wb, H, ns, dev)
    flags = torch.zeros((ns // 1024, 8, 128), dtype=torch.int32, device=dev)
    launch(dev, lib.staged_flags, "staged_flags",
           lo.data_ptr(), hi.data_ptr(), sm.data_ptr(), em.data_ptr(), K,
           rows.data_ptr(), Hw, Wb, ns, nseg, G, KR, shared,
           flags.data_ptr())
    flags_launches += 1
    flags_plan = (ns * nseg * G, nseg, Ls, G)
    return flags


def staged_flags_plain(lo, hi, sm, em, rows, H: int) -> torch.Tensor:
    """Plain PyTorch version of G3 (same output, any device)."""
    halo, body = stream_major(rows, H)
    S = rows.shape[0]
    ps = PlainScan(lo, hi, sm, em, S)
    fl = torch.zeros(S, dtype=torch.int64, device=rows.device)

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
# G4: stage-2 exact scan of the candidate streams' rows
# ---------------------------------------------------------------------------
def _check_sid(sid, rows):
    if sid.dtype != torch.int32 or not sid.is_contiguous():
        raise TypeError("sid must be contiguous int32")
    if sid.device != rows.device:
        raise ValueError(f"sid is on {sid.device}, rows on {rows.device}")
    if sid.numel() % 1024 or sid.numel() == 0:
        raise ValueError(f"sid must hold whole tiles of 1024 lanes, got "
                         f"{sid.numel()}")


def staged_gathered(lo, hi, sm, em, end_limbs: Sequence[int], sid, rows,
                    H: int, n0: int, n: int, extract: bool):
    """(counts [tiles_c,8,128], words [tiles_c,L,Ke,8,128] or None), with
    ``Ke = len(end_limbs)``: lane i scans row ``sid[i]`` of ``rows`` (ids
    below ``rows.shape[0]``, which the kernel does not check, or -1)."""
    global gathered_launches, gathered_plan
    K, Hw, Wb, _ = _check_rows(lo, hi, sm, em, rows, H)
    _check_sid(sid, rows)
    dev = rows.device
    if dev.type == "cpu":
        return staged_gathered_plain(lo, hi, sm, em, end_limbs, sid, rows, H,
                                     n0, n, extract)
    Ke = len(end_limbs)
    if Ke < 1:
        raise ValueError("a gathered scan needs at least one end-bearing "
                         "limb")
    lib = LIBRARY.load()
    S = sid.numel()
    nseg, Ls, G, KR, shared = _plan(lo, hi, K, Wb, H, S, dev)
    # Counts are sums of the segments' atomicAdds; every end word is
    # written (zeros for pad lanes).
    counts = torch.zeros((S // 1024, 8, 128), dtype=torch.int32, device=dev)
    words = (torch.empty((S // 1024, 4 * Wb, Ke, 8, 128), dtype=torch.int32,
                         device=dev) if extract else None)
    launch(dev, lib.staged_gathered, "staged_gathered",
           lo.data_ptr(), hi.data_ptr(), sm.data_ptr(), em.data_ptr(), K, Ke,
           sid.data_ptr(), rows.data_ptr(), Hw, Wb, S, nseg, G, KR, shared,
           n0, n, counts.data_ptr(), ptr(words))
    gathered_launches += 1
    gathered_plan = (S * nseg * G, nseg, Ls, G)
    return counts, words


def staged_gathered_plain(lo, hi, sm, em, end_limbs: Sequence[int], sid,
                          rows, H: int, n0: int, n: int, extract: bool):
    """Plain PyTorch version of G4 (same outputs, any device): the JAX
    package's gathered stream-major copy of the candidate rows (pad lanes
    read stream 0's), scanned by ``scan_plain``."""
    safe = sid.reshape(-1).to(torch.int64).clamp(min=0)
    halo, body = stream_major(rows, H, safe)
    return scan_plain(lo, hi, sm, em, halo, body, (n0, n), list(end_limbs),
                      extract, sid=sid)
