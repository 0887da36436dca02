"""Wrappers of the Hopper shift-AND kernels (csrc/bitap.cu), with their
plain PyTorch versions, and the plain shift-AND core the other kernel
modules (``staged_kernels``, ``fingerprint_kernels``) share.

``bitap_scan_generic`` runs kernel G1 (the port of the JAX package's
``ops/bitap.py::_make_kernel``): tables at run time, positions masked to a
window ``[n0, n)``, end words for all K limbs. ``bitap_scan_baked`` runs
kernel G2 (the port of ``_make_baked_kernel``): a buffer padded with the
pattern set's pad byte, no mask, end words for the end-bearing limbs only.

Layouts are the JAX package's, so raw outputs compare directly:
``halo [Hw, tiles*8, 128]`` and ``body [L/4, tiles*8, 128]`` int32 words
(little-endian, 4 bytes each, stream ``s = (tile*8 + row)*128 + col``
covering bytes ``s*L .. s*L+L-1``), per-stream counts ``[tiles, 8, 128]``
and end words ``[tiles, L, K or Ke, 8, 128]``.

On a CPU tensor a wrapper computes its kernel's plain version; on a CUDA
tensor it launches the kernel (building it with ``nvcc`` at first use) or
raises. Each wrapper counts its launches in a module-level integer
(``generic_launches``, ``baked_launches``) so a run can show which kernels
the main path went through, and keeps the ``(threads, P, Ls, G)`` it last
launched with (``generic_plan``, ``baked_plan``).

Beyond 64 limbs G1/G2 (and G3/G4, ``staged_kernels``) run limb groups:
the K limbs of a stream are split over G lanes of a warp, KR limbs each in
registers (``limb_group``), so a launch has S * P * G threads
(``scan_plan``). No kernel keeps limb state in device memory.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import torch

from .. import _build
from .._build import I, LL, P

# Launches of each kernel since the last reset (plain versions not counted).
generic_launches = 0
baked_launches = 0
# (threads, P, Ls, G) of each kernel's last launch: S * P * G threads, P
# segments of Ls bytes per stream, G lanes per stream.
generic_plan: Optional[Tuple[int, int, int, int]] = None
baked_plan: Optional[Tuple[int, int, int, int]] = None

# Limbs one thread holds in registers (the largest bucket of
# SHIFT_AND_FOR_BUCKET, csrc/shift_and.cuh). Beyond it, G1-G4 split the
# limbs over a limb group of lanes.
MAX_REG_LIMBS = 64
# A limb group: at most a warp's 32 lanes of KR = 32 limbs each, then of
# KR = 64 (csrc/shift_and.cuh). 2,048 pattern bytes, the bit-parallel
# engine's bound, never need more than MAX_GROUP_LIMBS limbs.
GROUP_LIMBS = (32, 64)
MAX_GROUP = 32
MAX_GROUP_LIMBS = MAX_GROUP * GROUP_LIMBS[-1]
# Threads per block and ring slots of G1/G2's group kernel (kGroupThreads,
# kRing in the sources), and the dynamic shared memory one block may opt
# into on sm_90 (227 KiB): past it the group's tables stay in device
# memory.
GROUP_THREADS = 256
RING = 4
MAX_SHARED_BYTES = 232_448

LIBRARY = _build.CudaLibrary("bitap.cu", {
    "bitap_generic_scan": (P, P, P, P, I, P, I, P, I, I, I, I, I, I, LL, LL,
                           P, P, P),
    "bitap_baked_scan": (P, P, P, P, I, I, P, I, P, I, I, I, I, I, I, P, P,
                         P),
})


def reset_counts() -> None:
    global generic_launches, baked_launches
    generic_launches = 0
    baked_launches = 0


# ---------------------------------------------------------------------------
# Argument checks and launch plumbing (shared with the other kernel modules)
# ---------------------------------------------------------------------------
def check_tensors(words_name: str, words: torch.Tensor,
                  **tensors: torch.Tensor) -> None:
    """Every tensor int32, contiguous and on the device of ``words``, which
    must be the CPU or a CUDA device."""
    dev = words.device
    for name, t in ((words_name, words), *tensors.items()):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, {words_name} on "
                             f"{dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")


def check_tables(lo, hi, sm, em) -> int:
    """Validate the shapes of a scan's tables; returns K."""
    K = lo.shape[0]
    if K < 1 or lo.shape != (K, 16) or hi.shape != (K, 16):
        raise ValueError(f"lo/hi must be [K, 16], got {tuple(lo.shape)}, "
                         f"{tuple(hi.shape)}")
    if sm.shape != (K,) or em.shape != (K,):
        raise ValueError(f"start/end must be [{K}]")
    return K


def check_scan_args(lo, hi, sm, em, halo, body) -> Tuple[int, int, int, int]:
    """Validate the inputs of a shift-AND scan; returns (K, Hw, Wb, tiles)."""
    check_tensors("body", body, lo=lo, hi=hi, start=sm, end=em, halo=halo)
    K = check_tables(lo, hi, sm, em)
    if body.dim() != 3 or body.shape[2] != 128 or body.shape[1] % 8:
        raise ValueError(f"body must be [Wb, tiles*8, 128], got "
                         f"{tuple(body.shape)}")
    if halo.dim() != 3 or halo.shape[1:] != body.shape[1:]:
        raise ValueError(f"halo must be [Hw, {body.shape[1]}, 128], got "
                         f"{tuple(halo.shape)}")
    return K, halo.shape[0], body.shape[0], body.shape[1] // 8


@functools.lru_cache(maxsize=None)
def resident_threads(dev: torch.device) -> int:
    """Resident thread slots of the card: SMs x threads per SM (270,336 on
    an H100 SXM)."""
    props = torch.cuda.get_device_properties(dev)
    return props.multi_processor_count * props.max_threads_per_multi_processor


def segment_plan(L: int, H: int, S: int, align: int,
                 resident: int) -> Tuple[int, int]:
    """(P, Ls) of a launch with S threads per segment: each L-byte stream
    cut into P segments of Ls = L / P bytes, one thread per (segment,
    stream) (G5/G6; G1-G4 through ``scan_plan``).

    A segment warms up over the H bytes before it (the halo for segment 0,
    the stream's own bytes otherwise), which gives the state of a whole-
    stream scan bit for bit, since a state depends only on the last
    max_len - 1 <= H bytes. The plan takes the most segments such that
    ``Ls`` is a multiple of ``align`` (4 for end words, 32 for bitmap words
    and row-major ring slots), ``Ls >= H`` (the warm-up is at most half a
    thread's walk) and the S * P threads fit the card's ``resident`` thread
    slots. P = 1 where L leaves no room. Derived from the shapes and the
    card only."""
    if L % align:
        raise ValueError(f"L={L} is not a multiple of {align}")
    best = (1, L)
    for P in range(2, L // align + 1):
        if L // P < H or S * P > resident:
            break
        if (L // align) % P == 0:
            best = (P, L // P)
    return best


def limb_group(K: int) -> Tuple[int, int]:
    """(G, KR) of G1-G4 for K limbs: G lanes per stream, KR limbs held in
    registers by each. K <= MAX_REG_LIMBS: one lane holds all K (in the
    kernel's register bucket). Beyond: a limb group, KR = 32 (64 past
    32 x 32 limbs) and G the least power of two with G * KR >= K. From K
    alone."""
    if not 1 <= K <= MAX_GROUP_LIMBS:
        raise ValueError(f"no scan kernel for K={K} limbs (1 .. "
                         f"{MAX_GROUP_LIMBS})")
    if K <= MAX_REG_LIMBS:
        return 1, K
    KR = next(r for r in GROUP_LIMBS if MAX_GROUP * r >= K)
    G = 1
    while G * KR < K:
        G *= 2
    return G, KR


def group_tables_shared(K: int, G: int, KR: int,
                        ring_bytes: int = 4 * RING * GROUP_THREADS) -> bool:
    """Whether a limb group's tables fit in a block's shared memory beside
    its ring of ``ring_bytes`` (G1/G2's by default): lo and hi, one slice
    of KR limbs per lane that holds a live limb, each slice padded by
    32 / G words (group_shmem_bytes in csrc/bitap.cu and csrc/staged.cu)."""
    live = -(-K // KR)
    return 8 * live * (16 * KR + 32 // G) + ring_bytes <= MAX_SHARED_BYTES


def scan_plan(L: int, H: int, S: int, K: int, resident: int,
              align: int = 4) -> Tuple[int, int, int, int]:
    """(P, Ls, G, KR) of G1-G4: each L-byte stream in P segments of Ls
    bytes (as segment_plan: ``align`` 4 for G1/G2's end words, 32 for
    G3/G4's row-major ring slots), each (segment, stream) on G lanes of KR
    limbs (``limb_group``). The S * P * G threads fit the ``resident``
    thread slots, or P = 1 in as many waves as they need. No kernel keeps
    a limb scratch, so K puts no other cap on P."""
    G, KR = limb_group(K)
    P, Ls = segment_plan(L, H, S * G, align, resident)
    return P, Ls, G, KR


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def launch(dev: torch.device, fn, name: str, *args) -> None:
    """Call a kernel's C entry point on the current stream of ``dev`` and
    raise if the launch was refused."""
    with torch.cuda.device(dev):
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                           f"({torch.cuda.get_device_name(dev)})")


def padded_tables(lo, hi):
    """(lo, hi) [K, 16] as G1-G4 read them: views of allocations padded
    with zero limbs to whole slices of the limb group (``limb_group``),
    since where a group's tables stay in device memory (past K = 1,728 for
    G1/G2, 1,792 for G3/G4: ``group_tables_shared``) the last
    live lane reads rows past limb K - 1 up to its slice's end. Those rows
    feed only limbs with zero masks. The tables' owner pads once
    (``BitapTables.device_tensors``); for K <= 64 and beyond
    MAX_GROUP_LIMBS the tables come back as they are."""
    K = lo.shape[0]
    if not MAX_REG_LIMBS < K <= MAX_GROUP_LIMBS:
        return lo, hi
    rows = -(-K // limb_group(K)[1]) * limb_group(K)[1]
    return tuple(torch.nn.functional.pad(t, (0, 0, 0, rows - K))[:K]
                 for t in (lo, hi))


def tables_in_shared(lo, hi, K: int, G: int, KR: int,
                     ring_bytes: int = 4 * RING * GROUP_THREADS) -> int:
    """1 where a launch keeps its tables in shared memory (always for
    G = 1; for a limb group where ``group_tables_shared`` says so), else
    0, after checking that the allocations of lo and hi hold the whole
    slices that the lanes read (``padded_tables``)."""
    if G == 1 or group_tables_shared(K, G, KR, ring_bytes):
        return 1
    rows = -(-K // KR) * KR
    for name, t in (("lo", lo), ("hi", hi)):
        if t.untyped_storage().nbytes() // 4 - t.storage_offset() < 16 * rows:
            raise ValueError(f"{name} must be allocated to {rows} limbs for "
                             f"K={K} (use padded_tables)")
    return 0


def _outputs(dev: torch.device, kdim: int, Wb: int, tiles: int,
             extract: bool):
    """(counts [tiles,8,128] zeroed, as the segments add into them;
    words [tiles,L,kdim,8,128] or None, uninitialised: the kernel writes
    every element)."""
    counts = torch.zeros((tiles, 8, 128), dtype=torch.int32, device=dev)
    words = (torch.empty((tiles, 4 * Wb, kdim, 8, 128), dtype=torch.int32,
                         device=dev) if extract else None)
    return counts, words


# ---------------------------------------------------------------------------
# G1: table-generic, position-masked
# ---------------------------------------------------------------------------
def bitap_scan_generic(lo, hi, sm, em, halo, body, n0: int, n: int,
                       extract: bool):
    """(counts [tiles,8,128], words [tiles,L,K,8,128] or None)."""
    global generic_launches, generic_plan
    K, Hw, Wb, tiles = check_scan_args(lo, hi, sm, em, halo, body)
    dev = body.device
    if dev.type == "cpu":
        return bitap_scan_generic_plain(lo, hi, sm, em, halo, body, n0, n,
                                        extract)
    lib = LIBRARY.load()
    S = tiles * 1024
    nseg, Ls, G, KR = scan_plan(4 * Wb, 4 * Hw, S, K, resident_threads(dev))
    counts, words = _outputs(dev, K, Wb, tiles, extract)
    shared = tables_in_shared(lo, hi, K, G, KR)
    launch(dev, lib.bitap_generic_scan, "bitap_generic_scan",
           lo.data_ptr(), hi.data_ptr(), sm.data_ptr(), em.data_ptr(), K,
           halo.data_ptr(), Hw, body.data_ptr(), Wb, S, nseg, G, KR, shared,
           n0, n, counts.data_ptr(), ptr(words))
    generic_launches += 1
    generic_plan = (S * nseg * G, nseg, Ls, G)
    return counts, words


def bitap_scan_generic_plain(lo, hi, sm, em, halo, body, n0: int, n: int,
                             extract: bool):
    """Plain PyTorch version of G1 (same outputs, any device)."""
    return scan_plain(lo, hi, sm, em, halo, body, (n0, n),
                      list(range(lo.shape[0])), extract)


# ---------------------------------------------------------------------------
# G2: pad-byte padded, unmasked, end-bearing limbs only
# ---------------------------------------------------------------------------
def bitap_scan_baked(lo, hi, sm, em, end_limbs: Sequence[int], halo, body,
                     extract: bool):
    """(counts [tiles,8,128], words [tiles,L,Ke,8,128] or None), with
    ``Ke = len(end_limbs)``; ``end_limbs`` lists the limbs whose end mask
    is nonzero, in order (the word axis follows it)."""
    global baked_launches, baked_plan
    K, Hw, Wb, tiles = check_scan_args(lo, hi, sm, em, halo, body)
    dev = body.device
    if dev.type == "cpu":
        return bitap_scan_baked_plain(lo, hi, sm, em, end_limbs, halo, body,
                                      extract)
    Ke = len(end_limbs)
    if Ke < 1:
        raise ValueError("a baked scan needs at least one end-bearing limb")
    lib = LIBRARY.load()
    S = tiles * 1024
    nseg, Ls, G, KR = scan_plan(4 * Wb, 4 * Hw, S, K, resident_threads(dev))
    counts, words = _outputs(dev, Ke, Wb, tiles, extract)
    shared = tables_in_shared(lo, hi, K, G, KR)
    launch(dev, lib.bitap_baked_scan, "bitap_baked_scan",
           lo.data_ptr(), hi.data_ptr(), sm.data_ptr(), em.data_ptr(), K,
           Ke, halo.data_ptr(), Hw, body.data_ptr(), Wb, S, nseg, G, KR,
           shared, counts.data_ptr(), ptr(words))
    baked_launches += 1
    baked_plan = (S * nseg * G, nseg, Ls, G)
    return counts, words


def bitap_scan_baked_plain(lo, hi, sm, em, end_limbs: Sequence[int], halo,
                           body, extract: bool):
    """Plain PyTorch version of G2 (same outputs, any device)."""
    return scan_plain(lo, hi, sm, em, halo, body, None, list(end_limbs),
                      extract)


# ---------------------------------------------------------------------------
# The plain shift-AND core, vectorised over streams and limbs
# ---------------------------------------------------------------------------
_M32 = 0xFFFFFFFF


def u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns as unsigned values in int64 (torch has no
    uint32 shifts or adds, and `>>` on int32 is arithmetic)."""
    return x.to(torch.int64) & _M32


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Popcount of int64 values below 2^32 (torch has no popcount op)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & _M32) >> 24


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """Unsigned 32-bit values (int64) back to int32 bit patterns."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def or_limbs(h: torch.Tensor) -> torch.Tensor:
    """OR over the limb axis of [K, S] int64 words (torch has no OR
    reduction)."""
    out = h[0]
    for k in range(1, h.shape[0]):
        out = out | h[k]
    return out


class PlainScan:
    """The state of a plain scan: tables as unsigned int64 and the limb
    state ``m [K, S]``. ``step`` advances every stream by one byte,
    ``halo`` walks the warm-up words, ``bytes`` yields the body's bytes in
    order with their in-stream position."""

    def __init__(self, lo, hi, sm, em, S: int):
        self.lo, self.hi = u32(lo), u32(hi)
        self.sm = u32(sm)[:, None]
        self.em = u32(em)[:, None]
        self.m = torch.zeros((lo.shape[0], S), dtype=torch.int64,
                             device=lo.device)

    def step(self, b: torch.Tensor) -> torch.Tensor:
        m = self.m
        cm = self.lo[:, b & 15] & self.hi[:, b >> 4]  # [K, S]
        carry = torch.zeros_like(m)
        carry[1:] = m[:-1] >> 31
        self.m = (((m << 1) & _M32) | carry | self.sm) & cm
        return self.m

    @staticmethod
    def bytes(words: torch.Tensor):
        """(t, byte vector [S]) for the 4 * W bytes of words [W, ...]."""
        w64 = u32(words.reshape(words.shape[0], -1))
        for w in range(w64.shape[0]):
            for jj in range(4):
                yield 4 * w + jj, (w64[w] >> (8 * jj)) & 255

    def halo(self, halo: torch.Tensor, on_step=None) -> None:
        for _, b in self.bytes(halo):
            m = self.step(b)
            if on_step is not None:
                on_step(m)


def scan_plain(lo, hi, sm, em, halo, body, window, out_limbs, extract,
               sid=None):
    """Plain counts and end words of G1, G2 and the staged engine's G4.

    ``window`` masks positions to [n0, n) (None: no mask). ``sid`` [S]
    gives each lane's original stream (G4; -1 marks a pad lane, which
    counts nothing); None means lane s scans stream s."""
    S = body.shape[1] * 128
    tiles = S // 1024
    L = 4 * body.shape[0]
    dev = body.device
    ps = PlainScan(lo, hi, sm, em, S)
    ps.halo(halo)
    if sid is None:
        sid = torch.arange(S, dtype=torch.int64, device=dev)
    else:
        sid = sid.reshape(S).to(torch.int64)
    ps.m[:, sid == 0] = 0  # stream 0's halo wraps around the buffer end
    pos0 = sid * L
    live = sid >= 0
    counts = torch.zeros(S, dtype=torch.int64, device=dev)
    limbs = torch.as_tensor(out_limbs, dtype=torch.int64, device=dev)
    words = (torch.empty((L, len(out_limbs), S), dtype=torch.int64,
                         device=dev) if extract else None)
    for t, b in ps.bytes(body):
        h = ps.step(b) & ps.em
        if window is not None:
            pos = pos0 + t
            h = h * (live & (pos >= window[0]) & (pos < window[1]))
        counts += popcount32(h).sum(0)
        if extract:
            words[t] = h[limbs]
    counts32 = counts.to(torch.int32).reshape(tiles, 8, 128)
    if not extract:
        return counts32, None
    kd = len(out_limbs)
    words = words.reshape(L, kd, tiles, 1024).permute(2, 0, 1, 3)
    return counts32, to_i32(words.reshape(tiles, L, kd, 8, 128))
