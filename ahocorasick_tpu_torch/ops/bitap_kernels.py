"""Wrappers of the Hopper shift-AND kernels (csrc/bitap.cu), with their
plain PyTorch versions.

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
the main path went through.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading
from typing import Optional, Sequence, Tuple

import torch

from .. import _build

# Launches of each kernel since the last reset (plain versions not counted).
generic_launches = 0
baked_launches = 0

# Limbs held in registers by the kernel; beyond this the state spills to a
# global scratch that the wrapper allocates.
MAX_REG_LIMBS = 64

_SRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "csrc", "bitap.cu",
)
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_path: Optional[str] = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong


def reset_counts() -> None:
    global generic_launches, baked_launches
    generic_launches = 0
    baked_launches = 0


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def load_library() -> ctypes.CDLL:
    """Build (first call only) and load the kernels' shared library."""
    global _lib, _lib_path
    with _lock:
        if _lib is not None:
            return _lib
        so = _build.build_shared(_SRC, "bitap", [_nvcc()] + NVCC_FLAGS)
        lib = ctypes.CDLL(so)
        lib.bitap_generic_scan.restype = _I
        lib.bitap_generic_scan.argtypes = [
            _P, _P, _P, _P, _I, _P, _I, _P, _I, _I, _LL, _LL, _P, _P, _P, _P,
        ]
        lib.bitap_baked_scan.restype = _I
        lib.bitap_baked_scan.argtypes = [
            _P, _P, _P, _P, _I, _I, _P, _I, _P, _I, _I, _P, _P, _P, _P,
        ]
        _lib, _lib_path = lib, so
        return lib


def build_report() -> str:
    """The compiler's output for the loaded library (ptxas -v lines)."""
    load_library()
    return _build.build_log(_lib_path)


# ---------------------------------------------------------------------------
# Argument checks
# ---------------------------------------------------------------------------
def _check(lo, hi, sm, em, halo, body) -> Tuple[int, int, int, int]:
    """Validate the scan inputs; returns (K, Hw, Wb, tiles)."""
    dev = body.device
    for name, t in (("lo", lo), ("hi", hi), ("start", sm), ("end", em),
                    ("halo", halo), ("body", body)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, body on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    K = lo.shape[0]
    if K < 1 or lo.shape != (K, 16) or hi.shape != (K, 16):
        raise ValueError(f"lo/hi must be [K, 16], got {tuple(lo.shape)}, "
                         f"{tuple(hi.shape)}")
    if sm.shape != (K,) or em.shape != (K,):
        raise ValueError(f"start/end must be [{K}]")
    if body.dim() != 3 or body.shape[2] != 128 or body.shape[1] % 8:
        raise ValueError(f"body must be [Wb, tiles*8, 128], got "
                         f"{tuple(body.shape)}")
    if halo.dim() != 3 or halo.shape[1:] != body.shape[1:]:
        raise ValueError(f"halo must be [Hw, {body.shape[1]}, 128], got "
                         f"{tuple(halo.shape)}")
    return K, halo.shape[0], body.shape[0], body.shape[1] // 8


def _outputs(dev: torch.device, K: int, kdim: int, Wb: int, tiles: int,
             extract: bool):
    """(counts [tiles,8,128], words [tiles,L,kdim,8,128] or None, limb
    state scratch [K*S] for K > MAX_REG_LIMBS or None), uninitialised:
    the kernel writes every element."""
    S = tiles * 1024
    counts = torch.empty((tiles, 8, 128), dtype=torch.int32, device=dev)
    words = (torch.empty((tiles, 4 * Wb, kdim, 8, 128), dtype=torch.int32,
                         device=dev) if extract else None)
    state = (torch.empty(K * S, dtype=torch.int32, device=dev)
             if K > MAX_REG_LIMBS else None)
    return counts, words, state


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _stream_ptr(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(
            f"{name} launch failed: CUDA error {err} "
            f"({torch.cuda.get_device_name()})"
        )


# ---------------------------------------------------------------------------
# G1: table-generic, position-masked
# ---------------------------------------------------------------------------
def bitap_scan_generic(lo, hi, sm, em, halo, body, n0: int, n: int,
                       extract: bool):
    """(counts [tiles,8,128], words [tiles,L,K,8,128] or None)."""
    global generic_launches
    K, Hw, Wb, tiles = _check(lo, hi, sm, em, halo, body)
    dev = body.device
    if dev.type == "cpu":
        return bitap_scan_generic_plain(lo, hi, sm, em, halo, body, n0, n,
                                        extract)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    lib = load_library()
    S = tiles * 1024
    counts, words, state = _outputs(dev, K, K, Wb, tiles, extract)
    with torch.cuda.device(dev):
        err = lib.bitap_generic_scan(
            lo.data_ptr(), hi.data_ptr(), sm.data_ptr(), em.data_ptr(), K,
            halo.data_ptr(), Hw, body.data_ptr(), Wb, S, n0, n,
            counts.data_ptr(), _ptr(words), _ptr(state), _stream_ptr(dev),
        )
    _raise_on(err, "bitap_generic_scan")
    generic_launches += 1
    return counts, words


def bitap_scan_generic_plain(lo, hi, sm, em, halo, body, n0: int, n: int,
                             extract: bool):
    """Plain PyTorch version of G1 (same outputs, any device)."""
    return _scan_plain(lo, hi, sm, em, halo, body, (n0, n),
                       list(range(lo.shape[0])), extract)


# ---------------------------------------------------------------------------
# G2: pad-byte padded, unmasked, end-bearing limbs only
# ---------------------------------------------------------------------------
def bitap_scan_baked(lo, hi, sm, em, end_limbs: Sequence[int], halo, body,
                     extract: bool):
    """(counts [tiles,8,128], words [tiles,L,Ke,8,128] or None), with
    ``Ke = len(end_limbs)``; ``end_limbs`` lists the limbs whose end mask
    is nonzero, in order (the word axis follows it)."""
    global baked_launches
    K, Hw, Wb, tiles = _check(lo, hi, sm, em, halo, body)
    dev = body.device
    if dev.type == "cpu":
        return bitap_scan_baked_plain(lo, hi, sm, em, end_limbs, halo, body,
                                      extract)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    Ke = len(end_limbs)
    if Ke < 1:
        raise ValueError("a baked scan needs at least one end-bearing limb")
    lib = load_library()
    S = tiles * 1024
    counts, words, state = _outputs(dev, K, Ke, Wb, tiles, extract)
    with torch.cuda.device(dev):
        err = lib.bitap_baked_scan(
            lo.data_ptr(), hi.data_ptr(), sm.data_ptr(), em.data_ptr(), K,
            Ke, halo.data_ptr(), Hw, body.data_ptr(), Wb, S,
            counts.data_ptr(), _ptr(words), _ptr(state), _stream_ptr(dev),
        )
    _raise_on(err, "bitap_baked_scan")
    baked_launches += 1
    return counts, words


def bitap_scan_baked_plain(lo, hi, sm, em, end_limbs: Sequence[int], halo,
                           body, extract: bool):
    """Plain PyTorch version of G2 (same outputs, any device)."""
    return _scan_plain(lo, hi, sm, em, halo, body, None, list(end_limbs),
                       extract)


# ---------------------------------------------------------------------------
# Plain version shared by both kernels
# ---------------------------------------------------------------------------
_M32 = 0xFFFFFFFF


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns as unsigned values in int64 (torch has no
    uint32 shifts or adds, and `>>` on int32 is arithmetic)."""
    return x.to(torch.int64) & _M32


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Popcount of int64 values below 2^32 (torch has no popcount op)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & _M32) >> 24


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    """Unsigned 32-bit values (int64) back to int32 bit patterns."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def _scan_plain(lo, hi, sm, em, halo, body, window, out_limbs, extract):
    """Vectorised over streams and limbs, looping over bytes."""
    Hw, R8, _ = halo.shape
    Wb = body.shape[0]
    S = R8 * 128
    tiles = R8 // 8
    L = 4 * Wb
    K = lo.shape[0]
    dev = body.device
    lo64, hi64 = _u32(lo), _u32(hi)
    sm64 = _u32(sm)[:, None]
    em64 = _u32(em)[:, None]
    halo64 = _u32(halo.reshape(Hw, S))
    body64 = _u32(body.reshape(Wb, S))
    m = torch.zeros((K, S), dtype=torch.int64, device=dev)

    def advance(m, b):
        cm = lo64[:, b & 15] & hi64[:, b >> 4]  # [K, S]
        carry = torch.zeros_like(m)
        carry[1:] = m[:-1] >> 31
        return (((m << 1) & _M32) | carry | sm64) & cm

    for w in range(Hw):
        word = halo64[w]
        for jj in range(4):
            m = advance(m, (word >> (8 * jj)) & 255)
    m[:, 0] = 0  # stream 0's halo wraps around the buffer end

    pos0 = torch.arange(S, dtype=torch.int64, device=dev) * L
    counts = torch.zeros(S, dtype=torch.int64, device=dev)
    limbs = torch.as_tensor(out_limbs, dtype=torch.int64, device=dev)
    words = (torch.empty((L, len(out_limbs), S), dtype=torch.int64,
                         device=dev) if extract else None)
    for w in range(Wb):
        word = body64[w]
        for jj in range(4):
            t = 4 * w + jj
            m = advance(m, (word >> (8 * jj)) & 255)
            h = m & em64
            if window is not None:
                pos = pos0 + t
                ok = (pos >= window[0]) & (pos < window[1])
                h = h * ok
            counts += _popcount32(h).sum(0)
            if extract:
                words[t] = h[limbs]
    counts32 = counts.to(torch.int32).reshape(tiles, 8, 128)
    if not extract:
        return counts32, None
    kd = len(out_limbs)
    words = words.reshape(L, kd, tiles, 1024).permute(2, 0, 1, 3)
    return counts32, _to_i32(words.reshape(tiles, L, kd, 8, 128))
