"""Bit-parallel shift-AND multi-pattern engine — the port's main path.

The PyTorch port of the JAX package's ``ops/bitap.py``. The algorithm and
every host-side table and layout are the same (and copied unchanged):
all pattern byte chains are packed into ``K`` 32-bit limbs, and one step
per byte computes

    m' = ((m << 1) | start_mask) & charmask[byte]

with ``charmask[b] = lo[b & 15] & hi[b >> 4]``; a match of pattern ``p``
ends where its final chain bit is set. The haystack is cut into streams of
``L`` bytes, each warmed up over an ``H``-byte halo, laid out stream-major
on the device (``PackedHaystack``).

The scan runs in two hand-written Hopper kernels (``csrc/bitap.cu``, see
``bitap_kernels.py``): G1, table-generic with a position mask (haystacks
below ``BAKED_MIN`` or sets without a pad byte), and G2, over a buffer
padded with the set's pad byte, unmasked, writing end words for the
end-bearing limbs only. Extraction compacts the nonzero end words
(``compaction.select_nonzero_words``) and decodes them on the host
(``decode_match_words``).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..utils import log
from . import bitap_kernels as _kernels
from .compaction import select_nonzero_words

R = 8            # sublanes per tile: [8, 128] int32 = one vreg
LANES = R * 128  # streams per grid tile

# Eligibility bounds for this engine (beyond them: dense-DFA fallback).
MAX_LIMBS = 64        # <= 2048 total pattern bytes
MAX_PATTERN_LEN = 2048
# Extraction processes at most this many haystack bytes per kernel launch
# (bounds the K-words-per-byte device output); count mode is unchunked.
MAX_EXTRACT_CHUNK = 1 << 23
# Haystacks at least this long use the pad-byte kernel variant (G2): no
# position masking. Below it, the table-generic kernel (G1) is used.
BAKED_MIN = 1 << 20


def _pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def _round_tiles(need: int) -> int:
    """Round a tile count up to <= 4 significant bits.

    Pallas grids are static, so every distinct tile count is a separate
    compile; pure power-of-two rounding bounded that diversity but cost
    up to 2x padding (the reference's own headline haystack, 595 KB,
    padded to 1 MiB and measured 12.4 us where ~8 us is the real scan).
    A 4-bit mantissa keeps padding waste under 1/8 with at most eight
    cached compiles per octave."""
    need = max(int(need), 1)
    if need <= 8:
        return need
    step = 1 << (need.bit_length() - 4)
    return -(-need // step) * step


def _layout_search(n: int, H: int, l_floor: int = 128,
                   l_cap: int = 2048) -> Tuple[int, int]:
    """(L, tiles) minimizing padded scan cost for an n-byte haystack.

    Cost model: every stream scans H halo bytes + L body bytes, so the
    total work is tiles * LANES * (L + H); small L trims pow2 padding
    (tiles need not be a power of two) while large L amortizes the halo
    warmup — 64 MiB still picks L=2048 (0.4% halo), 595 KB picks L=128
    x 5 tiles (10% padding instead of 76%)."""
    best = None
    L = _pow2(max(l_floor, H, 4))
    while L <= max(l_cap, _pow2(max(l_floor, H, 4))):
        tiles = _round_tiles(-(-n // (LANES * L)))
        cost = tiles * LANES * (L + H)
        if best is None or cost < best[0]:
            best = (cost, L, tiles)
        L *= 2
    return best[1], best[2]


def pack_chains(lens: List[int],
                decollide: bool = True) -> Tuple[List[int], int]:
    """Bin-pack chains into limbs so no chain crosses a 32-bit boundary.

    Returns (bit offset per chain, total limbs). A chain confined to one
    limb never needs the cross-limb carry (`(ms[k-1] >> 31) & 1`), which
    the baked kernel elides per limb — measured ~10% of the per-byte op
    budget on the 5-pattern headline set. Chains longer than 32 get
    dedicated consecutive limbs; only their internal boundaries carry.

    With ``decollide`` (the count kernel's layout), placement also
    de-collides end-bit positions mod 32 when slack allows, so counting
    can merge per-limb end-hit words into a single popcount (positions
    distinct across limbs => popcount(OR) is exact). The bitmap kernels
    (ops/fingerprint.py, ops/cascade.py) OR end hits into a single
    any-hit word instead, where the nudging would only waste limbs —
    they pack with ``decollide=False`` (measured: 67 same-length chains
    pack into 9 limbs instead of 42).

    First-fit-decreasing; padding bits are dead (their charmask is zero
    everywhere, so shifted-in garbage dies immediately).
    """
    order = sorted(range(len(lens)), key=lambda i: -lens[i])
    free: List[int] = []  # bits used so far in each open (partial) limb
    offsets = [0] * len(lens)
    used_ends = set()  # end-bit positions mod 32 taken so far

    def place(limb: int, off: int, ln: int) -> int:
        """Choose the in-limb start offset, nudging right (into padding)
        to keep end positions distinct mod 32 while it still fits."""
        if not decollide:
            return off
        end = off + ln - 1
        while end % 32 in used_ends and (off - limb * 32) + ln < 32:
            off += 1
            end += 1
        used_ends.add(end % 32)
        return off

    for i in order:
        ln = lens[i]
        if ln > 32:
            # Dedicated limbs; the remainder limb's tail is reusable.
            start_limb = len(free)
            free.extend([32] * (ln // 32))
            rem = ln % 32
            off = start_limb * 32
            used_ends.add((off + ln - 1) % 32)
            offsets[i] = off
            if rem:
                free.append(rem)
            continue
        for k, used in enumerate(free):
            if used + ln <= 32:
                off = place(k, k * 32 + used, ln)
                offsets[i] = off
                free[k] = off - k * 32 + ln
                break
        else:
            k = len(free)
            off = place(k, k * 32, ln)
            offsets[i] = off
            free.append(off - k * 32 + ln)
    return offsets, max(len(free), 1)


# ---------------------------------------------------------------------------
# Tables
# ---------------------------------------------------------------------------
class BitapTables:
    """Host-side compiled tables for a pattern set.

    ``lo[k, v]`` / ``hi[k, v]``: bits of limb ``k`` whose chain byte has low
    (high) nybble ``v``; ``charmask[b] = lo[b & 15] & hi[b >> 4]`` exactly.
    """

    def __init__(self, patterns: List[bytes], case_insensitive: bool):
        if not patterns or any(len(p) == 0 for p in patterns):
            raise ValueError("bitap tables need non-empty patterns")
        self.pattern_lens = np.array([len(p) for p in patterns], np.int64)
        self.max_pattern_len = int(self.pattern_lens.max())
        offsets, self.k = pack_chains([len(p) for p in patterns])
        self.nbits = self.k * 32
        K = self.k
        lo = np.zeros((K, 16), np.uint32)
        hi = np.zeros((K, 16), np.uint32)
        start = np.zeros(K, np.uint32)
        end = np.zeros(K, np.uint32)
        # end-bit -> pattern id (dense over all K*32 bits; -1 = not an end)
        self.endbit_pid = np.full(K * 32, -1, np.int64)
        for pid, p in enumerate(patterns):
            o = int(offsets[pid])
            start[o // 32] |= np.uint32(1 << (o % 32))
            e = o + len(p) - 1
            end[e // 32] |= np.uint32(1 << (e % 32))
            self.endbit_pid[e] = pid
            for i, ch in enumerate(p):
                g = o + i
                if case_insensitive and 0x61 <= (ch | 0x20) <= 0x7A:
                    variants = {ch | 0x20, ch & ~0x20}
                else:
                    variants = {ch}
                for v in variants:
                    lo[g // 32, v & 15] |= np.uint32(1 << (g % 32))
                    hi[g // 32, v >> 4] |= np.uint32(1 << (g % 32))
        self.lo = lo.view(np.int32)
        self.hi = hi.view(np.int32)
        self.start = start.view(np.int32)
        self.end = end.view(np.int32)
        # Limbs holding at least one chain-end bit; the pad-byte kernel
        # emits match words only for these (dense ke index).
        self.end_limbs = [k for k in range(K) if end[k]]
        # Canonical reference report order at equal end: length desc then
        # pattern id asc (match lists are own-match-first then
        # failure-copied, i.e. decreasing length; noncontiguous.rs:1357).
        order = np.lexsort(
            (np.arange(len(patterns)), -self.pattern_lens)
        )
        self.pid_rank = np.empty(len(patterns), np.int64)
        self.pid_rank[order] = np.arange(len(patterns))
        # A pad byte whose charmask is zero in every limb: padding the
        # haystack with it kills all chain bits, so the pad-byte kernel
        # can count/extract with no position masking at all. None if the
        # pattern set touches every byte value (then the masked generic
        # kernel is used instead).
        self.pad_byte: Optional[int] = None
        for b in range(256):
            if not (lo[:, b & 15] & hi[:, b >> 4]).any():
                self.pad_byte = b
                break
        self._on_device = {}

    def device_tensors(self, device: torch.device):
        """(lo, hi, start, end) as int32 tensors on ``device``, cached per
        device; lo and hi padded as G1/G2 read them (``padded_tables``)."""
        device = torch.device(device)
        if device not in self._on_device:
            lo, hi, sm, em = (torch.from_numpy(a).to(device) for a in (
                self.lo, self.hi, self.start, self.end))
            self._on_device[device] = (*_kernels.padded_tables(lo, hi), sm,
                                       em)
        return self._on_device[device]


def tables_on(cache: dict, device, arrays) -> tuple:
    """``arrays`` as tensors on ``device``, kept in ``cache`` per device
    (a mesh's shards each read their own device's copy)."""
    device = torch.device(device)
    if device not in cache:
        cache[device] = tuple(
            torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in arrays)
    return cache[device]


# ---------------------------------------------------------------------------
# Device layout
# ---------------------------------------------------------------------------
def upload(buf: np.ndarray, device) -> torch.Tensor:
    """A packed host buffer on ``device``: a call's host-to-device copy."""
    with log.span("prepare.upload"):
        log.count("h2d_bytes", buf.nbytes)
        return torch.from_numpy(buf).to(device)


@log.spanned("prepare.layout")
def _to_stream_major(x32: torch.Tensor, L: int, tiles: int, H: int):
    """Transpose packed words to the kernels' stream-major layout.

    ``x32`` holds the padded buffer as ``tiles * LANES * L / 4`` int32
    words. Returns ``halo [H/4, tiles*8, 128]`` (for stream s the H bytes
    before its block, i.e. the tail of stream s-1; stream 0's wraps around
    to the end of the buffer) and ``body [L/4, tiles*8, 128]``. Done once
    at upload time (see PackedHaystack).
    """
    Bp = tiles * LANES
    Wb = L // 4
    Hw = H // 4
    body = x32.reshape(Bp, Wb).T.reshape(Wb, Bp // 128, 128).contiguous()
    halo = torch.roll(x32, Hw).reshape(Bp, Wb)[:, :Hw].T
    halo = halo.reshape(Hw, Bp // 128, 128).contiguous()
    return halo, body


class PackedHaystack:
    """A haystack resident on the device in kernel layout: upload once,
    search many times. Engine entry points accept either raw bytes
    (packed + uploaded per call) or a PackedHaystack."""

    __slots__ = ("n", "L", "tiles", "baked", "halo_a", "body", "hs")

    def __init__(self, n, L, tiles, baked, halo_a, body, hs=None):
        self.n = n
        self.L = L
        self.tiles = tiles
        self.baked = baked      # packed with the engine's pad byte
        self.halo_a = halo_a    # [Hw, tiles*R, 128] int32, stream-major
        self.body = body        # [Wb, tiles*R, 128] int32, stream-major
        self.hs = hs            # original bytes (chunked-extract fallback)


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------
class BitapEngine:
    """Facade-facing engine: counts and full overlapping match sets."""

    def __init__(self, patterns: List[bytes], case_insensitive: bool,
                 device="cuda"):
        self.tables = BitapTables(patterns, case_insensitive)
        self.device = torch.device(device)
        # Halo: enough history for the longest chain (suffix property
        # needs max_pattern_len - 1 bytes), word-aligned.
        h = max(self.tables.max_pattern_len - 1, 1)
        self.halo = max(_pow2(h), 4)

    @classmethod
    def eligible(cls, patterns: List[bytes]) -> bool:
        if not patterns or any(len(p) == 0 for p in patterns):
            return False
        total = sum(len(p) for p in patterns)
        if total > 32 * MAX_LIMBS:
            return False
        if max(len(p) for p in patterns) > MAX_PATTERN_LEN:
            return False
        return True

    # ------------------------------------------------------------------
    def _layout(self, n: int) -> Tuple[int, int]:
        """(L, tiles) for an n-byte haystack, bucketed (pow2 L,
        <=4-significant-bit tiles) so layouts are shared across calls
        while padding waste stays under 1/8 (see _layout_search)."""
        H = self.halo
        base = _pow2(-(-n // LANES))
        if base < 128:
            # Sub-128K haystacks fit one tile with a sub-128 L.
            return max(H, base, 4), 1
        return _layout_search(n, H)

    def _pack(self, hs: bytes, L: int, tiles: int,
              pad: int = 0) -> np.ndarray:
        total = tiles * LANES * L
        buf = np.full(total, pad, np.uint8) if pad else np.zeros(
            total, np.uint8
        )
        buf[: len(hs)] = np.frombuffer(hs, np.uint8)
        return buf.view(np.int32)

    def _use_baked(self, n: int) -> bool:
        return n >= BAKED_MIN and self.tables.pad_byte is not None

    def _args(self):
        return self.tables.device_tensors(self.device)

    # ------------------------------------------------------------------
    @log.spanned("prepare")
    def prepare(self, hs: bytes,
                baked: Optional[bool] = None) -> PackedHaystack:
        """Upload a haystack into the device-resident kernel layout.

        Packing and the stream-major transpose happen once here; every
        later count/extract call on the PackedHaystack launches the scan
        kernel directly (the repeated-search path).

        ``baked`` overrides the size heuristic: small haystacks default
        to the table-generic kernel, ``baked=True`` asks for the pad-byte
        kernel (requires a pad byte).
        """
        n = len(hs)
        L, tiles = self._layout(max(n, 1))
        if baked is None:
            baked = self._use_baked(n)
        else:
            baked = bool(baked) and self.tables.pad_byte is not None
        pad = self.tables.pad_byte if baked else 0
        with log.span("prepare.pack"):
            buf = self._pack(hs, L, tiles, pad=pad)
        halo_a, body = _to_stream_major(upload(buf, self.device), L, tiles,
                                        self.halo)
        return PackedHaystack(n, L, tiles, baked, halo_a, body, hs)

    def _scan(self, ph: PackedHaystack, extract: bool):
        lo, hi, sm, em = self._args()
        if ph.baked:
            return _kernels.bitap_scan_baked(
                lo, hi, sm, em, self.tables.end_limbs, ph.halo_a, ph.body,
                extract,
            )
        return _kernels.bitap_scan_generic(
            lo, hi, sm, em, ph.halo_a, ph.body, 0, ph.n, extract,
        )

    @log.spanned("pass")
    def count_matches(self, hs) -> int:
        ph = hs if isinstance(hs, PackedHaystack) else self.prepare(hs)
        if ph.n == 0:
            return 0
        log.count("passes")
        counts, _ = self._scan(ph, extract=False)
        with log.read():
            return int(counts.sum())

    @log.spanned("pass")
    def match_pairs(self, hs) -> Tuple[np.ndarray, np.ndarray]:
        """All overlapping matches as (pids, ends) host arrays, in the
        reference's overlapping report order (end asc, length desc,
        pid asc). ``ends`` are 1-based end offsets."""
        ph = hs if isinstance(hs, PackedHaystack) else None
        if ph is not None:
            hs = ph.hs
        n = len(hs)
        t = self.tables
        if n == 0:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        # For extraction, bound the per-launch words output (n * 4K bytes).
        max_chunk = MAX_EXTRACT_CHUNK
        if n > max_chunk:
            all_pids, all_ends = [], []
            step = max_chunk
            ov = t.max_pattern_len - 1
            base = 0
            while base < n:
                hi_ = min(base + step, n)
                lo_ = max(0, base - ov)
                pids, ends = self.match_pairs(hs[lo_:hi_])
                keep = ends > (base - lo_)
                all_pids.append(pids[keep])
                all_ends.append(ends[keep] + lo_)
                base = hi_
            return (np.concatenate(all_pids), np.concatenate(all_ends))
        if ph is None:
            ph = self.prepare(hs)
        L, tiles, baked = ph.L, ph.tiles, ph.baked
        kdim = len(t.end_limbs) if baked else t.k
        log.count("passes")
        counts, words = self._scan(ph, extract=True)
        with log.read():
            total = int(counts.sum())
        if total == 0:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        flat = words.reshape(-1)
        words_size = tiles * L * kdim * LANES
        cap = 4096
        while True:
            nnzw, idx, vals, _ = select_nonzero_words(flat, cap)
            if nnzw <= cap:
                break
            cap = max(64, _pow2(nnzw))
        with log.read(2):
            idx, vals = idx.cpu().numpy(), vals.cpu().numpy()
        return decode_match_words(
            t, idx, vals.view(np.uint32), L, kdim, words_size,
            end_limbs=t.end_limbs if baked else None,
        )


@log.spanned("pass.order")
def decode_match_words(t: BitapTables, idx: np.ndarray, vals: np.ndarray,
                       L: int, kdim: int, words_size: int,
                       end_limbs=None,
                       stream_map=None) -> Tuple[np.ndarray, np.ndarray]:
    """Decode compacted nonzero end-bit words into (pids, ends).

    ``idx`` are flat indices into a [tiles, L, kdim, R, 128] word array
    (entries >= words_size are compaction fill and dropped); ``vals`` the
    corresponding uint32 words. ``end_limbs`` maps the dense word axis
    back to limb ids (the pad-byte kernel emits end-bearing limbs only).
    ``stream_map`` maps compacted lane order back to original stream ids
    (gathered-candidate layouts). Returns 1-based end offsets in the row
    buffer's coordinates, sorted in the reference's overlapping report
    order (end asc, length desc, pid asc).
    """
    real = idx < words_size
    idx, vals = idx[real], vals[real]
    c = idx % 128
    r = (idx // 128) % R
    k = (idx // (128 * R)) % kdim
    tt = (idx // (128 * R * kdim)) % L
    tile = idx // (128 * R * kdim * L)
    if end_limbs is not None:
        k = np.asarray(end_limbs, np.int64)[k]
    stream = (tile * R + r) * 128 + c
    if stream_map is not None:
        stream = np.asarray(stream_map, np.int64)[stream]
    pos = stream * L + tt  # 0-based byte index of the match end
    pids_l, ends_l = [], []
    for bit in range(32):
        m = (vals >> np.uint32(bit)) & np.uint32(1)
        rows = np.flatnonzero(m)
        if len(rows) == 0:
            continue
        g = k[rows] * 32 + bit
        pid = t.endbit_pid[g]
        pids_l.append(pid)
        ends_l.append(pos[rows] + 1)
    if not pids_l:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    pids = np.concatenate(pids_l)
    ends = np.concatenate(ends_l)
    order = np.lexsort((t.pid_rank[pids], ends))
    return pids[order], ends[order]
