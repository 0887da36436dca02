"""Wrappers of the candidate stages' Hopper kernels (csrc/candidates.cu),
with their plain PyTorch versions.

The stages that follow the fingerprint bitmap (G5/G6) in one pass of the
fingerprint and cascade engines. The JAX package writes them in ``jnp`` and
XLA fuses them with the bitmap kernel into one dispatch
(``ops/fingerprint.py::_fp_verified_jit``, ``ops/cascade.py::_cascade_jit``);
here each is one kernel:

- ``cand_select`` (S1, the port of ``fingerprint.py::_rank_select`` over
  ``compaction.py::select_set_bits``): the first ``cap`` set bits of the
  bitmap ``[tiles, L/32, 8, 128]`` as haystack positions;
- ``fp_verify`` (S2, ``fingerprint.py::_device_verify`` with
  ``_gather_windows``): the fingerprint engine's cuckoo probes and pattern
  group compares per candidate and length class;
- ``cascade_probe`` (S3, ``cascade.py::_probe``): the cascade's exact-class
  and LONG probes per candidate;
- ``cascade_long_verify`` (S4, ``cascade.py::_expand_gid`` and the tail
  verify of ``_probe_expand_verify``): the LONG groups' expansion rows and
  their tail compares.

Every stage reads its candidates' W-byte windows straight from the verify
buffer ``u8f`` (``fingerprint._verify_buffer``): the window of a candidate
ending at position e starts at index e + 1. Scalars come back as 0-d int64
tensors, so a pass reads them from the card once, together.

On a CPU tensor a wrapper computes the plain version; on a CUDA tensor it
launches the kernel or raises. Launches are counted in ``select_launches``,
``verify_launches``, ``probe_launches`` and ``long_launches``, and the
shape of each one's last launch kept in ``select_shape`` (bitmap words,
cap), ``verify_shape`` (candidates, classes, output slots),
``probe_shape`` (candidates, exact classes, LONG) and ``long_shape``
(candidates, rows).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from .. import _build
from .._build import I, LL, P
from .bitap import R
from .bitap_kernels import launch
from .compaction import select_set_bits

FP_LEN = 8    # fingerprint bytes per bucket chain (cap): a window's anchor
LONG = 0      # cascade class id for patterns longer than KEY_LEN bytes
KEY_LEN = 8   # cascade exact-key bytes (two 32-bit words)
_M32 = 0xFFFFFFFF
SELECT_BLOCK_WORDS = 2048  # bitmap words per block of S1

select_launches = 0
verify_launches = 0
probe_launches = 0
long_launches = 0
select_shape: Optional[Tuple[int, int]] = None
verify_shape: Optional[Tuple[int, int, int]] = None
probe_shape: Optional[Tuple[int, int, bool]] = None
long_shape: Optional[Tuple[int, int]] = None

LIBRARY = _build.CudaLibrary("candidates.cu", {
    "cand_select": (P, LL, I, LL, P, P, P, P, P),
    "fp_verify": (P, P, P, I, I, LL, P, I, I, P, P, P, P, P),
    "cascade_probe": (P, P, P, I, LL, P, I, I, I, P, P, P, P, P, P, P, P),
    "cascade_long_verify": (P, P, P, P, P, I, P, P, I, I, LL, LL, I, P, P,
                            P, P, P),
}, headers=())


def reset_counts() -> None:
    global select_launches, verify_launches, probe_launches, long_launches
    select_launches = verify_launches = probe_launches = long_launches = 0


def _check(dev: torch.device, **tensors: torch.Tensor) -> None:
    """Every tensor on ``dev``, the CPU or a CUDA device; on a CUDA device
    contiguous, as the kernels read them (the plain versions take any
    layout: G5/G6's plain bitmap is a strided view)."""
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if dev.type == "cuda" and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _types(**tensors) -> None:
    """Each (tensor, dtype) pair of the same type, as the kernel reads it."""
    for name, (t, dtype) in tensors.items():
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")


def _check_candidates(u8f, e_pos, live) -> None:
    """The verify buffer and the candidates as the S2/S3 kernels read them."""
    _types(u8f=(u8f, torch.uint8), e_pos=(e_pos, torch.int64),
           live=(live, torch.bool))
    if e_pos.dim() != 1 or live.shape != e_pos.shape or not len(e_pos):
        raise ValueError("e_pos and live must be 1-D, of one length >= 1")


def _scalar(dev: torch.device) -> torch.Tensor:
    return torch.empty((), dtype=torch.int64, device=dev)


def _params(rows) -> ctypes.Array:
    """The class rows of a launch as the C entry point's int64 array."""
    flat = [int(v) for row in rows for v in row]
    return (ctypes.c_longlong * len(flat))(*flat)


# ---------------------------------------------------------------------------
# Windows and 32-bit arithmetic of the plain versions
# ---------------------------------------------------------------------------
def gather_windows(u8f: torch.Tensor, e_pos: torch.Tensor,
                   W: int) -> torch.Tensor:
    """[C, W] uint8 windows anchored at e_pos - (FP_LEN - 1): one index
    gather from the verify buffer (the TPU version's overlapping strided
    rows worked around slow element gathers there)."""
    idx = (e_pos + 1)[:, None] + torch.arange(W, device=e_pos.device)
    return u8f[idx]


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32) and a constant c < 2^32.

    x * c can pass 2^63, so c is split into 16-bit halves: each partial
    product stays below 2^48."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


# ---------------------------------------------------------------------------
# S1: candidate positions
# ---------------------------------------------------------------------------
def cand_select(bmp: torch.Tensor, L: int, cap: int):
    """S1: (ncand, e_pos [cap] int64, live [cap] bool) of the bitmap
    ``[tiles, L/32, 8, 128]`` int32: the first ``cap`` set bits in flat
    word order, then bit order, as positions ``stream * L + t32 * 32 +
    bit``, 0 past the count; ``ncand`` (0-d int64) counts every set bit."""
    global select_launches, select_shape
    dev = bmp.device
    _check(dev, bmp=bmp)
    _types(bmp=(bmp, torch.int32))
    if dev.type == "cpu":
        return cand_select_plain(bmp, L, cap)
    nwords = bmp.numel()
    if (L % 128 or nwords % SELECT_BLOCK_WORDS or cap < 1
            or bmp.data_ptr() % 16):
        raise ValueError(f"cand_select takes whole 16-byte aligned tiles "
                         f"of L % 128 == 0 and cap >= 1, got L={L}, "
                         f"{nwords} words, cap={cap}")
    lib = LIBRARY.load()
    sums = torch.empty(nwords // SELECT_BLOCK_WORDS + 1, dtype=torch.int64,
                       device=dev)
    e_pos = torch.empty(cap, dtype=torch.int64, device=dev)
    live = torch.empty(cap, dtype=torch.bool, device=dev)
    ncand = _scalar(dev)
    launch(dev, lib.cand_select, "cand_select", bmp.data_ptr(), nwords, L,
           cap, sums.data_ptr(), e_pos.data_ptr(), live.data_ptr(),
           ncand.data_ptr())
    select_launches += 1
    select_shape = (nwords, cap)
    return ncand, e_pos, live


def cand_select_plain(bmp: torch.Tensor, L: int, cap: int):
    """Plain PyTorch version of S1, any device."""
    count, widx, bitpos, live = select_set_bits(bmp.reshape(-1), cap)
    # Decode the flat [tiles, L//32, R, 128] word index to a position.
    c = widx % 128
    r = (widx // 128) % R
    t32 = (widx // (128 * R)) % (L // 32)
    tile = widx // (128 * R * (L // 32))
    stream = (tile * R + r) * 128 + c
    e_pos = torch.where(live, stream * L + t32 * 32 + bitpos, 0)
    ncand = torch.tensor(count, dtype=torch.int64, device=bmp.device)
    return ncand, e_pos, live


# ---------------------------------------------------------------------------
# S2: the fingerprint engine's device verify
# ---------------------------------------------------------------------------
def fp_verify(u8f: torch.Tensor, e_pos: torch.Tensor, live: torch.Tensor,
              n: int, tabs: Dict, W: int, extract: bool):
    """S2: (ok, pid, end, total) of every candidate against the verify
    tables ``tabs`` (``DeviceVerify.device_tables``: per class c, (mult, ha,
    hb, logT, tkeys [T] int64, gmax, grow [T, gmax*(W+8)] uint8)).

    Per class (ascending) and candidate, the gmax members of the slot's
    group: ``ok`` [sum of C*gmax] bool, ``pid`` int32, ``end`` int64 (match
    end, start + length) in the order class, candidate, member, or None
    unless ``extract``; ``total`` (0-d int64) counts the ok slots."""
    global verify_launches, verify_shape
    dev = u8f.device
    _check(dev, u8f=u8f, e_pos=e_pos, live=live)
    if dev.type == "cpu":
        return fp_verify_plain(u8f, e_pos, live, n, tabs, W, extract)
    _check_candidates(u8f, e_pos, live)
    C = e_pos.shape[0]
    rows, off = [], 0
    for c, (mult, ha, hb, logT, tkeys, gmax, grow) in sorted(tabs.items()):
        _check(dev, tkeys=tkeys, grow=grow)
        _types(tkeys=(tkeys, torch.int64), grow=(grow, torch.uint8))
        if grow.shape[1] != gmax * (W + 8):
            raise ValueError(f"class {c}: tables do not match W={W}")
        rows.append((tkeys.data_ptr(), grow.data_ptr(), off, mult, ha, hb,
                     c, logT, gmax))
        off += C * gmax
    lib = LIBRARY.load()
    ok = pid = end = None
    if extract:
        ok = torch.empty(off, dtype=torch.bool, device=dev)
        pid = torch.empty(off, dtype=torch.int32, device=dev)
        end = torch.empty(off, dtype=torch.int64, device=dev)
    total = _scalar(dev)
    launch(dev, lib.fp_verify, "fp_verify", u8f.data_ptr(), e_pos.data_ptr(),
           live.data_ptr(), C, W, n, _params(rows), len(rows), int(extract),
           _ptr(ok), _ptr(pid), _ptr(end), total.data_ptr())
    verify_launches += 1
    verify_shape = (C, len(rows), off)
    return ok, pid, end, total


def fp_verify_plain(u8f, e_pos, live, n: int, tabs: Dict, W: int,
                    extract: bool):
    """Plain PyTorch version of S2, any device.

    Per length class (ascending): the polynomial hash of the class's
    fingerprint bytes, two cuckoo probes, one row gather of the slot's
    packed pattern group, a compare of the window bytes each pattern
    covers, and the bounds sp >= 0, sp + len <= n."""
    wnd = gather_windows(u8f, e_pos, W)
    total = torch.zeros((), dtype=torch.int64, device=wnd.device)
    oks, pids_s, ends_s = [], [], []
    C = wnd.shape[0]
    w64 = wnd.to(torch.int64)
    for c, (mult, ha, hb, logT, tkeys, gmax, grow) in sorted(tabs.items()):
        found, gi = fp_probe(w64, c, mult, ha, hb, logT, tkeys)
        hit = found & live
        sp = e_pos - (c - 1)  # candidate match start for this class
        # ONE row gather: the slot's packed pattern group.
        row = grow[gi]
        rows_p = row[:, :gmax * W].reshape(C, gmax, W)
        pids = row[:, gmax * W:gmax * (W + 4)].contiguous().view(torch.int32)
        lens = row[:, gmax * (W + 4):].contiguous().view(torch.int32)
        # Compare window bytes inside [off, off+len); outside is dontcare.
        off = FP_LEN - c
        jpos = torch.arange(W, device=wnd.device)
        care = (jpos >= off) & (jpos < off + lens[:, :, None])
        eq = ((wnd[:, None, :] == rows_p) | ~care).all(dim=2)
        ok = (
            hit[:, None] & (pids >= 0) & eq
            & (sp >= 0)[:, None] & (sp[:, None] + lens <= n)
        )
        total = total + ok.sum()
        if extract:
            oks.append(ok.reshape(-1))
            pids_s.append(pids.reshape(-1))
            ends_s.append((sp[:, None] + lens).reshape(-1))
    if not extract:
        return None, None, None, total
    return torch.cat(oks), torch.cat(pids_s), torch.cat(ends_s), total


def fp_probe(w64: torch.Tensor, c: int, mult: int, ha: int, hb: int,
             logT: int, tkeys: torch.Tensor):
    """(found, slot) [C] of class c's cuckoo probes for the windows ``w64``
    [C, W] int64: the polynomial hash of the class's fingerprint bytes,
    found where one of its two slots holds it, slot the first that does,
    else the second."""
    h = torch.zeros(w64.shape[0], dtype=torch.int64, device=w64.device)
    for j in range(FP_LEN - c, FP_LEN):
        h = (mul32(h, mult) + w64[:, j]) & _M32
    # Cuckoo membership: two element gathers + compares.
    s1 = mul32(h, ha) >> (32 - logT)
    s2 = mul32(h, hb) >> (32 - logT)
    use1 = tkeys[s1] == h
    use2 = tkeys[s2] == h
    return use1 | use2, torch.where(use1, s1, s2)


# ---------------------------------------------------------------------------
# S3: the cascade's class probes
# ---------------------------------------------------------------------------
def _class_shape(c: int, Q: int) -> Tuple[int, int]:
    """(q, kb) of class c: its coarse prefix (``cascade._qlen``) and its key
    bytes."""
    if c == LONG:
        return Q, KEY_LEN
    return min(Q, c), min(c, KEY_LEN)


def cascade_probe(u8f: torch.Tensor, e_pos: torch.Tensor,
                  live: torch.Tensor, n: int, classes: Dict, Q: int, W: int,
                  extract: bool):
    """S3: (ok, pid, end, total, long) of every candidate against the
    cascade's class tables ``classes`` (``CascadeTables.device_tensors``:
    per class c, ((a1, a2, b1, b2), logT, records [T, 4] int64)).

    Per exact class (ascending) and candidate: ``ok`` [E, C] bool (a hit),
    ``pid`` and ``end`` [E, C] int64 (the winning record's pid, start + c),
    or None unless ``extract``; ``total`` (0-d int64) sums the hits'
    duplicate counts; ``long`` = (counts, lbase, lsp) [C] int64 of the LONG
    probe (the hit's group size else 0, the record's pid base, the start),
    or None without a LONG class."""
    global probe_launches, probe_shape
    dev = u8f.device
    _check(dev, u8f=u8f, e_pos=e_pos, live=live)
    if dev.type == "cpu":
        return cascade_probe_plain(u8f, e_pos, live, n, classes, Q, W,
                                   extract)
    _check_candidates(u8f, e_pos, live)
    C = e_pos.shape[0]
    exact = sorted(k for k in classes if k != LONG)
    has_long = LONG in classes
    rows = []
    for c in exact + ([LONG] if has_long else []):
        (a1, a2, b1, b2), logT, rec = classes[c]
        _check(dev, rec=rec)
        _types(rec=(rec, torch.int64))
        if rec.shape[1:] != (4,):
            raise ValueError(f"class {c}: records must be [T, 4]")
        rows.append((rec.data_ptr(), a1, a2, b1, b2, c,
                     *_class_shape(c, Q), logT))
    lib = LIBRARY.load()
    E = len(exact)
    ok = pid = end = None
    if extract:
        ok = torch.empty((E, C), dtype=torch.bool, device=dev)
        pid = torch.empty((E, C), dtype=torch.int64, device=dev)
        end = torch.empty((E, C), dtype=torch.int64, device=dev)
    long = None
    if has_long:
        long = tuple(torch.empty(C, dtype=torch.int64, device=dev)
                     for _ in range(3))
    total = _scalar(dev)
    launch(dev, lib.cascade_probe, "cascade_probe", u8f.data_ptr(),
           e_pos.data_ptr(), live.data_ptr(), C, n, _params(rows), E,
           int(has_long), int(extract), _ptr(ok), _ptr(pid), _ptr(end),
           *(_ptr(t) for t in (long or (None,) * 3)), total.data_ptr())
    probe_launches += 1
    probe_shape = (C, E, has_long)
    return ok, pid, end, total, long


def cascade_probe_plain(u8f, e_pos, live, n: int, classes: Dict, Q: int,
                        W: int, extract: bool):
    """Plain PyTorch version of S3, any device: the exact classes
    (ascending), then the LONG probe, over the gathered windows."""
    wnd = gather_windows(u8f, e_pos, W)
    dev = wnd.device
    C = wnd.shape[0]
    total = torch.zeros((), dtype=torch.int64, device=dev)
    parts = []
    for c in sorted(k for k in classes if k != LONG):
        hit, rec, sp = probe(classes[c], c, wnd, e_pos, live, n, Q)
        total = total + torch.where(hit, rec[:, 3], 0).sum()
        parts.append((hit, rec[:, 2], sp + c))
    ok = pid = end = None
    if extract and parts:
        ok, pid, end = (torch.stack(col) for col in zip(*parts))
    elif extract:  # LONG alone
        ok = torch.zeros((0, C), dtype=torch.bool, device=dev)
        pid = torch.zeros((0, C), dtype=torch.int64, device=dev)
        end = torch.zeros((0, C), dtype=torch.int64, device=dev)
    long = None
    if LONG in classes:
        hit, rec, sp = probe(classes[LONG], LONG, wnd, e_pos, live, n, Q)
        long = (torch.where(hit, rec[:, 3], 0), rec[:, 2].contiguous(), sp)
    return ok, pid, end, total, long


def class_key(wnd: torch.Tensor, c: int, Q: int):
    """(lo, hi) key words of the class-c window slice, as int64 values in
    [0, 2^32) (the JAX package builds the same bits in int32).

    The window is anchored at e_pos - (FP_LEN - 1); a class-c pattern
    (coarse prefix q = min(Q, c)) starts at column FP_LEN - q, so its
    key bytes occupy columns FP_LEN - q .. FP_LEN - q + min(c, 8) - 1.
    """
    q, kb = _class_shape(c, Q)
    col0 = FP_LEN - q
    w = wnd[:, col0:col0 + kb].to(torch.int64)
    lo = torch.zeros(wnd.shape[0], dtype=torch.int64, device=wnd.device)
    for j in range(min(kb, 4)):
        lo = (lo << 8) | w[:, j]
    hi = torch.zeros_like(lo)
    for j in range(4, kb):
        hi = (hi << 8) | w[:, j]
    return lo, hi


def probe(table, c: int, wnd, e_pos, live, n: int, Q: int):
    """One class probe: 2 record row gathers + key compares.

    Returns (hit, rec, sp) where rec is the winning [C, 4] record and sp
    the candidate pattern-start position for this class."""
    (a1, a2, b1, b2), logT, trec = table
    lo, hi = class_key(wnd, c, Q)
    q, kb = _class_shape(c, Q)
    sp = e_pos - (q - 1)
    sh = 32 - logT
    s1 = ((mul32(lo, a1) + mul32(hi, a2)) & _M32) >> sh
    s2 = ((mul32(lo, b1) + mul32(hi, b2)) & _M32) >> sh
    r1 = trec[s1]
    r2 = trec[s2]
    # A slot matches only when its key equals AND it is occupied
    # (count > 0): empty slots carry key (-1, -1), which an all-0xFF
    # window CAN produce — without the occupancy test such a window
    # would both fake-hit empty slots and shadow a real all-0xFF
    # pattern sitting in the other slot.
    h1 = (r1[:, 0] == lo) & (r1[:, 1] == hi) & (r1[:, 3] > 0)
    h2 = (r2[:, 0] == lo) & (r2[:, 1] == hi) & (r2[:, 3] > 0)
    rec = torch.where(h1[:, None], r1, r2)
    valid = live & (sp >= 0) & (sp + kb <= n)
    return (h1 | h2) & valid, rec, sp


# ---------------------------------------------------------------------------
# S4: the LONG groups' expansion and tail verify
# ---------------------------------------------------------------------------
def cascade_long_verify(counts, lbase, lsp, e_pos, u8f, pidarr, pv, n: int,
                        cap_e: int, tail_w0: int, W: int, extract: bool):
    """S4: (ok, pid, end, total, total_e) of the first ``cap_e`` rows of the
    LONG groups' expansion: row j belongs to the candidate whose group
    (``counts`` [C] from S3, inclusive cumsum by ``torch.cumsum``) holds
    it, and compares pattern ``pidarr[lbase + resid]``'s words from
    ``tail_w0`` (``pv`` [P, 2*Ww+1] int32: words, care masks, length)
    with the candidate's window. ``ok`` bool, ``pid`` and ``end`` int64
    [cap_e] (None unless ``extract``); ``total`` counts the ok rows and
    ``total_e`` (0-d int64) every row, also those past ``cap_e``."""
    global long_launches, long_shape
    dev = u8f.device
    _check(dev, counts=counts, lbase=lbase, lsp=lsp, e_pos=e_pos, u8f=u8f,
           pidarr=pidarr, pv=pv)
    if dev.type == "cpu":
        return cascade_long_verify_plain(counts, lbase, lsp, e_pos, u8f,
                                         pidarr, pv, n, cap_e, tail_w0, W,
                                         extract)
    Ww = W // 4
    _types(counts=(counts, torch.int64), lbase=(lbase, torch.int64),
           lsp=(lsp, torch.int64), e_pos=(e_pos, torch.int64),
           u8f=(u8f, torch.uint8), pidarr=(pidarr, torch.int64),
           pv=(pv, torch.int32))
    if pv.shape[1] != 2 * Ww + 1:
        raise ValueError(f"pv must be [P, {2 * Ww + 1}]")
    C = counts.shape[0]
    ends = torch.cumsum(counts, 0)
    lib = LIBRARY.load()
    ok = pid = end = None
    if extract:
        ok = torch.empty(cap_e, dtype=torch.bool, device=dev)
        pid = torch.empty(cap_e, dtype=torch.int64, device=dev)
        end = torch.empty(cap_e, dtype=torch.int64, device=dev)
    total = _scalar(dev)
    launch(dev, lib.cascade_long_verify, "cascade_long_verify",
           u8f.data_ptr(), e_pos.data_ptr(), ends.data_ptr(),
           lbase.data_ptr(), lsp.data_ptr(), C, pidarr.data_ptr(),
           pv.data_ptr(), Ww, tail_w0, n, cap_e, int(extract), _ptr(ok),
           _ptr(pid), _ptr(end), total.data_ptr())
    long_launches += 1
    long_shape = (C, cap_e)
    return ok, pid, end, total, ends[-1]


def cascade_long_verify_plain(counts, lbase, lsp, e_pos, u8f, pidarr, pv,
                              n: int, cap_e: int, tail_w0: int, W: int,
                              extract: bool):
    """Plain PyTorch version of S4, any device."""
    total_e, gid, resid, live_e = expand_gid(counts, cap_e)
    pidx = torch.where(live_e, lbase[gid] + resid, 0)
    pid = pidarr[pidx]
    sp_e = lsp[gid]
    # [cap_e, Ww] little-endian words (the numpy '<i4' view of the pv rows)
    wrow = gather_windows(u8f, e_pos[gid], W).view(torch.int32)
    pvrow = pv[pid]                                  # [cap_e, 2Ww+1]
    Ww = wrow.shape[1]
    pw = pvrow[:, tail_w0:Ww]
    pm = pvrow[:, Ww + tail_w0:2 * Ww]
    plen = pvrow[:, 2 * Ww].to(torch.int64)
    eq = ((wrow[:, tail_w0:] & pm) == pw).all(dim=1)
    ok = live_e & eq & (sp_e >= 0) & (sp_e + plen <= n)
    if not extract:
        return None, None, None, ok.sum(), total_e
    return ok, pid, sp_e + plen, ok.sum(), total_e


def expand_gid(counts: torch.Tensor, cap_e: int):
    """Vectorized CSR expansion: group id per output row.

    counts [ng] -> (total, gid[cap_e], resid[cap_e], live[cap_e]); total
    is a 0-d tensor and counts every row, also those past cap_e. Row j <
    total belongs to the group whose [start, end) holds j (zero-count
    groups hold none), found by a binary search of the inclusive cumsum;
    rows past the total get group 0 and are not live."""
    ends = torch.cumsum(counts, 0)
    total = ends[-1]
    starts = ends - counts
    j = torch.arange(cap_e, dtype=ends.dtype, device=ends.device)
    live = j < total
    gid = torch.where(live, torch.searchsorted(ends, j, right=True), 0)
    resid = j - starts[gid]
    return total, gid, resid, live


def _ptr(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.data_ptr()
