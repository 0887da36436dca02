"""Cascade engine: the device path for very large pattern sets (10k-100k+).

The PyTorch port of the JAX package's ``ops/cascade.py``. The host side
(constants, the cuckoo placement, ``ClassTable``, ``CascadeTables``, the
plan ladder and the hostility bounds) is copied unchanged, rng seed and
draw order included, so both packages build the same tables bit for bit.

Pattern sets beyond the fingerprint planner's 64-limb bucket budget
(ops/fingerprint.py) cannot carry one selective filter chain per pattern
bucket: 2048 chain bits cannot discriminate 100k patterns. This engine
splits the discrimination across three device stages:

  1. *Coarse prefix filter.* All patterns' Q-byte prefixes are
     DEDUPLICATED (a 100k-name dictionary typically has only a few
     thousand distinct prefixes) and the deduped prefix set is bucketed by
     the fingerprint planner (``plan_buckets``, exact-length chains) into a
     small limb budget. Q adapts to the dictionary: min(8, shortest
     pattern), floor 4, since longer coarse chains cost the same limb
     budget and filter length-stratified dictionaries far better. Kernel
     G6 (a strong pad byte exists) or G5 (window (0, n)) of
     ``fingerprint_kernels`` emits one bit per haystack position: "some
     deduped prefix chain ends here".
  2. *Exact-membership probes from gathered windows.* Every candidate
     gathers one W-byte window of the (folded) haystack. Per distinct
     pattern length c <= 8 the candidate's c-byte window slice IS the full
     pattern: an exact 64-bit key (two 32-bit words) probes a cuckoo table
     whose slots are (key_lo, key_hi, pid, dup_count) records; a hit IS a
     match. Patterns longer than 8 bytes probe a LONG table keyed by their
     exact first 8 bytes whose records hold CSR (group offset, count) over
     a prefix-sorted pid array.
  3. *Long-group expansion + tail verify.* LONG hits expand to (candidate
     x group member) compare rows, and each row gathers one word-packed
     (pattern words, care masks, length) record and compares the words
     beyond the 8 key bytes. The final compare covers the whole remaining
     pattern, so stage-1 false positives cost time, never correctness.

Unlike the fingerprint engine's device verify, the CSR expansion places no
bound on how many patterns may share a prefix. Patterns longer than
W_CASCADE ride a side exact bit-parallel engine (ops/bitap.py) when their
total size fits its limb budget; the two match sets merge in report order.
The output is the complete overlapping (pattern, end) set in the
reference's report order, the contract of ``BitapEngine.match_pairs``.

After the bitmap, a pass runs the hand-written kernels of
``candidate_kernels`` (the JAX package's stages are ``jnp`` that XLA fuses
with the bitmap kernel into one dispatch): S1 selects the candidates, S3
probes the classes, and S4 expands and verifies the LONG groups over the
``torch.cumsum`` of S3's group sizes. The pass then reads its scalars (the
candidate count, the expansion rows and the match totals) from the card
once, together; in extract mode the selection of the matches follows.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..utils import log
from . import candidate_kernels as _ck
from . import fingerprint_kernels as _kernels
from .bitap import (LANES, BitapEngine, _layout_search, _pow2,
                    _to_stream_major, upload)
from .candidate_kernels import FP_LEN, KEY_LEN, LONG
from .compaction import select_matches
from .fingerprint import (
    FingerprintTables,
    _fold,
    _verify_buffer,
    plan_buckets,
    strong_pad_byte,
)

Q_COARSE = 4            # MINIMUM coarse prefix bytes (min(Q, len) per pattern).
# The engine's actual Q adapts upward to min(8, shortest main pattern):
# length-stratified dictionaries hit far fewer text positions with 8-byte
# prefixes than with 4-byte ones, at the same limb budget.
W_CASCADE = 64          # max pattern length handled on-device
# Coarse plan ladder: limb budgets; escalation refines prefix buckets.
CASCADE_LEVELS = (10, 16, 24, 32)
# Candidate / expansion hostility bounds (fractions of n), the JAX
# package's: past them the per-candidate probe and expansion stages cost
# more than the native host walk, so the engine declares the input hostile
# and the facade falls back.
CAND_SHIFT = 6          # > n/64 candidates: filter-hostile
EXP_SHIFT = 6           # > n/64 expanded compare rows: group-hostile
CAND_FLOOR = 1 << 16
# Below this haystack size the facade's host paths win; the engine still
# functions (tests force it) but starts with small caps.
CAP0 = 1 << 14


def _qlen(c: int, q: int = Q_COARSE) -> int:
    """Coarse prefix length contributed by a pattern of length c."""
    return min(q, c)


def _q_of(main_lens) -> int:
    """The engine's coarse prefix length: as long as every main
    pattern supports (capped at KEY_LEN), never below Q_COARSE."""
    return min(KEY_LEN, max(Q_COARSE, min(main_lens)))


def _build_cuckoo64(lo: np.ndarray, hi: np.ndarray, rng):
    """2-choice cuckoo placement of distinct 64-bit (lo, hi) keys.

    Slot hashes mix both words with per-attempt random multipliers, so
    two distinct keys rarely share both slots; placement is the
    vectorized peeling construction (see fingerprint._build_cuckoo).
    Returns (a1, a2, b1, b2, logT, slot_of_key[i])."""
    n = max(len(lo), 1)
    nk = len(lo)
    logT = max((4 * n - 1).bit_length(), 4)
    lo64 = lo.astype(np.uint64)
    hi64 = hi.astype(np.uint64)
    for _ in range(64):
        T = 1 << logT
        a1 = int(rng.integers(1, 1 << 32)) | 1
        a2 = int(rng.integers(1, 1 << 32)) | 1
        b1 = int(rng.integers(1, 1 << 32)) | 1
        b2 = int(rng.integers(1, 1 << 32)) | 1
        s1 = ((((lo64 * a1) + (hi64 * a2)) & 0xFFFFFFFF)
              >> (32 - logT)).astype(np.int64)
        s2 = ((((lo64 * b1) + (hi64 * b2)) & 0xFFFFFFFF)
              >> (32 - logT)).astype(np.int64)
        slot = np.full(nk, -1, np.int64)
        alive = np.ones(nk, bool)
        self_double = s1 == s2
        while alive.any():
            occ = (np.bincount(s1[alive], minlength=T)
                   + np.bincount(s2[alive], minlength=T))
            one1 = occ[s1] == np.where(self_double, 2, 1)
            one2 = occ[s2] == np.where(self_double, 2, 1)
            pick = alive & (one1 | one2)
            if not pick.any():
                break  # nonempty 2-core: resample hashes
            slot[pick] = np.where(one1[pick], s1[pick], s2[pick])
            alive &= ~pick
        if not alive.any():
            return a1, a2, b1, b2, logT, slot
        logT += 1
    raise ValueError("cuckoo placement failed")


# ---------------------------------------------------------------------------
# Tables
# ---------------------------------------------------------------------------
class ClassTable:
    """Exact-key cuckoo for one pattern-length class.

    Records are int32 [T, 4] rows so a probe is TWO row gathers:
      exact class (c = pattern length <= 8): (lo, hi, rep_pid, dup_count)
      LONG class (length > 8, keyed by first 8 bytes): (lo, hi, group
      offset into the long pid CSR, group count)
    Construction is fully vectorized."""

    def __init__(self, c: int, folded: List[bytes], pids: List[int],
                 rng) -> None:
        self.c = c
        pid_arr = np.asarray(pids, np.int64)
        kb = min(c, KEY_LEN) if c != LONG else KEY_LEN
        pmx = np.frombuffer(
            b"".join(folded[pid][:kb] for pid in pids), np.uint8
        ).reshape(-1, kb).astype(np.uint64)
        lo = np.zeros(len(pids), np.uint64)
        for j in range(min(kb, 4)):
            lo = (lo << np.uint64(8)) | pmx[:, j]
        hi = np.zeros(len(pids), np.uint64)
        for j in range(4, kb):
            hi = (hi << np.uint64(8)) | pmx[:, j]
        key1 = (lo << np.uint64(32)) | hi
        order = np.argsort(key1, kind="stable")
        key_s, pid_s = key1[order], pid_arr[order]
        uniq, starts, counts = np.unique(
            key_s, return_index=True, return_counts=True
        )
        ulo = (uniq >> np.uint64(32)).astype(np.uint32)
        uhi = (uniq & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        a1, a2, b1, b2, logT, slot = _build_cuckoo64(ulo, uhi, rng)
        T = 1 << logT
        self.mults = (np.uint32(a1), np.uint32(a2),
                      np.uint32(b1), np.uint32(b2))
        self.logT = logT
        rec = np.zeros((T, 4), np.int32)
        rec[slot, 0] = ulo.view(np.int32)
        rec[slot, 1] = uhi.view(np.int32)
        if c == LONG:
            rec[slot, 2] = starts.astype(np.int32)   # CSR offset
        else:
            rec[slot, 2] = pid_s[starts].astype(np.int32)  # rep pid
        rec[slot, 3] = counts.astype(np.int32)
        # Guard: an all-zero record row must never equal a real key.
        # (lo, hi) == (0, 0) is the key of the all-zero pattern, which
        # can exist; give empty slots an impossible count instead.
        self.rec = rec
        self.empty_mask = np.ones(T, bool)
        self.empty_mask[slot] = False
        rec[self.empty_mask, 3] = 0      # count 0 => no contribution
        rec[self.empty_mask, 0] = -1     # and a key no window produces
        rec[self.empty_mask, 1] = -1     # for c<8 (high bytes limited)
        self.pidlist = pid_s.astype(np.int32)


class CascadeTables:
    """All build products: coarse filter plan + class tables + verify
    records for the main (<= W_CASCADE) pattern set."""

    def __init__(self, patterns: List[bytes], case_insensitive: bool,
                 k_budget: int, q: int = Q_COARSE):
        self.ci = case_insensitive
        self.q = q
        folded = [_fold(p) if case_insensitive else p for p in patterns]
        self.folded = folded
        P = len(patterns)
        plens = np.array([len(p) for p in patterns], np.int64)
        self.plens = plens
        # Coarse: dedup min(q, len)-byte prefixes (on folded bytes so
        # case pairs dedup together), then plan + mask them with the
        # existing machinery WITH the engine's case flag: the kernel
        # sees raw haystack bytes, so the charmasks must cover both
        # case variants (folding then re-expanding is exact for ASCII).
        # exact_classes: a q-byte prefix must contribute a chain of
        # exactly q bytes (probe geometry anchors at its end position).
        prefixes = sorted({p[:_qlen(len(p), q)] for p in folded})
        self.num_prefixes = len(prefixes)
        self.coarse = FingerprintTables(prefixes, case_insensitive,
                                        k_budget, exact_classes=True)
        # Classes: one exact-key table per distinct length <= KEY_LEN,
        # one LONG table for everything longer (keyed by first 8 bytes).
        rng = np.random.default_rng(0xCA5)
        groups = defaultdict(list)
        for pid, p in enumerate(folded):
            groups[len(p) if len(p) <= KEY_LEN else LONG].append(pid)
        self.classes = {
            c: ClassTable(c, folded, pids, rng)
            for c, pids in groups.items()
        }
        long_t = self.classes.get(LONG)
        self.pidarr = (long_t.pidlist if long_t is not None
                       else np.zeros(1, np.int32))
        # Host map for duplicate patterns in the exact classes: the
        # device emits the representative pid + its dup count; the host
        # expands. (The LONG CSR carries duplicate pids itself.)
        self.dups8: Dict[int, np.ndarray] = {}
        seen: Dict[bytes, List[int]] = defaultdict(list)
        for pid, p in enumerate(folded):
            if len(p) <= KEY_LEN:
                seen[p].append(pid)
        for pidlist in seen.values():
            if len(pidlist) > 1:
                self.dups8[pidlist[0]] = np.asarray(pidlist, np.int64)
        # Verify records (LONG rows only reference them, but they are
        # built over all main pids for direct indexing): word-packed
        # pattern bytes at the window-aligned column, care masks, and
        # length — one [2*Ww+1]-int32 row gather per compare row.
        # LONG patterns anchor at window column FP_LEN - q; the 8-byte
        # key covers columns FP_LEN - q .. FP_LEN - q + 7, so tail
        # verify starts at word tail_w0 (computed below).
        max_long = int(plens.max()) if long_t is not None else 1
        self.W = -(-int(FP_LEN - 1 + max(max_long, KEY_LEN + 1)) // 8) * 8
        self.Ww = self.W // 4
        # LONG patterns anchor where their q-byte coarse prefix starts.
        pcol = FP_LEN - q
        # First tail-verify word: everything before column
        # pcol + KEY_LEN is proven by the 8-byte key (word-rounded DOWN;
        # re-comparing key bytes inside a shared word is harmless
        # because the masks cover them too).
        self.tail_w0 = (pcol + KEY_LEN) // 4
        pmat = np.zeros((P, self.W), np.uint8)
        pmask = np.zeros((P, self.W), np.uint8)
        long_pids = np.flatnonzero(plens > KEY_LEN)
        if len(long_pids):
            lp = plens[long_pids]
            flat = np.frombuffer(
                b"".join(folded[i] for i in long_pids), np.uint8
            )
            rows = np.repeat(long_pids, lp)
            off = np.cumsum(lp) - lp
            within = (np.arange(len(flat), dtype=np.int64)
                      - np.repeat(off, lp))
            pmat[rows, within + pcol] = flat
            pmask[rows, within + pcol] = 0xFF
        self.pv = np.concatenate([
            np.ascontiguousarray(pmat).view("<i4"),
            np.ascontiguousarray(pmask).view("<i4"),
            plens.astype(np.int32)[:, None],
        ], axis=1)
        self._on_device = {}

    def memory_usage(self) -> int:
        total = self.pv.nbytes + self.pidarr.nbytes
        ct = self.coarse
        total += (ct.lo.nbytes + ct.hi.nbytes + ct.start.nbytes
                  + ct.end.nbytes)
        for t in self.classes.values():
            total += t.rec.nbytes
        return total

    def meta_key(self):
        """Static shape identity of the verify stages: (W, q, ((c, logT),
        ...))."""
        return (
            self.W,
            self.q,
            tuple(sorted(
                (c, t.logT) for c, t in self.classes.items()
            )),
        )

    def device_tensors(self, device: torch.device):
        """The tables on ``device``, cached per device: ``coarse`` (lo, hi,
        start, end) int32; per class c, ``classes[c]`` = ((a1, a2, b1, b2),
        logT, records [T, 4] int64 holding the int32 records' bits read as
        unsigned, so keys compare as values in [0, 2^32)); ``pidarr`` int64;
        ``pv`` [P, 2*Ww+1] int32."""
        device = torch.device(device)
        if device not in self._on_device:
            def put(a):
                return torch.from_numpy(np.ascontiguousarray(a)).to(device)
            self._on_device[device] = {
                "coarse": self.coarse.device_tensors(device),
                "classes": {
                    c: (tuple(int(m) for m in t.mults), t.logT,
                        put(t.rec.view(np.uint32).astype(np.int64)))
                    for c, t in self.classes.items()
                },
                "pidarr": put(self.pidarr.astype(np.int64)),
                "pv": put(self.pv),
            }
        return self._on_device[device]


# ---------------------------------------------------------------------------
# The stages after the candidate selection
# ---------------------------------------------------------------------------
def verify_candidates(u8f, e_pos, live, n: int, t: "CascadeTables", dv,
                      cap_e: int, extract: bool):
    """S3, the cumsum and S4 over the candidates (e_pos, live) of the verify
    buffer ``u8f``: (total, total_e, flags). ``total`` (0-d int64) counts
    the matches of the exact classes and the LONG rows, ``total_e`` (0-d
    int64) the LONG expansion rows, also those past cap_e (0 without a LONG
    class); in extract mode ``flags`` = (ok, pid, end), the flat slots of
    the exact classes (ascending), then the first cap_e LONG rows, else
    None."""
    ok, pid, end, total, long = _ck.cascade_probe(
        u8f, e_pos, live, n, dv["classes"], t.q, t.W, extract)
    parts = [] if ok is None else [(ok.reshape(-1), pid.reshape(-1),
                                    end.reshape(-1))]
    total_e = torch.zeros_like(total)
    if long is not None:
        lok, lpid, lend, ltotal, total_e = _ck.cascade_long_verify(
            *long, e_pos, u8f, dv["pidarr"], dv["pv"], n, cap_e, t.tail_w0,
            t.W, extract)
        total = total + ltotal
        if extract:
            parts.append((lok, lpid, lend))
    if not extract:
        return total, total_e, None
    return total, total_e, tuple(torch.cat(col) for col in zip(*parts))


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------
class CascadeHaystack:
    """Device-resident cascade layout: upload once, search many times
    (kernel stream-major layout + the verify byte buffer)."""

    __slots__ = ("n", "L", "tiles", "baked", "halo_a", "body", "u8f",
                 "side")

    def __init__(self, n, L, tiles, baked, halo_a, body, u8f, side):
        self.n = n
        self.L = L
        self.tiles = tiles
        self.baked = baked
        self.halo_a = halo_a
        self.body = body
        self.u8f = u8f
        self.side = side    # side BitapEngine PackedHaystack, or None


class CascadeEngine:
    """Facade-facing engine: complete overlapping match sets for pattern
    sets of (nearly) arbitrary size. Scans run on ``device``."""

    def __init__(self, patterns: List[bytes], case_insensitive: bool,
                 device="cuda"):
        self.patterns = patterns
        self.ci = case_insensitive
        self.device = torch.device(device)
        P = len(patterns)
        plens = np.array([len(p) for p in patterns], np.int64)
        # Report-order rank over the FULL pattern set (length desc then
        # pid asc at equal end; noncontiguous.rs:1357 analog).
        order = np.lexsort((np.arange(P), -plens))
        self.pid_rank = np.empty(P, np.int64)
        self.pid_rank[order] = np.arange(P)
        self.max_pattern_len = int(plens.max())
        # Long patterns ride a side exact bit-parallel engine.
        self.long_pids = np.flatnonzero(plens > W_CASCADE)
        self.main_pids = np.flatnonzero(plens <= W_CASCADE)
        self._main_pats = [patterns[i] for i in self.main_pids]
        self.side = None
        if len(self.long_pids):
            self.side = BitapEngine(
                [patterns[i] for i in self.long_pids], case_insensitive,
                self.device,
            )
        self.pad_byte = strong_pad_byte(patterns, case_insensitive)
        self.q = _q_of([len(p) for p in self._main_pats])
        self._tables_cache: Dict[int, Optional[CascadeTables]] = {}
        self._dups_of = None  # the tables whose dups8 CSR _dups holds
        self.level: Optional[int] = None
        for i in range(len(CASCADE_LEVELS)):
            if self._tables(i) is not None:
                self.level = i
                break
        assert self.level is not None, "caller must check eligibility"
        self.tables = self._tables(self.level)
        self.halo = max(_pow2(FP_LEN - 1), 4)
        self.hostile = False
        self._caps: Dict[str, int] = {}
        self.last_caps: Optional[Tuple[int, int, Optional[int]]] = None
        log.debug(
            "cascade engine: %d patterns (%d long-side), %d deduped "
            "q=%d prefixes, K=%d, W=%d, classes=%s",
            P, len(self.long_pids), self.tables.num_prefixes, self.q,
            self.tables.coarse.k, self.tables.W,
            sorted(self.tables.classes),
        )

    @classmethod
    def eligible(cls, patterns: List[bytes],
                 case_insensitive: bool = False) -> bool:
        if not patterns or any(len(p) == 0 for p in patterns):
            return False
        main = [p for p in patterns if len(p) <= W_CASCADE]
        longs = [p for p in patterns if len(p) > W_CASCADE]
        if not main:
            return False
        if longs and not BitapEngine.eligible(longs):
            return False
        folded = [_fold(p) if case_insensitive else p for p in main]
        q = _q_of([len(p) for p in main])
        prefixes = sorted({p[:_qlen(len(p), q)] for p in folded})
        return plan_buckets(prefixes, case_insensitive,
                            CASCADE_LEVELS[-1],
                            exact_classes=True) is not None

    def _tables(self, lvl: int) -> Optional[CascadeTables]:
        if lvl not in self._tables_cache:
            folded = [_fold(p) if self.ci else p for p in self._main_pats]
            prefixes = sorted({p[:_qlen(len(p), self.q)] for p in folded})
            if plan_buckets(prefixes, self.ci, CASCADE_LEVELS[lvl],
                            exact_classes=True) is None:
                self._tables_cache[lvl] = None
            else:
                self._tables_cache[lvl] = CascadeTables(
                    self._main_pats, self.ci, CASCADE_LEVELS[lvl],
                    self.q,
                )
        return self._tables_cache[lvl]

    def _escalate(self) -> bool:
        for nxt in range(self.level + 1, len(CASCADE_LEVELS)):
            t = self._tables(nxt)
            if t is not None and t.coarse.k > self.tables.coarse.k:
                self.level = nxt
                self.tables = t
                return True
        return False

    # ------------------------------------------------------------------
    def _layout(self, n: int) -> Tuple[int, int]:
        """(L, tiles) of the kernels' stream-major layout."""
        return _layout_search(n, self.halo)

    def memory_usage(self) -> int:
        return self.tables.memory_usage()

    @log.spanned("prepare")
    def prepare(self, hs: bytes) -> CascadeHaystack:
        """Upload a haystack into the device-resident cascade layout.

        The coarse pass runs G6 whenever a strong pad byte exists, at any
        n (the fingerprint engine adds a size floor; the cascade does
        not), else G5 masked to (0, n)."""
        n = len(hs)
        L, tiles = self._layout(max(n, 1))
        total = tiles * LANES * L
        pad = self.pad_byte or 0
        with log.span("prepare.pack"):
            buf = np.full(total, pad, np.uint8) if pad else np.zeros(
                total, np.uint8
            )
            buf[:n] = np.frombuffer(hs, np.uint8)
        x32 = upload(buf.view(np.int32), self.device)
        halo_a, body = _to_stream_major(x32, L, tiles, self.halo)
        u8f = _verify_buffer(x32, self.tables.W, self.ci)
        baked = self.pad_byte is not None
        side_ph = self.side.prepare(hs) if self.side is not None else None
        return CascadeHaystack(n, L, tiles, baked, halo_a, body, u8f,
                               side_ph)

    def _limits(self, n: int) -> Tuple[int, int]:
        lim = max(CAND_FLOOR, n >> CAND_SHIFT)
        return lim, max(CAND_FLOOR, n >> EXP_SHIFT)

    def _bitmap(self, ph: CascadeHaystack, coarse):
        lo, hi, sm, em = coarse
        if ph.baked:
            return _kernels.fp_bitmap_baked(lo, hi, sm, em, ph.halo_a,
                                            ph.body)
        return _kernels.fp_bitmap_generic(lo, hi, sm, em, ph.halo_a,
                                          ph.body, 0, ph.n)

    def _run(self, ph: CascadeHaystack, extract: bool):
        """Adaptive pipeline on the main pattern set. Returns the count or
        (pids, ends) ndarray pair, or None when hostile."""
        n, L = ph.n, ph.L
        cand_lim, exp_lim = self._limits(n)
        # Caps persist per engine instance (grown monotonically): after
        # the first scan settles them, repeated searches on similar
        # inputs run exactly one pass — no cap-overflow rescans.
        cap_c = max(self._caps.get("c", 0),
                    min(_pow2(max(n // 4, 1024)), CAP0))
        cap_e = max(self._caps.get("e", 0), cap_c)
        cap_m = max(self._caps.get("m", 0), max(cap_c // 2, 1024))
        while True:
            t = self.tables
            dv = t.device_tensors(self.device)
            # One pass: the bitmap, S1, S3, the cumsum and S4, then one
            # read of the scalars.
            log.count("passes")
            _, bmp = self._bitmap(ph, dv["coarse"])
            ncand, e_pos, live = _ck.cand_select(bmp, L, cap_c)
            total, total_e, flags = verify_candidates(
                ph.u8f, e_pos, live, n, t, dv, cap_e, extract)
            with log.read():
                ncand, total, ne = torch.stack(
                    [ncand, total, total_e]).tolist()
            if ((ncand > cand_lim or ne > exp_lim)
                    and self._escalate()):
                continue
            if ncand > cand_lim or ne > exp_lim:
                self.hostile = True
                return None
            settled = True
            if ncand > cap_c:
                cap_c = _pow2(ncand)
                settled = False
            if ne > cap_e:
                cap_e = _pow2(ne)
                settled = False
            if extract and total > cap_m:
                cap_m = _pow2(total)
                settled = False
            if settled:
                break
        self._caps["c"] = max(self._caps.get("c", 0), cap_c)
        self._caps["e"] = max(self._caps.get("e", 0), cap_e)
        if extract:
            self._caps["m"] = max(self._caps.get("m", 0), cap_m)
        self.last_caps = (cap_c, cap_e, cap_m if extract else None)
        if not extract:
            return total
        return self._host_pairs(*select_matches(*flags, cap_m))

    @log.spanned("pass.order")
    def _host_pairs(self, out_pid: torch.Tensor, out_end: torch.Tensor):
        """The device's selected (pid, end) slots as full pattern-set
        (pids, ends) host arrays: -1 slots dropped, duplicate exact-class
        patterns expanded (the device emitted the representative pid once
        per match site), main-set pids mapped back. Not yet in report
        order."""
        with log.read(2):
            pid = out_pid.cpu().numpy()
            end = out_end.cpu().numpy()
        real = pid >= 0
        pid, end = pid[real], end[real]
        ndup, start, members = self._dup_csr()
        cnt = ndup[pid]
        at = np.flatnonzero(cnt)
        if len(at):
            c = cnt[at]
            # Extra row k of match at[i] is member k - excl[i] of its group.
            first = np.repeat(start[pid[at]] - (np.cumsum(c) - c), c)
            pid = np.concatenate([pid, members[first + np.arange(c.sum())]])
            end = np.concatenate([end, np.repeat(end[at], c)])
        return self.main_pids[pid], end

    def _dup_csr(self):
        """The tables' duplicate groups as a CSR over main pids: (extra
        members per pid, start of its extras, the extras), built once per
        tables object."""
        t = self.tables
        if self._dups_of is not t:
            ndup = np.zeros(len(self.main_pids), np.int64)
            start = np.zeros(len(self.main_pids), np.int64)
            reps = np.fromiter(t.dups8.keys(), np.int64, len(t.dups8))
            extras = [g[1:] for g in t.dups8.values()]
            sizes = np.array([len(e) for e in extras], np.int64)
            ndup[reps] = sizes
            start[reps] = np.cumsum(sizes) - sizes
            members = (np.concatenate(extras) if extras
                       else np.zeros(0, np.int64))
            self._dups_of, self._dups = t, (ndup, start, members)
        return self._dups

    # ------------------------------------------------------------------
    @log.spanned("pass")
    def count_matches(self, hs) -> Optional[int]:
        ph = hs if isinstance(hs, CascadeHaystack) else None
        if ph is None:
            if len(hs) == 0:
                return 0
            ph = self.prepare(hs)
        if ph.n == 0:
            return 0
        got = self._run(ph, extract=False)
        if got is None:
            return None
        if self.side is not None:
            got += self.side.count_matches(ph.side)
        return got

    @log.spanned("pass")
    def match_pairs(
        self, hs
    ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """All overlapping matches as (pids, 1-based ends) in the
        reference's overlapping report order, or None (hostile)."""
        ph = hs if isinstance(hs, CascadeHaystack) else None
        if ph is None:
            if len(hs) == 0:
                z = np.zeros(0, np.int64)
                return z, z
            ph = self.prepare(hs)
        if ph.n == 0:
            z = np.zeros(0, np.int64)
            return z, z
        got = self._run(ph, extract=True)
        if got is None:
            return None
        pids, ends = got
        if self.side is not None:
            spids, sends = self.side.match_pairs(ph.side)
            pids = np.concatenate([pids, self.long_pids[spids]])
            ends = np.concatenate([ends, sends])
        with log.span("pass.order"):
            order = np.lexsort((self.pid_rank[pids], ends))
            return pids[order], ends[order]
