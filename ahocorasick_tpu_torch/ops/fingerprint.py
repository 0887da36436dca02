"""Bucketed fingerprint filter — the engine for large pattern sets, and the
first extraction route of the small ones.

The PyTorch port of the JAX package's ``ops/fingerprint.py``. The host side
(bucket planning, tables, the cuckoo verify tables, the host verify index,
the plan ladder and every threshold) is copied unchanged, rng seed and draw
order included, so both packages build the same tables.

  1. *Filter.* Patterns are grouped into buckets of a few patterns each;
     a bucket contributes ONE chain of length ``m = min(len, 8)`` whose
     per-position charmask is the OR of its members' byte (nybble) masks.
     All bucket chains bin-pack into K <= 64 limbs.
  2. *Candidate bitmap.* Kernel G5 (table-generic, position-masked) or G6
     (strong-pad-byte padded, unmasked), ``fingerprint_kernels``, emits one
     bit per haystack position ("some bucket's fingerprint ends here"),
     n/8 bytes of output regardless of K. Kernel S1
     (``candidate_kernels.cand_select``) turns the first ``cap`` set bits
     into positions.
  3. *Exact verification.* On the device (``DeviceVerify``, kernel S2
     ``candidate_kernels.fp_verify``): each candidate reads a W-byte window
     of the folded haystack (the verify buffer), per length class its
     fingerprint bytes hash into a cuckoo table whose slot holds the whole
     pattern group as one packed row, one row gather fetches it, and
     full-pattern byte compares confirm. Hash collisions and filter false positives cost
     time, never correctness. Small inputs and oversized patterns verify on
     the host instead (``VerifyIndex``, numpy).

Plans adapt at run time: the engine starts at the cheapest filter level
(``PLAN_LEVELS``) and escalates to finer buckets only when the measured
candidate rate demands it; candidate-dense (hostile) inputs return None and
the facade falls back to the native walk.

The output is the complete overlapping (pattern, end) match set in the
reference's report order, the contract of ``BitapEngine.match_pairs``.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..utils import log
from . import candidate_kernels as _ck
from . import fingerprint_kernels as _kernels
from .bitap import (
    LANES,
    _layout_search,
    _pow2,
    _to_stream_major,
    pack_chains,
    tables_on,
    upload,
)
from .candidate_kernels import FP_LEN
from .compaction import select_matches

FP_BAKED_MIN = 1 << 20  # bake tables into the kernel above this size
# Below this haystack size candidates verify on the host (numpy): the
# device-verify pipeline's jit is specialized per verify-table shape,
# which only pays off on large scans.
FP_DV_MIN = 1 << 18
K_TARGET = 16       # preferred limb budget (kernel cost is ~linear in K)
K_MAX = 64          # absolute limb bound (beyond: host-walk fallback)
# Candidate positions above max(CAND_FLOOR, n >> CAND_SHIFT) mark the
# workload filter-hostile: verification would dominate, so the facade
# falls back to the native walk for subsequent calls.
CAND_FLOOR = 1 << 16
CAND_SHIFT = 3


def _fold(p: bytes) -> bytes:
    return bytes(b | 0x20 if 0x41 <= b <= 0x5A else b for b in p)


def _fold_arr(a: np.ndarray) -> np.ndarray:
    return np.where((a >= 65) & (a <= 90), a | 32, a).astype(np.uint8)


def _mclass(n: int) -> int:
    """Fingerprint length class of a pattern of length n.

    Classes are {1, 2, 3, 4, 8}: patterns of length 4..7 share the
    4-byte class so verification probes at most two hash tables per
    candidate (per-class probes dominate the verify cost); length >= 8
    keeps the full 8-byte fingerprint for selectivity."""
    return n if n <= 4 else (4 if n < FP_LEN else FP_LEN)



# ---------------------------------------------------------------------------
# Tables
# ---------------------------------------------------------------------------
def strong_pad_byte(patterns: List[bytes],
                    case_insensitive: bool) -> Optional[int]:
    """A byte whose lo OR hi nybble no pattern byte uses: its charmask
    is zero under ANY bucketing, so one packed haystack (padded with
    it) serves every plan level."""
    vals = np.frombuffer(b"".join(patterns), np.uint8)
    if case_insensitive:
        alpha = (vals | 0x20)
        vals = np.concatenate([
            vals,
            np.where((alpha >= 0x61) & (alpha <= 0x7A),
                     vals ^ 0x20, vals),
        ])
    los = np.zeros(16, bool)
    his = np.zeros(16, bool)
    los[np.unique(vals & 15)] = True
    his[np.unique(vals >> 4)] = True
    for b in range(256):
        if not los[b & 15] or not his[b >> 4]:
            return b
    return None


class FingerprintTables:
    """Bucketed chain masks in the bitap kernel's (lo, hi, start, end)
    table format, plus the bucket plan used to pick K."""

    def __init__(self, patterns: List[bytes], case_insensitive: bool,
                 k_budget: int = K_MAX, exact_classes: bool = False):
        assert patterns and all(len(p) > 0 for p in patterns)
        self.case_insensitive = case_insensitive
        plan = plan_buckets(patterns, case_insensitive, k_budget,
                            exact_classes)
        assert plan is not None, "caller must check eligibility"
        buckets, offsets, K = plan
        self.num_buckets = len(buckets)
        self.k = K
        self.max_chain = max(m for m, _ in buckets)
        lo = np.zeros((K, 16), np.uint32)
        hi = np.zeros((K, 16), np.uint32)
        start = np.zeros(K, np.uint32)
        end = np.zeros(K, np.uint32)
        for (m, pids), o in zip(buckets, offsets):
            start[o // 32] |= np.uint32(1 << (o % 32))
            e = o + m - 1
            end[e // 32] |= np.uint32(1 << (e % 32))
            for pid in pids:
                p = patterns[pid]
                for j in range(m):
                    ch = p[j]
                    g = o + j
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
        self.pad_byte: Optional[int] = None
        for b in range(256):
            if not (lo[:, b & 15] & hi[:, b >> 4]).any():
                self.pad_byte = b
                break
        self._on_device = {}

    def baked_key(self):
        return (
            tuple(map(tuple, self.lo.tolist())),
            tuple(map(tuple, self.hi.tolist())),
            tuple(self.start.tolist()),
            tuple(self.end.tolist()),
        )

    def device_tensors(self, device: torch.device):
        """(lo, hi, start, end) as int32 tensors on ``device``, cached per
        device."""
        return tables_on(self._on_device, device,
                         (self.lo, self.hi, self.start, self.end))


# Selectivity model for bucket planning: the probability that a text
# byte passes a chain position's nybble-product mask is estimated as
# |product set ∩ text alphabet| / |text alphabet|, with the text
# alphabet modeled as the bytes the patterns themselves use (plus
# space) — dictionaries are searched in text drawn from the same
# alphabet. The planner keeps the estimated per-position candidate
# probability under CAND_BUDGET.
CAND_BUDGET = 0.003
# A plan whose FINEST affordable bucketing still passes more than this
# fraction of modeled positions is declared structurally filter-hostile
# (None): every candidate costs gather+probe work downstream, so a
# saturated filter would run BELOW the plain host walk. This is the
# measured boundary for the reference's full 123k-word English
# dictionary (18,038 distinct coarse prefixes, 1.31 true matches per
# byte on opensubtitles en-sampled — 74% of them from its 52
# single-character words), where no 2048-bit mask budget discriminates.
SATURATION = 0.5


def _model_alphabet(folded) -> np.ndarray:
    seen = {0x20}
    for p in folded:
        seen.update(p)
    return np.array(sorted(seen), np.uint8)


def _class_prob(folded, pids_sorted, m, b, case_insensitive,
                alphabet) -> float:
    """Estimated per-position candidate probability contributed by class
    m when sliced into buckets of ~b members (sorted order)."""
    nb = -(-len(pids_sorted) // b)
    total = 0.0
    alo = alphabet & 15
    ahi = alphabet >> 4
    asize = max(len(alphabet), 1)
    for chunk in np.array_split(np.asarray(pids_sorted, np.int64), nb):
        prob = 1.0
        for j in range(m):
            los, his = set(), set()
            for pid in chunk:
                ch = folded[pid][j]
                vs = {ch}
                if case_insensitive and 0x61 <= (ch | 0x20) <= 0x7A:
                    vs = {ch | 0x20, ch & ~0x20}
                for v in vs:
                    los.add(v & 15)
                    his.add(v >> 4)
            hits = int(np.sum(
                np.isin(alo, list(los)) & np.isin(ahi, list(his))
            ))
            prob *= min(1.0, max(hits, 1) / asize)
        total += prob
    return total


def plan_buckets(patterns: List[bytes], case_insensitive: bool,
                 k_budget: int = K_MAX, exact_classes: bool = False):
    """Group patterns into fingerprint buckets and pack their chains.

    Returns (buckets, offsets, K) with buckets = [(chain_len, [pid])],
    or None when every bucketing that fits the k_budget limb budget is
    modeled filter-saturated (SATURATION) — fit itself is always
    reachable by coarsening, so None now means "structurally hostile",
    not "too many patterns". Patterns
    are grouped by chain length class m (see _mclass) and sorted
    (folded) so bucket members share prefixes; per-class bucket sizes
    start coarse (cheapest kernel) and halve greedily — worst
    estimated-selectivity class first — until the modeled candidate
    probability fits CAND_BUDGET or the limb budget is exhausted.
    This is the planning analog of Teddy's bucket-quality heuristics
    (teddy/builder.rs:113-177, generic.rs:770-808) driven by an explicit
    false-positive model instead of fixed bucket counts. The engine
    holds a LADDER of plans (PLAN_LEVELS) and escalates to a finer,
    costlier filter only when the measured candidate rate on real input
    demands it."""
    folded = [_fold(p) if case_insensitive else p for p in patterns]
    classes = {}
    grouped = defaultdict(list)
    # exact_classes: chain length = full pattern length (the cascade's
    # coarse prefixes NEED end-position alignment at exactly len(p)-1;
    # _mclass would truncate a 6-byte prefix chain to 4 bytes and break
    # the probe geometry). The fingerprint engine keeps _mclass so its
    # verify probes stay at <= 2 tables per candidate.
    for pid, p in enumerate(folded):
        m = len(p) if exact_classes else _mclass(len(p))
        grouped[m].append(pid)
    for m, pids in grouped.items():
        classes[m] = sorted(pids, key=lambda i: folded[i][:m])

    bsize = {m: 64 for m in classes}

    def k_of(bs):
        lens = []
        for m, pids in classes.items():
            nb = -(-len(pids) // bs[m])
            lens += [m] * nb
        return pack_chains(lens, decollide=False)[1]

    # Coarsen until the limb budget fits: prefix-diverse sets (the
    # reference's real dictionaries run to 18k+ distinct 4-byte
    # prefixes) start over budget at bucket size 64, so the planner
    # doubles the heaviest class's bucket size until the chains pack —
    # the exact probes downstream absorb the extra false positives, and
    # the SATURATION test below rejects plans too coarse to be filters.
    while k_of(bsize) > k_budget:
        cands = [m for m in classes if bsize[m] < len(classes[m])]
        if not cands:
            return None
        m = max(
            cands, key=lambda m: -(-len(classes[m]) // bsize[m]) * m
        )
        bsize[m] *= 2
    alphabet = _model_alphabet(folded)
    probs = {
        m: _class_prob(folded, classes[m], m, bsize[m], case_insensitive,
                       alphabet)
        for m in classes
    }
    while sum(probs.values()) > CAND_BUDGET:
        # Halve the worst offender that still fits the limb budget.
        for m in sorted(probs, key=lambda m: -probs[m]):
            if bsize[m] == 1:
                continue
            trial = dict(bsize)
            trial[m] = bsize[m] // 2
            if k_of(trial) <= k_budget:
                bsize = trial
                probs[m] = _class_prob(
                    folded, classes[m], m, bsize[m], case_insensitive,
                    alphabet
                )
                break
        else:
            break  # budget exhausted: best effort, hostile guard covers
    if sum(probs.values()) > SATURATION:
        return None  # structurally filter-hostile (see SATURATION)
    buckets = []
    for m in sorted(classes):
        pids = classes[m]
        nb = -(-len(pids) // bsize[m])
        for chunk in np.array_split(np.asarray(pids, np.int64), nb):
            buckets.append((m, chunk.tolist()))
    offsets, K = pack_chains([m for m, _ in buckets], decollide=False)
    return buckets, offsets, K



# ---------------------------------------------------------------------------
# Candidate positions
# ---------------------------------------------------------------------------
def _rank_select(bmp: torch.Tensor, L: int, cap: int):
    """(total set bits as an int, e_pos [cap], live [cap]): S1
    (``candidate_kernels.cand_select``) with its count read, the sharded
    searches' candidate selection."""
    ncand, e_pos, live = _ck.cand_select(bmp, L, cap)
    with log.read():
        ncand = int(ncand)
    return ncand, e_pos, live


# ---------------------------------------------------------------------------
# Device-side exact verification
# ---------------------------------------------------------------------------
W_MAX = 64      # device-verify window bytes (max pattern length it covers)
GMAX_CAP = 16   # max patterns sharing one fingerprint before host fallback


def _build_cuckoo(keys: List[int], rng) -> Tuple[int, int, int, np.ndarray]:
    """2-choice cuckoo placement of distinct uint32 keys.

    Returns (mult_a, mult_b, logT, slot_of_key[i]) — lookup probes the
    two slots ((h * mult) >> (32 - logT)) and compares stored keys, so a
    membership test is two element gathers instead of a binary search.

    Placement is the vectorized peeling construction (the cuckoo graph
    at load 1/4 has an empty 2-core whp): repeatedly assign every key
    one of whose two slots is wanted by no other unassigned key, in
    O(rounds) bincount passes — 100k keys place in milliseconds where
    the sequential random-walk insertion took seconds."""
    n = max(len(keys), 1)
    nk = len(keys)
    logT = max((4 * n - 1).bit_length(), 4)
    karr = np.array(keys, np.uint64)
    for _ in range(64):
        T = 1 << logT
        a = int(rng.integers(1, 1 << 32)) | 1
        b = int(rng.integers(1, 1 << 32)) | 1
        s1 = (((karr * a) & 0xFFFFFFFF) >> (32 - logT)).astype(np.int64)
        s2 = (((karr * b) & 0xFFFFFFFF) >> (32 - logT)).astype(np.int64)
        slot = np.full(nk, -1, np.int64)
        alive = np.ones(nk, bool)
        self_double = s1 == s2  # one effective choice, counted twice
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
            return a, b, logT, slot
        logT += 1
    raise ValueError("cuckoo placement failed")


class DeviceVerify:
    """Device-resident candidate->match resolution tables.

    Each candidate position extracts a W-byte window anchored at its
    fingerprint start; per length class the fingerprint bytes hash
    (32-bit polynomial, collision-free over the stored keys by
    build-time retry) into a cuckoo table whose entry lists the patterns
    sharing that fingerprint; each listed pattern is byte-compared
    against the window. The final compare covers the WHOLE pattern, so
    even a stray hash collision can only cost time, never correctness.
    This replaces the host verify loop with O(#candidates) tensor work,
    the analog of Teddy's verify64 (teddy/generic.rs:820-870). The
    tables, rng draws included, are the JAX package's.
    """

    @staticmethod
    def supports(patterns: List[bytes]) -> bool:
        return max(len(p) for p in patterns) <= W_MAX

    def __init__(self, patterns: List[bytes], case_insensitive: bool):
        assert self.supports(patterns)
        folded = [_fold(p) if case_insensitive else p for p in patterns]
        # A class-c pattern occupies window columns [FP_LEN - c,
        # FP_LEN - c + len): a length-6 pattern in class 4 reaches col 9,
        # so the window must cover FP_LEN - c + len, NOT just len —
        # max(FP_LEN, max_len) silently truncated the tail compare of
        # length 5-7 patterns whenever no longer pattern stretched the
        # window (caught on the reference's own name-alt1 set, where
        # "Street" matched "Streatham": cols 8-9 were never compared).
        self.W = max(
            FP_LEN,
            max(FP_LEN - _mclass(len(p)) + len(p) for p in patterns),
        )
        W = self.W
        plens = np.array([len(p) for p in patterns], np.int64)
        self.plens = plens
        m_arr = np.array([_mclass(int(x)) for x in plens], np.int64)
        # Per length class: hashed cuckoo table of class-c prefixes.
        # Each slot stores its whole pattern GROUP as one concatenated
        # row (gmax patterns x W bytes + masks + lens + pids), so
        # resolving a candidate costs ONE row gather per class
        # regardless of group size.
        groups = defaultdict(list)
        for pid, p in enumerate(folded):
            groups[int(m_arr[pid])].append(pid)
        self.classes = {}
        rng = np.random.default_rng(0xAC)
        for c, pids in groups.items():
            keymap = defaultdict(list)
            for pid in pids:
                keymap[folded[pid][:c]].append(pid)
            keys = sorted(keymap)
            gmax = max(len(v) for v in keymap.values())
            if gmax > GMAX_CAP:
                raise ValueError("fingerprint group too large")
            for _ in range(64):
                mult = np.uint32(int(rng.integers(1, 1 << 32)) | 1)
                hs = np.zeros(len(keys), np.uint32)
                for j in range(c):
                    hs = hs * mult + np.array(
                        [k[j] for k in keys], np.uint32
                    )
                if len(np.unique(hs)) == len(keys):
                    break
            else:
                raise ValueError("no collision-free hash multiplier")
            a, b, logT, slot = _build_cuckoo(hs.tolist(), rng)
            T = 1 << logT
            tkeys = np.zeros(T, np.uint32)  # 0 never matches: see below
            # Packed group row: [gmax*W pattern bytes][gmax*4 pid LE]
            # [gmax*4 len LE]; dontcare masks derive from the lens on
            # device. ONE row gather resolves a candidate's whole group.
            grow = np.zeros((T, gmax * (W + 8)), np.uint8)
            gpid = np.full((T, gmax), -1, np.int32)
            glen = np.zeros((T, gmax), np.int32)
            off = FP_LEN - c  # pattern start offset within the window
            for i, key in enumerate(keys):
                si = slot[i]
                tkeys[si] = hs[i]
                for s, pid in enumerate(keymap[key]):
                    p = folded[pid]
                    gpid[si, s] = pid
                    glen[si, s] = len(p)
                    grow[si, s * W + off:s * W + off + len(p)] = (
                        np.frombuffer(p, np.uint8)
                    )
            grow[:, gmax * W:gmax * (W + 4)] = (
                gpid.astype("<i4").view(np.uint8).reshape(T, -1)
            )
            grow[:, gmax * (W + 4):] = (
                glen.astype("<i4").view(np.uint8).reshape(T, -1)
            )
            # Empty slots hold key 0; a real key hashing to 0 would
            # false-positive into pid -1, which the pid>=0 mask drops.
            self.classes[c] = (mult, np.uint32(a), np.uint32(b), logT,
                               tkeys, gmax, grow)
        self._dev = None

    def device_tables(self, device: torch.device):
        """Per class c: (mult, a, b, logT, tkeys [T] int64, gmax,
        grow [T, gmax*(W+8)] uint8 on ``device``), cached per device."""
        if self._dev is None or self._dev[0] != device:
            tabs = {
                c: (int(m), int(a), int(b), logT,
                    torch.from_numpy(tk.astype(np.int64)).to(device), gmax,
                    torch.from_numpy(gr).to(device))
                for c, (m, a, b, logT, tk, gmax, gr) in self.classes.items()
            }
            self._dev = (device, tabs)
        return self._dev[1]

    def key(self):
        """Shape identity of the verify tables: (W, ((c, logT, gmax), ...))."""
        return (
            self.W,
            tuple(sorted(
                (c, logT, gmax)
                for c, (m, a, b, logT, tk, gmax, gr)
                in self.classes.items()
            )),
        )


class VerifyIndex:
    """Candidate-position -> exact match-set resolution tables.

    Per chain-length class c: sorted uint64 keys of every pattern's
    folded c-byte prefix with a CSR key->pids map; per pattern length
    > FP_LEN: a tail matrix for the vectorized suffix compare."""

    def __init__(self, patterns: List[bytes], case_insensitive: bool):
        self.ci = case_insensitive
        P = len(patterns)
        self.plens = np.array([len(p) for p in patterns], np.int64)
        folded = [
            _fold(p) if case_insensitive else p for p in patterns
        ]
        order = np.lexsort((np.arange(P), -self.plens))
        self.pid_rank = np.empty(P, np.int64)
        self.pid_rank[order] = np.arange(P)
        groups = defaultdict(list)
        for pid, p in enumerate(folded):
            groups[_mclass(len(p))].append(pid)
        self.classes = {}
        for c, pids in groups.items():
            keys = np.array(
                [int.from_bytes(folded[pid][:c], "big") for pid in pids],
                np.uint64,
            )
            o = np.argsort(keys, kind="stable")
            keys_s, pids_s = keys[o], np.array(pids, np.int64)[o]
            uniq, starts = np.unique(keys_s, return_index=True)
            csr_off = np.append(starts, len(keys_s)).astype(np.int64)
            self.classes[c] = (uniq, csr_off, pids_s)
        # Tail matrices for patterns longer than their class prefix,
        # grouped by (class, length); tail bytes start at offset c.
        self.tails = {}
        self.tail_row = np.full(P, -1, np.int64)
        bylen = defaultdict(list)
        for pid, p in enumerate(folded):
            c = _mclass(len(p))
            if len(p) > c:
                bylen[(c, len(p))].append(pid)
        for (c, ln), pids in bylen.items():
            mat = np.stack([
                np.frombuffer(folded[pid], np.uint8)[c:]
                for pid in pids
            ])
            self.tails[(c, ln)] = mat
            self.tail_row[pids] = np.arange(len(pids))

    @log.spanned("pass.verify")
    def verify(
        self, a: np.ndarray, cand: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(pids, ends) of all true matches whose fingerprint ends at a
        candidate position. `a` is the (folded) haystack bytes."""
        n = len(a)
        out_p, out_e = [], []
        for c, (keys, csr_off, csr_pid) in self.classes.items():
            s = cand - (c - 1)
            ss = s[s >= 0]
            if not len(ss):
                continue
            w = a[ss[:, None] + np.arange(c)]
            key = np.zeros(len(ss), np.uint64)
            for j in range(c):
                key = (key << np.uint64(8)) | w[:, j].astype(np.uint64)
            pos = np.searchsorted(keys, key)
            pos_c = np.minimum(pos, max(len(keys) - 1, 0))
            found = keys[pos_c] == key if len(keys) else np.zeros(
                len(key), bool
            )
            gi, sf = pos_c[found], ss[found]
            if not len(gi):
                continue
            cnts = csr_off[gi + 1] - csr_off[gi]
            tot = int(cnts.sum())
            rep = np.repeat(np.arange(len(gi)), cnts)
            base = np.repeat(np.cumsum(cnts) - cnts, cnts)
            within = np.arange(tot) - base
            pid = csr_pid[csr_off[gi][rep] + within]
            st = sf[rep]
            plens = self.plens[pid]
            exact = plens == c
            out_p.append(pid[exact])
            out_e.append(st[exact] + c)
            pid_r, st_r, pl_r = pid[~exact], st[~exact], plens[~exact]
            for ln in np.unique(pl_r):
                ln = int(ln)
                m = pl_r == ln
                pids2, st2 = pid_r[m], st_r[m]
                okb = st2 + ln <= n
                pids2, st2 = pids2[okb], st2[okb]
                if not len(pids2):
                    continue
                mat = self.tails[(c, ln)]
                wt = a[st2[:, None] + np.arange(c, ln)]
                eq = (wt == mat[self.tail_row[pids2]]).all(axis=1)
                out_p.append(pids2[eq])
                out_e.append(st2[eq] + ln)
        if not out_p:
            z = np.zeros(0, np.int64)
            return z, z
        pids = np.concatenate(out_p)
        ends = np.concatenate(out_e)
        order = np.lexsort((self.pid_rank[pids], ends))
        return pids[order], ends[order]



# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------
@log.spanned("prepare.layout")
def _verify_buffer(x32: torch.Tensor, W: int, fold: bool) -> torch.Tensor:
    """The verify byte buffer: FP_LEN zero bytes, the packed haystack's
    bytes (padding included; ASCII-folded when ``fold``), W zero guard
    bytes. The W-byte window of a candidate ending at position e starts
    at buffer index e + 1 (its fingerprint start, e - (FP_LEN - 1))."""
    b = x32.view(torch.uint8)
    if fold:
        b = torch.where((b >= 65) & (b <= 90), b | 32, b)
    lead = torch.zeros(FP_LEN, dtype=torch.uint8, device=b.device)
    guard = torch.zeros(W, dtype=torch.uint8, device=b.device)
    return torch.cat([lead, b, guard])


class FpHaystack:
    """Device-resident fingerprint-engine layout: upload once, search
    many times (kernel stream-major layout + the verify byte buffer)."""

    __slots__ = ("n", "L", "Lc", "tiles", "baked", "halo_a", "body",
                 "u8f", "hs")

    def __init__(self, n, L, Lc, tiles, baked, halo_a, body, u8f, hs):
        self.n = n
        self.L = L
        self.Lc = Lc
        self.tiles = tiles
        self.baked = baked
        self.halo_a = halo_a
        self.body = body
        self.u8f = u8f
        self.hs = hs


# Filter plan ladder: per-level limb budgets. The engine starts at the
# cheapest level and escalates only when the measured candidate rate on
# real input exceeds ESC (the runtime analog of the reference declaring
# a prefilter inert and re-routing, util/prefilter.rs:163-305 — but in
# the opposite direction: spend more filter only when needed).
# Level-0 starts CHEAP: the denser decollide=False packing lets the
# planner spend many more limbs inside one budget, and the extra
# selectivity is usually wasted (the JAX package measured dict1k on a
# TPU v5e at 7.9 GB/s at the K=7 plan against 6.8 at the K=11 plan the
# 12-limb budget reaches) — the escalation ladder exists precisely so
# real candidate rates, not the prior model, buy the finer plans.
PLAN_LEVELS = (8, 12, 24, 48, K_MAX)
ESC_FLOOR = 1 << 14
ESC_SHIFT = 6  # escalate above ~1.6% candidate positions


class FingerprintEngine:
    """Facade-facing engine: complete overlapping match sets for pattern
    sets of arbitrary size (bounded by the K_MAX bucket budget).

    Verification runs on device (DeviceVerify) when every pattern fits
    the W_MAX window, fingerprint groups are small, and a universal pad
    byte exists; otherwise candidates fall back to the host
    VerifyIndex. Scans run on ``device``."""

    def __init__(self, patterns: List[bytes], case_insensitive: bool,
                 device="cuda"):
        self.patterns = patterns
        self.ci = case_insensitive
        self.device = torch.device(device)
        self.pad_byte = strong_pad_byte(patterns, case_insensitive)
        self._tables_cache = {}
        self.level: Optional[int] = None
        for i in range(len(PLAN_LEVELS)):
            t = self._tables(i)
            if t is not None:
                self.level = i
                break
        assert self.level is not None, "caller must check eligibility"
        self.tables = self._tables(self.level)
        self._caps: Dict[str, int] = {}
        self.verif = VerifyIndex(patterns, case_insensitive)
        self.dv: Optional[DeviceVerify] = None
        if DeviceVerify.supports(patterns) and self.pad_byte is not None:
            try:
                self.dv = DeviceVerify(patterns, case_insensitive)
            except ValueError:
                self.dv = None  # oversized groups / no hash: host verify
        # Chains are at most FP_LEN bytes at every level.
        self.halo = max(_pow2(FP_LEN - 1), 4)
        self.max_pattern_len = int(self.verif.plens.max())
        self.hostile = False  # set when a scan came back candidate-dense

    def _tables(self, lvl: int) -> Optional[FingerprintTables]:
        if lvl not in self._tables_cache:
            if plan_buckets(self.patterns, self.ci,
                            PLAN_LEVELS[lvl]) is None:
                self._tables_cache[lvl] = None
            else:
                self._tables_cache[lvl] = FingerprintTables(
                    self.patterns, self.ci, PLAN_LEVELS[lvl]
                )
        return self._tables_cache[lvl]

    def _escalate(self) -> bool:
        """Move to the next finer plan level; False when maxed out."""
        for nxt in range(self.level + 1, len(PLAN_LEVELS)):
            t = self._tables(nxt)
            if t is not None and t.k > self.tables.k:
                self.level = nxt
                self.tables = t
                return True
        return False

    def _escalate_limit(self, n: int) -> int:
        return max(ESC_FLOOR, n >> ESC_SHIFT)

    @classmethod
    def eligible(cls, patterns: List[bytes],
                 case_insensitive: bool = False) -> bool:
        if not patterns or any(len(p) == 0 for p in patterns):
            return False
        return plan_buckets(patterns, case_insensitive, K_MAX) is not None

    # ------------------------------------------------------------------
    def _layout(self, n: int) -> Tuple[int, int, int]:
        """Bucketed (L, Lc, tiles); L >= 128 (pow2) so a bitmap word (32
        positions) always divides a stream, tiles rounded to <= 4
        significant bits (bitap._layout_search) to trim padding. Lc is
        the TPU version's chunk length, kept for layout parity."""
        L, tiles = _layout_search(n, self.halo)
        return L, min(L, 512), tiles

    def _pack(self, hs: bytes, L: int, tiles: int, pad: int) -> np.ndarray:
        total = tiles * LANES * L
        buf = np.full(total, pad, np.uint8) if pad else np.zeros(
            total, np.uint8
        )
        buf[: len(hs)] = np.frombuffer(hs, np.uint8)
        return buf.view(np.int32)

    def _args(self):
        return self.tables.device_tensors(self.device)

    # ------------------------------------------------------------------
    @log.spanned("prepare")
    def prepare(self, hs: bytes) -> FpHaystack:
        """Upload a haystack into the device-resident engine layout."""
        n = len(hs)
        L, Lc, tiles = self._layout(max(n, 1))
        # The universal pad byte is valid at every plan level, so one
        # upload serves escalations. The pad-byte kernel (G6) serves
        # inputs of at least FP_BAKED_MIN, as in the JAX package.
        baked = self.pad_byte is not None and n >= FP_BAKED_MIN
        with log.span("prepare.pack"):
            buf = self._pack(hs, L, tiles, self.pad_byte or 0)
        x32 = upload(buf, self.device)
        halo_a, body = _to_stream_major(x32, L, tiles, self.halo)
        u8f = None
        if self.dv is not None and n >= FP_DV_MIN:
            u8f = _verify_buffer(x32, self.dv.W, self.ci)
        return FpHaystack(n, L, Lc, tiles, baked, halo_a, body, u8f, hs)

    def bitmap(self, ph: FpHaystack):
        """(counts, bitmap) of the current plan's tables: G6 on a
        pad-byte layout, else G5 masked to [0, n)."""
        lo, hi, sm, em = self._args()
        if ph.baked:
            return _kernels.fp_bitmap_baked(lo, hi, sm, em, ph.halo_a,
                                            ph.body)
        return _kernels.fp_bitmap_generic(lo, hi, sm, em, ph.halo_a,
                                          ph.body, 0, ph.n)

    def _hostile_limit(self, n: int) -> int:
        return max(CAND_FLOOR, n >> CAND_SHIFT)

    def _verified(self, ph: FpHaystack, extract: bool):
        """Device pipeline; returns count or (pids, ends), or None when
        hostile. Caps adapt by re-running with larger sizes;
        candidate-dense inputs escalate the filter plan level first."""
        n, L = ph.n, ph.L
        limit = self._hostile_limit(n)
        esc = self._escalate_limit(n)
        dv_tabs = self.dv.device_tables(self.device)
        # Caps persist per engine instance (grown monotonically). The
        # starting floor scales with n: the select, window and verify
        # stages cost per cap slot whether or not it holds a candidate.
        floor = min(8192, max(512, _pow2(n >> 8)))
        cap_c = max(self._caps.get("c", 0), floor)
        cap_m = max(self._caps.get("m", 0), floor)
        while True:
            # One pass: the bitmap, S1 and S2 (which verifies the first
            # cap_c candidates before their count is known, as the JAX
            # dispatch does), then one read of both scalars.
            log.count("passes")
            _, bmp = self.bitmap(ph)
            ncand, e_pos, live = _ck.cand_select(bmp, L, cap_c)
            ok, pid, end, total = _ck.fp_verify(ph.u8f, e_pos, live, n,
                                                dv_tabs, self.dv.W, extract)
            with log.read():
                ncand, total = torch.stack([ncand, total]).tolist()
            log.count("candidates", ncand)
            if ncand > esc and self._escalate():
                continue
            if ncand > limit:
                self.hostile = True
                log.count("declined.fingerprint")
                return None
            settled = True
            if ncand > cap_c:
                cap_c = _pow2(ncand)
                settled = False
            if extract and total > cap_m:
                cap_m = _pow2(total)
                settled = False
            if settled:
                break
        log.count("served.fingerprint_device")
        self._caps["c"] = max(self._caps.get("c", 0), cap_c)
        if extract:
            self._caps["m"] = max(self._caps.get("m", 0), cap_m)
        self.last_caps = (cap_c, cap_m if extract else None)
        if not extract:
            return total
        out_pid, out_end = select_matches(ok, pid, end, cap_m)
        with log.read(2):
            pid = out_pid.cpu().numpy()
            end = out_end.cpu().numpy()
        with log.span("pass.order"):
            real = pid >= 0
            pid, end = pid[real], end[real]
            order = np.lexsort((self.verif.pid_rank[pid], end))
            return pid[order], end[order]

    @log.spanned("pass")
    def candidates(self, hs) -> Optional[np.ndarray]:
        """0-based fingerprint-end candidate positions, or None when the
        workload is filter-hostile (caller should fall back)."""
        ph = hs if isinstance(hs, FpHaystack) else None
        if ph is None:
            if len(hs) == 0:
                return np.zeros(0, np.int64)
            ph = self.prepare(hs)
        n = len(ph.hs)
        if n == 0:
            return np.zeros(0, np.int64)
        limit = self._hostile_limit(n)
        esc = self._escalate_limit(n)
        cap = min(4096, max(512, _pow2(n >> 8)))
        while True:
            log.count("passes")
            _, bmp = self.bitmap(ph)
            ncand, e_pos, live = _rank_select(bmp, ph.L, cap)
            log.count("candidates", ncand)
            if ncand > esc and self._escalate():
                continue
            if ncand > limit:
                self.hostile = True
                log.count("declined.fingerprint")
                return None
            if ncand <= cap:
                break
            cap = max(64, _pow2(ncand))
        with log.read():
            return e_pos[live].cpu().numpy()

    @log.spanned("pass")
    def match_pairs(
        self, hs
    ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """All overlapping matches as (pids, 1-based ends) in the
        reference's overlapping report order, or None (filter-hostile)."""
        ph = hs if isinstance(hs, FpHaystack) else None
        if ph is None:
            if len(hs) == 0:
                z = np.zeros(0, np.int64)
                return z, z
            ph = self.prepare(hs)
        if ph.n == 0:
            z = np.zeros(0, np.int64)
            return z, z
        if self.dv is not None and ph.u8f is not None:
            return self._verified(ph, extract=True)
        cand = self.candidates(ph)
        if cand is None:
            return None
        log.count("served.fingerprint_host")
        with log.span("pass.order"):
            a = np.frombuffer(ph.hs, np.uint8)
            if self.ci:
                a = _fold_arr(a)
            return self.verif.verify(a, cand)

    @log.spanned("pass")
    def count_matches(self, hs) -> Optional[int]:
        ph = hs if isinstance(hs, FpHaystack) else None
        if ph is None:
            if len(hs) == 0:
                return 0
            ph = self.prepare(hs)
        if ph.n == 0:
            return 0
        if self.dv is not None and ph.u8f is not None:
            return self._verified(ph, extract=False)
        got = self.match_pairs(ph)
        if got is None:
            return None
        return len(got[0])
