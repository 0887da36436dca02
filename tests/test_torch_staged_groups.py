"""The limb groups of G3/G4 beyond 64 limbs, pinned on the CPU.

Past 64 limbs the staged engine's Hopper kernels (`csrc/staged.cu`,
`group_flags_kernel` and `group_gathered_kernel`) split the K limbs of a
stream over a group of G lanes of a warp, as G1/G2 do: lane g holds limbs
[g*KR, (g+1)*KR) in registers and takes the carry into its first limb from
the old top limb of lane g - 1. They read the upload's rows in place, so
their rules differ from G1/G2's in four places, which a plain scan built
here with those rules, segment by segment as `scan_plan` cuts the streams,
holds against the whole-stream plain versions `staged_flags_plain` and
`staged_gathered_plain` (which `tests/test_torch_staged.py` holds against
the JAX package's Pallas kernels):
  - stream 0's segment 0 (G4: a lane with sid 0) walks its warm-up like
    the other lanes of its warp, on word 0 in place of the words before
    the buffer, then resets its state at its body (G3 also drops the flag
    of its warm-up);
  - G3's flag word is the OR of each lane's hits over halo and body, then
    the OR over the group's lanes;
  - G4's count is the sum over the group; its end-bearing limbs are
    numbered across the group from the count of those of the lanes below,
    so each lane writes its own slots of [tiles_c, L, Ke, 8, 128];
  - a pad lane (sid -1) beside live ones in its warp walks row 0 with an
    empty window; a warp of pad lanes only writes zero words and leaves.
No Pallas call runs here. Every output is an integer: the tolerance is
exact equality.
"""

import functools

import numpy as np
import pytest
import torch

from ahocorasick_tpu_torch.ops import staged_kernels as SK
from ahocorasick_tpu_torch.ops.bitap import BitapTables, _pow2
from ahocorasick_tpu_torch.ops.bitap_kernels import (
    MAX_GROUP_LIMBS,
    MAX_REG_LIMBS,
    limb_group,
    popcount32,
    scan_plan,
    segment_plan,
    u32,
)
from ahocorasick_tpu_torch.ops.staged import STAGED_L, _fingerprints
from test_torch_limb_sets import SETS, STAGED_K, STAGED_SETS
from torch_suite import per_test_time_limit  # noqa: F401

_M32 = 0xFFFFFFFF
# Resident thread slots of an H100 SXM (132 SMs x 2048 threads), which the
# wrappers read from the card.
RESIDENT_THREADS = 132 * 2048
NS = 2048                   # two tiles of streams
CAND = 1024                 # candidate lanes of G4
LIVE = 601                  # of them live: the warp of lanes 600-607 straddles


# ---------------------------------------------------------------------------
# Inputs: the 100 words (K = 83 / Kf = 75, and with LONG K = 85 / Kf = 76)
# and the K = 107 set on the engine's 512-byte streams; the k229 / k461
# tables passed straight to the scans, on 64-byte streams (the kernels take
# any whole ring slots), which keeps the plain versions' walks short
# ---------------------------------------------------------------------------
CASES = ["w100", "w100_long", "spill", "k229", "k461"]


@functools.lru_cache(maxsize=None)
def _case(name):
    """(fingerprint tables, full tables, end limbs, H, rows [NS, L/4], sid
    [CAND/1024, 8, 128]): random lowercase bytes that fill the buffer, with
    one pattern per 400 bytes, a match across the wrap from the buffer's
    end into stream 0 and one in stream 0's body; sid holds stream 0, 600
    other streams in order and pad lanes."""
    if name in STAGED_SETS:
        pats, L = STAGED_SETS[name], STAGED_L
        fp = BitapTables(_fingerprints(pats), False)
    else:
        pats, L, fp = SETS[name], 64, None
    N = NS * L
    full = BitapTables(pats, False)
    fp = fp or full  # k229, k461: the set's own tables in both scans
    H = max(_pow2(max(full.max_pattern_len - 1, 1)), 4)
    rng = np.random.default_rng(len(pats))
    buf = bytearray(rng.integers(97, 123, N, dtype=np.uint8).tobytes())
    for i, pos in enumerate(rng.integers(100, N - 100, N // 400)):
        p = pats[i % len(pats)]
        buf[pos:pos + len(p)] = p
    p = max(pats[:50], key=len)
    buf[-2:] = p[:2]
    buf[:len(p) - 2] = p[2:]
    buf[40:40 + len(pats[1])] = pats[1]
    rows = torch.from_numpy(np.frombuffer(bytes(buf), np.int32).copy())
    rows = rows.reshape(NS, L // 4)
    others = np.sort(rng.choice(np.arange(1, NS), LIVE - 1, replace=False))
    sid = np.full(CAND, -1, np.int32)
    sid[0], sid[1:LIVE] = 0, others
    tabs = tuple(tuple(torch.from_numpy(a) for a in (t.lo, t.hi, t.start,
                                                     t.end))
                 for t in (fp, full))
    return (*tabs, full.end_limbs, H, rows,
            torch.from_numpy(sid).reshape(CAND // 1024, 8, 128))


def _window(rows):
    """[37, n - 45) of a buffer of rows: both ends inside a segment of 32
    bytes or more."""
    return 37, 4 * rows.numel() - 45


# ---------------------------------------------------------------------------
# The limb-group kernels' rules, in plain torch
# ---------------------------------------------------------------------------
class GroupWalk:
    """The limb state m [T, live * KR] of T threads' groups, lane g of a
    group holding limbs [g*KR, (g+1)*KR), as int32 bit patterns. Lanes
    past the last live limb report nothing and carry nothing upward, so
    they are left out."""

    def __init__(self, lo, hi, sm, em, T, KR):
        K = lo.shape[0]
        self.live = -(-K // KR)
        Kp = self.live * KR
        pad = lambda x: torch.nn.functional.pad(x, (0, Kp - K))  # noqa: E731
        b = torch.arange(256)
        # The charmask of every byte, limbs padded with zeros: [256, Kp].
        self.CM = pad((lo[:, b & 15] & hi[:, b >> 4]).T)
        self.SM, self.EM = pad(sm), pad(em)
        self.ends = torch.nonzero(self.EM).flatten()  # end-bearing limbs
        self.m = torch.zeros((T, Kp), dtype=torch.int32)

    def step(self, b):
        """Advance every thread by its byte b [T]; returns m'. A lane's
        first limb takes the old top limb of the lane below (one shuffle),
        its other limbs the old limb below them: in limb order, the old
        limb before each."""
        m = self.m
        below = torch.cat([m.new_zeros((m.shape[0], 1)), m[:, :-1]], 1)
        self.m = ((m << 1) | ((below >> 31) & 1) | self.SM) & self.CM[b]
        return self.m


def _threads(P, S, Wb):
    """(segment, lane) of the P * S threads' groups, and nw."""
    j = torch.arange(P).repeat_interleave(S)
    s = torch.arange(S).repeat(P)
    return j, s, Wb // P


def _bytes(flat, at, wrap=False):
    """The four byte vectors of the words at flat indices ``at``: indices
    below 0 read word 0, as the kernels do, or with ``wrap`` the words they
    stand for at the buffer's end."""
    w = flat[at % flat.numel() if wrap else at.clamp(min=0)]
    return [(w >> (8 * jj)) & 255 for jj in range(4)]


def _or_all(x):
    """OR of int32 words [T, C] over C (torch has no OR reduction)."""
    out = torch.zeros(x.shape[0], dtype=torch.int32)
    for c in range(x.shape[1]):
        out |= x[:, c]
    return out


def group_flags(lo, hi, sm, em, rows, H, P, G, KR, reset=True):
    """G3's flag words [tiles, 8, 128] as the limb-group kernel computes
    them: thread (segment j, stream s) walks words [s*Wb + j*nw - Hw,
    s*Wb + (j+1)*nw) of the upload and ORs m' & end over halo and body;
    stream 0's segment 0 resets its state and flag at its body (with
    ``reset``)."""
    ns, Wb = rows.shape
    Hw = H // 4
    j, s, nw = _threads(P, ns, Wb)
    gw = GroupWalk(lo, hi, sm, em, P * ns, KR)
    flat = u32(rows.reshape(-1))
    start = s * Wb + j * nw - Hw
    first = (s == 0) & (j == 0)
    fl = torch.zeros((P * ns, len(gw.ends)), dtype=torch.int32)
    for i in range(Hw + nw):
        if reset and i == Hw:
            gw.m[first] = 0
            fl[first] = 0
        for b in _bytes(flat, start + i):
            fl |= gw.step(b)[:, gw.ends] & gw.EM[gw.ends]
    per_thread = _or_all(fl)  # each lane's OR, then the group's
    out = torch.zeros(ns, dtype=torch.int32)
    for jj in range(P):
        out |= per_thread[jj * ns:(jj + 1) * ns]
    return out.reshape(ns // 1024, 8, 128)


def group_gathered(lo, hi, sm, em, end_limbs, sid, rows, H, window, P, G,
                   KR, reset=True):
    """G4's (counts [tiles_c, 8, 128], words [tiles_c, L, Ke, 8, 128]) as
    the limb-group kernel computes them: candidate lane c reads row sid[c]
    (row 0 for a pad lane, whose window is empty); stream 0's segment 0
    resets at its body (with ``reset``); each lane counts its own hits
    and writes its end-bearing limbs to slots numbered from the count of
    those of the lanes below; the group sums its counts; a warp of pad
    lanes only writes zero words. Without ``reset`` stream 0 walks the
    words its warm-up stands for, at the buffer's end, and keeps the state
    they leave."""
    ns, Wb = rows.shape
    L, Hw = 4 * Wb, H // 4
    sid = sid.reshape(-1).to(torch.int64)
    S = sid.numel()
    j, c, nw = _threads(P, S, Wb)
    gw = GroupWalk(lo, hi, sm, em, P * S, KR)
    # Slots: lane g's first one counts the end-bearing limbs below it.
    ends = (gw.EM != 0).reshape(gw.live, KR)
    per_lane = ends.sum(1)
    slot0 = torch.cumsum(per_lane, 0) - per_lane
    slots = (slot0[:, None] + torch.cumsum(ends.to(torch.int64), 1) - 1)[ends]
    assert slots.tolist() == list(range(len(end_limbs)))
    assert gw.ends.tolist() == list(end_limbs)  # the limb of each slot
    pad = sid[c] < 0
    warp_pad = (sid < 0).reshape(-1, 32 // G).all(1).repeat_interleave(
        32 // G)[c]
    row = torch.where(pad, 0, sid[c])
    n_hi = torch.where(pad, 0, window[1])
    flat = u32(rows.reshape(-1))
    start = row * Wb + j * nw - Hw
    first = (sid[c] == 0) & (j == 0)
    cnt = torch.zeros(P * S, dtype=torch.int64)
    words = torch.full((L, len(end_limbs), S), -1, dtype=torch.int32)
    for i in range(Hw + nw):
        if reset and i == Hw:
            gw.m[first] = 0
        for jj, b in enumerate(_bytes(flat, start + i, wrap=not reset)):
            m = gw.step(b)
            if i < Hw:
                continue
            pos = 4 * (start + i) + jj
            ok = (pos >= window[0]) & (pos < n_hi) & ~warp_pad
            h = (m[:, gw.ends] & gw.EM[gw.ends]) * ok[:, None]
            cnt += popcount32(u32(h)).sum(1)
            words[4 * (j * nw + i - Hw) + jj, :, c] = h
    counts = cnt.reshape(P, S).sum(0)
    tiles = S // 1024
    words = words.reshape(L, -1, tiles, 1024).permute(2, 0, 1, 3)
    return (counts.to(torch.int32).reshape(tiles, 8, 128),
            words.reshape(tiles, L, -1, 8, 128))


def _plan(K, H, S, rows):
    """(P, Ls, G, KR) of a launch over S lanes of the rows' streams."""
    P, Ls, G, KR = scan_plan(4 * rows.shape[1], H, S, K, RESIDENT_THREADS,
                             SK.SEGMENT_ALIGN)
    assert (G, KR) == limb_group(K) and G > 1
    return P, Ls, G, KR


@functools.lru_cache(maxsize=None)
def _flags_want(name):
    ftab, _, _, H, rows, _ = _case(name)
    return SK.staged_flags_plain(*ftab, rows, H)


@functools.lru_cache(maxsize=None)
def _gathered_want(name):
    _, tab, el, H, rows, sid = _case(name)
    return SK.staged_gathered_plain(*tab, el, sid, rows, H, *_window(rows),
                                    True)


# ---------------------------------------------------------------------------
# G3 and G4 by limb groups against the whole-stream plain versions
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", CASES)
def test_group_flags_equal_plain(name):
    """G3's raw flag words at the plan's P and G, stream 0 (whose warm-up
    wraps onto the match across the buffer's end) included."""
    ftab, _, _, H, rows, _ = _case(name)
    Kf = ftab[0].shape[0]
    assert Kf == STAGED_K.get(name, (0, Kf))[1] and Kf > MAX_REG_LIMBS
    P, _, G, KR = _plan(Kf, H, NS, rows)
    assert P > 1
    want = _flags_want(name)
    assert int(want.reshape(-1)[0]) != 0 and (want != 0).sum() > 100
    assert torch.equal(group_flags(*ftab, rows, H, P, G, KR), want)


@pytest.mark.parametrize("name", CASES)
def test_group_gathered_equal_plain(name):
    """G4's counts and raw end words over the candidates' rows at the
    plan's P and G: stream 0 among the candidates, pad lanes beside live
    ones in one warp and warps of pad lanes only, a window [37, n - 45)."""
    _, tab, el, H, rows, sid = _case(name)
    K = tab[0].shape[0]
    assert K == STAGED_K.get(name, (K,))[0] and K > MAX_REG_LIMBS
    P, Ls, G, KR = _plan(K, H, CAND, rows)
    n0, n1 = _window(rows)
    assert P > 1 and n0 % Ls and n1 % Ls
    flat = sid.reshape(-1)
    # The warp of lanes 600 .. 600 + 32/G - 1 holds live and pad lanes.
    assert int(flat[LIVE - 1]) >= 0 > int(flat[LIVE])
    assert (LIVE - 1) // (32 // G) == LIVE // (32 // G)
    want = _gathered_want(name)
    assert int(want[0].reshape(-1)[0]) > 0 and int(want[0].sum()) > 100
    got = group_gathered(*tab, el, sid, rows, H, _window(rows), P, G, KR)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_stream0_wrap_needs_reset():
    """The haystack exercises the reset: a walk that carried the state of
    the buffer's last words into stream 0 would count the match across
    the buffer's end."""
    name = "w100"
    ftab, tab, el, H, rows, sid = _case(name)
    P, _, G, KR = _plan(tab[0].shape[0], H, CAND, rows)
    n = 4 * rows.numel()
    got = group_gathered(*tab, el, sid, rows, H, (0, n), P, G, KR,
                         reset=False)[0]
    want = SK.staged_gathered_plain(*tab, el, sid, rows, H, 0, n, False)[0]
    assert int(got.reshape(-1)[0]) == int(want.reshape(-1)[0]) + 1
    assert torch.equal(got.reshape(-1)[1:], want.reshape(-1)[1:])


# ---------------------------------------------------------------------------
# The plan
# ---------------------------------------------------------------------------
# (L, H, S) of the staged launches: G3 over 4 MiB and 64 MiB of 512-byte
# streams, G4 over 1,024 .. 32,768 candidate lanes, halos of 4 to 128
# bytes, L = H.
PLAN_SHAPES = [(512, 16, 8192), (512, 16, 131072), (512, 16, 1024),
               (512, 128, 4096), (512, 16, 32768), (512, 4, 2048),
               (512, 512, 1024)]


@pytest.mark.parametrize("L,H,S", PLAN_SHAPES)
def test_staged_plan_every_k(L, H, S):
    """Every K from 1 to 2,048 gets a staged plan: S * P * G threads in P
    segments of Ls bytes, Ls a multiple of 32 and at least H, each lane
    at most KR limbs (the least group that holds them beyond 64); P = 1,
    in several waves, where S * G alone passes the resident slots; no
    other cap on P. K <= 64 keeps one lane per stream and segment_plan's
    P."""
    for K in range(1, MAX_GROUP_LIMBS + 1):
        P, Ls, G, KR = scan_plan(L, H, S, K, RESIDENT_THREADS,
                                 SK.SEGMENT_ALIGN)
        assert (G, KR) == limb_group(K)
        if K <= MAX_REG_LIMBS:
            assert (G, KR) == (1, K)
            assert (P, Ls) == segment_plan(L, H, S, SK.SEGMENT_ALIGN,
                                           RESIDENT_THREADS)
        else:
            assert 4 <= G <= 32 and -(-K // KR) <= G < 2 * -(-K // KR)
        assert P * Ls == L and Ls % SK.SEGMENT_ALIGN == 0
        assert (L // 4) % P == 0 and (P == 1 or Ls >= H)
        if S * G > RESIDENT_THREADS:
            assert P == 1
        assert P == 1 or S * P * G <= RESIDENT_THREADS
        for Q in range(P + 1, L // SK.SEGMENT_ALIGN + 1):
            if (L // SK.SEGMENT_ALIGN) % Q == 0 and L // Q >= H:
                assert S * G * Q > RESIDENT_THREADS


def test_staged_plan_main_path_shapes():
    """The facade's staged launches of the 100 words: G3 over the 131,072
    streams of 64 MiB at Kf = 75 (G = 4, one segment: 524,288 threads in
    waves), G4 over 16,384 and 32,768 candidate lanes at K = 83, and the
    extraction's G4 at K = 85 (halo 128) over 4,096 lanes."""
    R = RESIDENT_THREADS
    assert scan_plan(512, 16, 131072, 75, R, 32) == (1, 512, 4, 32)
    assert scan_plan(512, 16, 16384, 83, R, 32) == (4, 128, 4, 32)
    assert scan_plan(512, 16, 32768, 83, R, 32) == (2, 256, 4, 32)
    assert scan_plan(512, 128, 4096, 85, R, 32) == (4, 128, 4, 32)
