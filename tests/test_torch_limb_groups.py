"""The limb groups of G1/G2 beyond 64 limbs, pinned on the CPU.

Past 64 limbs the Hopper kernels G1 and G2 (`csrc/bitap.cu`,
`group_kernel`) split the K limbs of a stream over a group of G lanes of a
warp: lane g holds limbs [g*KR, (g+1)*KR) in registers, its carry into its
first limb is the old top limb of lane g - 1 (lane 0 takes 0), each lane
counts its own hits (the group's counts are summed), G1's end words are
written by the lane that holds the limb and G2's end-bearing limbs are
numbered across the group from a prefix of the lanes below. Here a plain
scan built with those rules, segment by segment as `scan_plan` cuts the
streams, must equal the whole-stream plain version `scan_plain`, which
the last test here holds against the JAX package's Pallas kernel at
K = 65, on the inputs of `tests/test_torch_bitap.py` (its one
interpret-mode call compiles for minutes: in this file of quick cases it
runs beside little else). Every output is an integer: the tolerance is
exact equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ahocorasick_tpu.ops.bitap as JB
from ahocorasick_tpu_torch.ops import bitap as TB
from ahocorasick_tpu_torch.ops import bitap_kernels as TK
from ahocorasick_tpu_torch.ops.bitap_kernels import (
    GROUP_LIMBS,
    MAX_GROUP,
    MAX_GROUP_LIMBS,
    MAX_REG_LIMBS,
    bitap_scan_baked_plain,
    bitap_scan_generic_plain,
    group_tables_shared,
    limb_group,
    padded_tables,
    popcount32,
    scan_plan,
    segment_plan,
    to_i32,
    u32,
)
from test_torch_bitap import _engines, _packed, _port_tables, _t
from test_torch_limb_sets import K_OF, SETS
from torch_suite import per_test_time_limit  # noqa: F401

_M32 = 0xFFFFFFFF
# Resident thread slots of an H100 SXM (132 SMs x 2048 threads), which the
# wrappers read from the card.
RESIDENT_THREADS = 132 * 2048


def _hay(n, seed, pats):
    rng = np.random.default_rng(seed)
    buf = bytearray(rng.integers(0, 256, n, dtype=np.uint8).tobytes())
    for i, pos in enumerate(rng.integers(0, n - 70, n // 40)):
        p = pats[i % len(pats)]
        buf[pos:pos + len(p)] = p
    return bytes(buf)


# ---------------------------------------------------------------------------
# The limb-group kernel's rules, in plain torch
# ---------------------------------------------------------------------------
def group_scan(lo, hi, sm, em, halo, body, window, end_limbs, P, G, KR):
    """(counts [tiles,8,128], words) of G1 (``window`` = (n0, n), words
    [tiles,L,K,8,128]) or G2 (``window`` None, words [tiles,L,Ke,8,128],
    Ke = len(end_limbs)), as the limb-group kernel computes them: one
    thread per (segment, stream, lane of the group). Lanes past the last
    live limb compute nothing that is reported (zero start and end masks,
    carries flow upward only), so they are left out."""
    K = lo.shape[0]
    S = body.shape[1] * 128
    tiles = S // 1024
    Hw, Wb = halo.shape[0], body.shape[0]
    nw, L = Wb // P, 4 * Wb
    live = -(-K // KR)
    assert live <= G and Wb % P == 0

    def lanes(x):
        """[K, ...] -> [live, KR, ...]: lane g's slice, zero past K."""
        x = u32(x)
        pad = x.new_zeros((live * KR - K,) + tuple(x.shape[1:]))
        return torch.cat([x, pad]).reshape(live, KR, *x.shape[1:])
    LO, HI = lanes(lo).permute(2, 0, 1), lanes(hi).permute(2, 0, 1)
    SM, EM = lanes(sm), lanes(em)
    # Each thread's walk: Hw warm-up words (the halo for segment 0, else
    # the Hw body words before the segment), then its nw body words.
    walks = torch.stack([torch.cat([
        halo if j == 0 else body[j * nw - Hw:j * nw],
        body[j * nw:(j + 1) * nw]]) for j in range(P)], 1)
    walks = u32(walks.reshape(Hw + nw, P * S))  # thread j*S + s
    m = torch.zeros((P * S, live, KR), dtype=torch.int64)

    def step(b):
        nonlocal m
        # One shuffle: the old top limb of the lane below, 0 for lane 0.
        carry = torch.zeros_like(m[:, :, 0])
        carry[:, 1:] = m[:, :-1, KR - 1]
        below = torch.cat([carry[:, :, None], m[:, :, :-1]], 2)
        m = (((m << 1) & _M32) | (below >> 31) | SM) & LO[b & 15] & HI[
            b >> 4]
        return m

    for i in range(Hw):
        for jj in range(4):
            step((walks[i] >> (8 * jj)) & 255)
    m[0] = 0  # stream 0, segment 0: its halo wraps around the buffer
    seg = torch.arange(P, dtype=torch.int64).repeat_interleave(S)
    stream = torch.arange(S, dtype=torch.int64).repeat(P)
    pos0 = stream * L + seg * 4 * nw
    cnt = torch.zeros((P * S, live), dtype=torch.int64)
    if window is None:
        # G2: lane g's first slot counts the end-bearing limbs below it.
        ends = EM != 0
        per_lane = ends.sum(1)
        slot0 = torch.cumsum(per_lane, 0) - per_lane
        slots = (slot0[:, None] + torch.cumsum(ends.to(torch.int64), 1)
                 - 1)[ends]
        assert slots.tolist() == list(range(len(end_limbs)))
        kdim = len(end_limbs)
    else:
        kdim = K
    words = torch.zeros((L, kdim, S), dtype=torch.int64)
    for i in range(nw):
        for jj in range(4):
            h = step((walks[Hw + i] >> (8 * jj)) & 255) & EM
            if window is not None:
                pos = pos0 + 4 * i + jj
                ok = (pos >= window[0]) & (pos < window[1])
                h = h * ok[:, None, None]
            cnt += popcount32(h).sum(2)  # each lane's own count
            flat = h.reshape(P, S, live * KR)
            for j in range(P):
                t = 4 * (j * nw + i) + jj
                if window is None:
                    words[t] = flat[j][:, ends.reshape(-1)].T
                else:
                    words[t] = flat[j][:, :K].T  # live limbs only
    counts = cnt.sum(1).reshape(P, S).sum(0)  # the group's sum, per stream
    words = words.reshape(L, kdim, tiles, 1024).permute(2, 0, 1, 3)
    return (counts.to(torch.int32).reshape(tiles, 8, 128),
            to_i32(words.reshape(tiles, L, kdim, 8, 128)))


def _case(name):
    """(engine, prepared haystack, window) of a set: the shortest streams
    with room for two segments, one tile, and a window ending inside a
    segment."""
    pats = SETS[name]
    eng = TB.BitapEngine(pats, False, "cpu")
    n = 1024 * 2 * eng.halo - 150
    hay = _hay(n, 3, pats)
    ph = eng.prepare(hay, baked=False)
    return eng, ph, (5, n - 3)


@pytest.mark.parametrize("kernel", ["G1", "G2"])
@pytest.mark.parametrize("name", list(SETS))
def test_limb_groups_equal_whole_stream(name, kernel):
    """Counts and end words of the limb groups at the plan's P (> 1) equal
    the whole-stream plain version, count and extract alike."""
    eng, ph, window = _case(name)
    K = eng.tables.k
    assert K == K_OF.get(name, K) and K > MAX_REG_LIMBS
    if name == "lane_carry":
        assert any(o < 32 * GROUP_LIMBS[0] <= o + 64
                   for o in TB.pack_chains([65] * 22)[0])
    L, H, S = 4 * ph.body.shape[0], 4 * ph.halo_a.shape[0], ph.tiles * 1024
    P, Ls, G, KR = scan_plan(L, H, S, K, RESIDENT_THREADS)
    assert P > 1 and ph.tiles == 1
    lo, hi, sm, em = eng._args()
    el = eng.tables.end_limbs
    if kernel == "G1":
        assert (window[1] % L) % Ls  # the window ends inside a segment
        got = group_scan(lo, hi, sm, em, ph.halo_a, ph.body, window, None,
                         P, G, KR)
        want = bitap_scan_generic_plain(lo, hi, sm, em, ph.halo_a, ph.body,
                                        *window, True)
    else:
        got = group_scan(lo, hi, sm, em, ph.halo_a, ph.body, None, el, P, G,
                         KR)
        want = bitap_scan_baked_plain(lo, hi, sm, em, el, ph.halo_a, ph.body,
                                      True)
    # The counts are those of a count-only scan too (scan_plain computes
    # them alike with and without words).
    assert int(want[0].sum()) > 0
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# ---------------------------------------------------------------------------
# The plan
# ---------------------------------------------------------------------------
# (L, H, S) of the main path's launches and of edge shapes: 1 MiB and
# 4 MiB, 64 MiB (S * G passes the resident slots from G = 16), the
# 594,915-byte layout, a long halo, L = H.
PLAN_SHAPES = [(1024, 4, 1024), (2048, 4, 2048), (2048, 8, 32768),
               (128, 32, 5120), (2048, 128, 4096), (64, 64, 1024)]


@pytest.mark.parametrize("L,H,S", PLAN_SHAPES)
def test_plan_every_k(L, H, S):
    """Every K from 65 to 2,048 gets a plan: S * P * G threads in P
    segments of Ls >= H bytes, each lane at most KR limbs, the least group
    that holds them; P = 1, in several waves, where S * G alone passes the
    resident slots."""
    for K in range(MAX_REG_LIMBS + 1, MAX_GROUP_LIMBS + 1):
        P, Ls, G, KR = scan_plan(L, H, S, K, RESIDENT_THREADS)
        assert (G, KR) == limb_group(K)
        assert KR == (32 if K <= 1024 else 64) and G & (G - 1) == 0
        assert 4 <= G <= MAX_GROUP and -(-K // KR) <= G < 2 * -(-K // KR)
        assert P * Ls == L and Ls % 4 == 0 and (L // 4) % P == 0
        assert Ls >= H
        threads = S * P * G
        if S * G > RESIDENT_THREADS:
            assert P == 1
        assert P == 1 or threads <= RESIDENT_THREADS
        # No larger valid P was left out.
        for Q in range(P + 1, L // 4 + 1):
            if (L // 4) % Q == 0 and L // Q >= H:
                assert S * G * Q > RESIDENT_THREADS


def test_plan_up_to_64_limbs_is_unchanged():
    """K <= 64: one lane per stream holds every limb, P as segment_plan
    gives it."""
    for K in range(1, MAX_REG_LIMBS + 1):
        for L, H, S in PLAN_SHAPES:
            P, Ls, G, KR = scan_plan(L, H, S, K, RESIDENT_THREADS)
            assert (G, KR) == (1, K)
            assert (P, Ls) == segment_plan(L, H, S, 4, RESIDENT_THREADS)
    for K in (0, MAX_GROUP_LIMBS + 1):
        with pytest.raises(ValueError):
            limb_group(K)


def test_plan_main_path_shapes():
    # 1 MiB, K = 229: 8 lanes per stream, 32 segments of 32 bytes.
    assert scan_plan(1024, 4, 1024, 229, RESIDENT_THREADS) == (32, 32, 8, 32)
    # 64 MiB of the 128-word set, K = 103: 4 lanes, two segments.
    assert scan_plan(2048, 8, 32768, 103, RESIDENT_THREADS) == (
        2, 1024, 4, 32)
    # 64 MiB at K = 229: S * G = 262,144 threads, one segment.
    assert scan_plan(2048, 4, 32768, 229, RESIDENT_THREADS)[:3] == (1, 2048,
                                                                    8)
    # K = 1,121: 32 lanes of 64 limbs.
    assert scan_plan(2048, 4, 2048, 1121, RESIDENT_THREADS) == (4, 512, 32,
                                                                64)


def test_group_tables_in_shared_memory_up_to_1728_limbs():
    """A group's tables sit in shared memory while 2 x (live slices) x
    (16 KR + 32 / G) words and the ring fit in 227 KiB: K <= 1,728; past
    it the lanes read them from device memory, from allocations that the
    tables' owner pads with zero limbs to whole slices (``padded_tables``,
    once per device in ``BitapTables.device_tensors``)."""
    assert all(group_tables_shared(K, *limb_group(K))
               for K in range(65, 1729))
    assert not any(group_tables_shared(K, *limb_group(K))
                   for K in range(1729, MAX_GROUP_LIMBS + 1))
    rng = np.random.default_rng(0)
    for K in (40, 100, 1729, 2048):
        lo = torch.from_numpy(rng.integers(-2**31, 2**31, (K, 16),
                                           dtype=np.int64).astype(np.int32))
        hi = lo.flip(0).contiguous()
        lo2, hi2 = padded_tables(lo, hi)
        if K <= MAX_REG_LIMBS:
            assert lo2 is lo and hi2 is hi
            continue
        rows = -(-K // limb_group(K)[1]) * limb_group(K)[1]
        for t, want in ((lo2, lo), (hi2, hi)):
            assert t.shape == (K, 16) and t.is_contiguous()
            assert torch.equal(t, want)
            whole = torch.empty(0, dtype=torch.int32).set_(
                t.untyped_storage()).reshape(-1, 16)
            assert whole.shape[0] == rows and not whole[K:].any()
    lo, hi, _, _ = TB.BitapTables(SETS["k1121"], False).device_tensors("cpu")
    assert lo.shape == (1121, 16)
    assert lo.untyped_storage().nbytes() == hi.untyped_storage().nbytes() == (
        18 * 64 * 16 * 4)


def test_k_over_64_generic_equals_pallas():
    """K = 65 limbs: the Hopper kernel keeps such state in a global
    scratch instead of registers. One JAX extract call gives the total and
    the raw words; the plain version and the port's engine match both."""
    jeng, teng, hay = _engines("k_over_64")
    t = jeng.tables
    assert t.k == 65
    L, Lc, tiles, halo, body = _packed(jeng, hay, 0)
    n = len(hay)
    total, jwords = JB._bitap_call(
        *t.device_args(), jnp.asarray(halo), jnp.asarray(body),
        jnp.asarray([0, n], jnp.int32), K=t.k, L=L, Lc=Lc, H=jeng.halo,
        tiles=tiles, extract=True)
    jwords = np.asarray(jwords)
    lo, hi, sm, em = _port_tables(teng)
    counts, words = TK.bitap_scan_generic_plain(
        lo, hi, sm, em, _t(halo), _t(body), 0, n, True)
    assert int(counts.sum()) == int(total) == 2
    np.testing.assert_array_equal(words.numpy(), jwords)
    flat = jwords.reshape(-1)
    nz = np.flatnonzero(flat)
    jp, je = JB.decode_match_words(t, nz, flat[nz].view(np.uint32), L, t.k,
                                   flat.size)
    assert teng.count_matches(hay) == 2
    tp, te = teng.match_pairs(hay)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(te, je)
