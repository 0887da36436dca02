"""The segment decomposition of the port's scan kernels, pinned on the CPU.

The Hopper kernels G1/G2 (`csrc/bitap.cu`), G3/G4 (`csrc/staged.cu`) and
G5/G6 (`csrc/fingerprint.cu`) cut each L-byte stream into P segments of
Ls = L / P bytes, with the plan from `segment_plan` (`scan_plan` for
G1-G4, which beyond 64 limbs gives each (segment, stream) a limb group of
G lanes), and give each
(segment, stream) its own thread: segment 0 warms up over the halo,
segment j > 0 over the H bytes of the stream before it; only segment 0 of
stream 0 resets its state after the warm-up (G3/G4: skips it); the G1/G5
window masks position ``s*L + j*Ls + t``. G3/G4 read the row-major words
as uploaded: a segment's walk is the run of words [s*Wb + w0 - Hw,
s*Wb + w0 + nw). Here a plain scan built segment by segment from
`PlainScan` with those rules must equal the whole-stream plain versions
(`scan_plain`, `fp_bitmap_plain`, `staged_flags_plain`,
`staged_gathered_plain`), which the other test files hold against the JAX
package's Pallas kernels. Every output is an integer: the tolerance is
exact equality.
"""

import functools

import numpy as np
import pytest
import torch

from ahocorasick_tpu_torch.ops import bitap as TB
from ahocorasick_tpu_torch.ops import fingerprint as TF
from ahocorasick_tpu_torch.ops import fingerprint_kernels as FK
from ahocorasick_tpu_torch.ops import staged as TS
from ahocorasick_tpu_torch.ops import staged_kernels as SK
from ahocorasick_tpu_torch.ops.bitap_kernels import (
    MAX_REG_LIMBS,
    PlainScan,
    bitap_scan_baked_plain,
    bitap_scan_generic_plain,
    limb_group,
    or_limbs,
    popcount32,
    scan_plan,
    segment_plan,
    to_i32,
    u32,
)

NAMES = [b"Sherlock Holmes", b"John Watson", b"Irene Adler",
         b"Inspector Lestrade", b"Professor Moriarty"]
K65 = [bytes([i]) + b"ab" for i in range(92)]  # 65 limbs: a limb group
# Resident thread slots of an H100 SXM (132 SMs x 2048 threads), which the
# wrappers read from the card.
RESIDENT_THREADS = 132 * 2048


def plan(L, H, S, align, K):
    """(P, Ls) of a launch over S streams at K limbs."""
    return scan_plan(L, H, S, K, RESIDENT_THREADS, align)[:2]


# ---------------------------------------------------------------------------
# Segment by segment, with the kernels' rules
# ---------------------------------------------------------------------------
def _segments(lo, hi, sm, em, halo, body, P):
    """Yield (PlainScan, first position in the stream, body words) for each
    segment, the scan already warmed up (and reset for stream 0 of
    segment 0)."""
    S = body.shape[1] * 128
    Hw, Wb = halo.shape[0], body.shape[0]
    assert Wb % P == 0
    nw = Wb // P
    for j in range(P):
        ps = PlainScan(lo, hi, sm, em, S)
        ps.halo(halo if j == 0 else body[j * nw - Hw:j * nw])
        if j == 0:
            ps.m[:, 0] = 0
        yield ps, 4 * j * nw, body[j * nw:(j + 1) * nw]


def segmented_scan(lo, hi, sm, em, halo, body, window, out_limbs, extract,
                   P):
    """(counts, words) of G1 (``window`` = (n0, n)) or G2 (None)."""
    S = body.shape[1] * 128
    tiles, L = S // 1024, 4 * body.shape[0]
    pos0 = torch.arange(S, dtype=torch.int64) * L
    counts = torch.zeros(S, dtype=torch.int64)
    kd = len(out_limbs)
    words = torch.full((L, kd, S), -1, dtype=torch.int64)
    for ps, t0, seg in _segments(lo, hi, sm, em, halo, body, P):
        for t, b in ps.bytes(seg):
            h = ps.step(b) & ps.em
            if window is not None:
                pos = pos0 + t0 + t
                h = h * ((pos >= window[0]) & (pos < window[1]))
            counts += popcount32(h).sum(0)
            words[t0 + t] = h[out_limbs]
    counts32 = counts.to(torch.int32).reshape(tiles, 8, 128)
    if not extract:
        return counts32, None
    words = words.reshape(L, kd, tiles, 1024).permute(2, 0, 1, 3)
    return counts32, to_i32(words.reshape(tiles, L, kd, 8, 128))


def segmented_bitmap(lo, hi, sm, em, halo, body, window, P):
    """(counts, bitmap) of G5 (``window`` = (n0, n)) or G6 (None)."""
    S = body.shape[1] * 128
    tiles, L = S // 1024, 4 * body.shape[0]
    pos0 = torch.arange(S, dtype=torch.int64) * L
    counts = torch.zeros(S, dtype=torch.int64)
    bitmap = torch.full((L // 32, S), -1, dtype=torch.int64)
    for ps, t0, seg in _segments(lo, hi, sm, em, halo, body, P):
        assert t0 % 32 == 0
        acc = torch.zeros(S, dtype=torch.int64)
        for t, b in ps.bytes(seg):
            hit = (or_limbs(ps.step(b) & ps.em) != 0).to(torch.int64)
            if window is not None:
                pos = pos0 + t0 + t
                hit = hit * ((pos >= window[0]) & (pos < window[1]))
            acc |= hit << (t % 32)
            counts += hit
            if t % 32 == 31:
                bitmap[(t0 + t) // 32] = acc
                acc = torch.zeros_like(acc)
    bitmap = bitmap.reshape(L // 32, tiles, 1024).permute(1, 0, 2)
    return (counts.to(torch.int32).reshape(tiles, 8, 128),
            to_i32(bitmap.reshape(tiles, L // 32, 8, 128)))


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------
def _hay(n, seed, pats, at=()):
    """Printable random bytes with 60 planted patterns, and pats[0] at each
    position of ``at``."""
    rng = np.random.default_rng(seed)
    buf = bytearray(rng.integers(32, 127, n, dtype=np.uint8).tobytes())
    for i, pos in enumerate(rng.integers(0, n - 32, 60)):
        p = pats[i % len(pats)]
        buf[pos:pos + len(p)] = p
    for pos in at:
        buf[pos:pos + len(pats[0])] = pats[0]
    return bytes(buf)


def _same(got, want):
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            assert torch.equal(g, w)


def _shape(ph):
    """(L, H, S) of a prepared haystack."""
    return 4 * ph.body.shape[0], 4 * ph.halo_a.shape[0], ph.tiles * 1024


# ---------------------------------------------------------------------------
# The plan
# ---------------------------------------------------------------------------
# (L, H, S, align, K) of the main path's launches and of edge shapes.
PLAN_SHAPES = [
    (2048, 32, 1024, 4, 3),       # 2 MiB count, one tile
    (2048, 8, 32768, 32, 8),      # 64 MiB dict1k
    (128, 32, 5120, 4, 3),        # 594,915 B
    (2048, 32, 4096, 4, 3),       # an 8 MiB extraction chunk
    (1024, 4, 1024, 4, 229),      # K = 229: limb groups of 8 lanes
    (512, 4, 131072, 4, 1),       # beyond the resident slots already
    (64, 32, 1024, 4, 3),         # L = 2H: two segments of H
    (32, 32, 1024, 32, 1),        # L = H: no room
    (96, 8, 1024, 32, 2),         # L not a power of two
]


@pytest.mark.parametrize("L,H,S,align,K", PLAN_SHAPES)
def test_segment_plan_invariants(L, H, S, align, K):
    P, Ls, G, KR = scan_plan(L, H, S, K, RESIDENT_THREADS, align)
    assert (G, KR) == limb_group(K) and (G > 1) == (K > MAX_REG_LIMBS)
    assert P * Ls == L and (L // 4) % P == 0  # P divides Wb
    assert Ls % align == 0
    assert P == 1 or Ls >= H
    assert P == 1 or S * P * G <= RESIDENT_THREADS
    if G == 1:
        assert (P, Ls) == segment_plan(L, H, S, align, RESIDENT_THREADS)
    # No larger valid P was left out: K caps P only through G.
    for Q in range(P + 1, L // align + 1):
        if (L // align) % Q == 0 and L // Q >= H:
            assert S * G * Q > RESIDENT_THREADS


def test_segment_plan_main_path_shapes():
    assert plan(2048, 32, 1024, 4, 3) == (64, 32)
    assert plan(2048, 8, 32768, 32, 8) == (8, 256)
    assert plan(128, 32, 5120, 4, 3) == (4, 32)
    assert plan(32, 32, 1024, 4, 3) == (1, 32)
    # K = 229 at 1 MiB: G1 takes limb groups of 8 lanes; G4 at K = 107
    # over 16,384 lanes groups of 4, 65,536 threads per segment: 4
    # segments fit the slots.
    assert scan_plan(1024, 4, 1024, 229, RESIDENT_THREADS) == (32, 32, 8, 32)
    assert plan(512, 32, 16384, 32, 107) == (4, 128)
    # A card with fewer resident slots gets fewer segments.
    assert plan(2048, 8, 32768, 32, 8) > segment_plan(2048, 8, 32768, 32,
                                                      RESIDENT_THREADS // 2)
    with pytest.raises(ValueError):
        plan(100, 8, 1024, 32, 1)


# ---------------------------------------------------------------------------
# G1/G2 by segments against the whole-stream plain version
# ---------------------------------------------------------------------------
def _scan_case(name):
    """(engine, haystack, baked, window or None) of a case."""
    if name == "names_one_tile_min_ls":
        # One tile, L = 128 and H = 32: the plan's Ls is its minimum, H.
        hay = _hay(100_000, 1, NAMES, at=(0, 30, 62, 126))
        return TB.BitapEngine(NAMES, False, "cpu"), hay, False, (0, len(hay))
    if name == "names_baked":
        hay = _hay(100_000, 2, NAMES, at=(0, 60))
        return TB.BitapEngine(NAMES, False, "cpu"), hay, True, None
    if name == "window_mid_segment":
        hay = _hay(120_000, 3, NAMES, at=(5,))
        return TB.BitapEngine(NAMES, False, "cpu"), hay, False, (
            9, len(hay) - 1000)
    if name == "k65":
        hay = _hay(30_000, 4, K65, at=(0, 6, 7, 14))
        return TB.BitapEngine(K65, False, "cpu"), hay, False, (0, len(hay))
    raise KeyError(name)


SCAN_CASES = ["names_one_tile_min_ls", "names_baked", "window_mid_segment",
              "k65"]


def _scan_args(name):
    eng, hay, baked, window = _scan_case(name)
    ph = eng.prepare(hay, baked=baked)
    assert ph.baked == baked
    limbs = (eng.tables.end_limbs if baked
             else list(range(eng.tables.k)))
    return eng, ph, window, limbs


def _scan_want(eng, ph, window, limbs, extract):
    lo, hi, sm, em = eng._args()
    if window is None:
        return bitap_scan_baked_plain(lo, hi, sm, em, limbs, ph.halo_a,
                                      ph.body, extract)
    return bitap_scan_generic_plain(lo, hi, sm, em, ph.halo_a, ph.body,
                                    window[0], window[1], extract)


@pytest.mark.parametrize("extract", [False, True])
@pytest.mark.parametrize("name", SCAN_CASES)
def test_segmented_scan_equals_whole_stream(name, extract):
    """The plan's P: counts and end words equal the whole-stream scan."""
    eng, ph, window, limbs = _scan_args(name)
    L, H, S = _shape(ph)
    P, Ls = scan_plan(L, H, S, eng.tables.k, RESIDENT_THREADS)[:2]
    assert P > 1
    if name == "names_one_tile_min_ls":
        assert ph.tiles == 1 and Ls == H
    if name == "window_mid_segment":
        assert (window[1] % L) % Ls != 0  # the window ends inside a segment
    got = segmented_scan(*eng._args(), ph.halo_a, ph.body, window, limbs,
                         extract, P)
    want = _scan_want(eng, ph, window, limbs, extract)
    assert int(want[0].sum()) > 0
    _same(got, want)


@pytest.mark.parametrize("name", ["names_one_tile_min_ls", "k65"])
def test_segmented_scan_any_segment_length(name):
    """The warm-up argument holds for every Ls >= H that divides L, not
    only the plan's: the decomposition is exact wherever the plan lands."""
    eng, ph, window, limbs = _scan_args(name)
    L, H, S = _shape(ph)
    want = _scan_want(eng, ph, window, limbs, True)
    tried = 0
    for P in range(2, L // 4 + 1):
        if (L // 4) % P or L // P < H:
            continue
        got = segmented_scan(*eng._args(), ph.halo_a, ph.body, window,
                             limbs, True, P)
        _same(got, want)
        tried += 1
    assert tried >= 2


def test_stream0_segments():
    """Only segment 0 of stream 0 starts from no history: a match at
    position 0 counts, and those that straddle the boundaries of stream
    0's segments (bytes 30-44 and 62-76, segments of 32 bytes) count
    once each."""
    eng, ph, window, limbs = _scan_args("names_one_tile_min_ls")
    L, H, S = _shape(ph)
    P, Ls = plan(L, H, S, 4, eng.tables.k)
    got, _ = segmented_scan(*eng._args(), ph.halo_a, ph.body, window,
                            limbs, False, P)
    want, _ = _scan_want(eng, ph, window, limbs, False)
    assert Ls == 32 and int(want[0, 0, 0]) >= 3
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# G5/G6 by segments against the whole-stream plain version
# ---------------------------------------------------------------------------
def _dictionary(seed, count=200):
    rng = np.random.default_rng(seed)
    pats = set()
    while len(pats) < count:
        ln = int(rng.integers(4, 13))
        pats.add(rng.integers(97, 123, ln, dtype=np.uint8).tobytes())
    return sorted(pats)


@pytest.mark.parametrize("masked", [False, True], ids=["G6", "G5"])
@pytest.mark.parametrize("name", ["names", "dictionary"])
def test_segmented_bitmap_equals_whole_stream(name, masked):
    pats = NAMES if name == "names" else _dictionary(5)
    eng = TF.FingerprintEngine(pats, name == "dictionary", "cpu")
    hay = _hay(150_000, 6, pats, at=(0, 250))
    ph = eng.prepare(hay)
    L, H, S = _shape(ph)
    P, Ls = plan(L, H, S, 32, eng.tables.k)
    assert P > 1 and Ls % 32 == 0
    window = (3, len(hay) - 77) if masked else None
    if masked:
        assert (window[1] % L) % Ls != 0
    args = eng._args() + (ph.halo_a, ph.body)
    got = segmented_bitmap(*args, window, P)
    want = FK.fp_bitmap_plain(*args, window)
    assert int(want[0].sum()) > 0
    _same(got, want)


# ---------------------------------------------------------------------------
# G3/G4 by segments of row-major runs against the whole-stream plain versions
# ---------------------------------------------------------------------------
def _warmed(lo, hi, sm, em, flat, start, Hw, skip, on_hit=None):
    """A PlainScan over len(start) lanes after the Hw warm-up words
    flat[start + i] (stream 0's wrap around the buffer); lanes in ``skip``
    do not step (they start at their body with a zero state), and
    on_hit(h) sees each step's hit words."""
    ps = PlainScan(lo, hi, sm, em, len(start))
    for i in range(Hw):
        w = flat[(start + i) % len(flat)]
        for jj in range(4):
            h = ps.step((w >> (8 * jj)) & 255) & ps.em
            ps.m[:, skip] = 0
            if on_hit is not None:
                on_hit(h * ~skip)
    return ps


def segmented_flags(lo, hi, sm, em, rows, H, P, warm_hits=True):
    """G3 as the kernel walks it: segment j of stream s steps the words
    [s*Wb + j*nw - Hw, s*Wb + (j+1)*nw) of the upload, stream 0's segment 0
    from its body, and ORs its hits into the stream's flag; the warm-up
    hits of segments j > 0 only if ``warm_hits``."""
    ns, Wb = rows.shape
    Hw, nw = H // 4, Wb // P
    flat = u32(rows.reshape(-1))
    s = torch.arange(ns)
    fl = torch.zeros(ns, dtype=torch.int64)

    def hit(h):
        nonlocal fl
        fl = fl | or_limbs(h)

    for j in range(P):
        body = s * Wb + j * nw
        skip = (s == 0) & (j == 0)
        ps = _warmed(lo, hi, sm, em, flat, body - Hw, Hw, skip,
                     hit if warm_hits or j == 0 else None)
        for i in range(nw):
            w = flat[body + i]
            for jj in range(4):
                hit(ps.step((w >> (8 * jj)) & 255) & ps.em)
    return to_i32(fl).reshape(ns // 1024, 8, 128)


def segmented_gathered(lo, hi, sm, em, end_limbs, sid, rows, H, window,
                       extract, P):
    """G4 as the kernel walks it: lane i reads row sid[i] of the upload
    (segment 0 of a lane with sid 0 skips its warm-up); a byte at flat
    index b is position b of the haystack, counted inside ``window``;
    pad lanes (sid -1) count nothing and write zero words."""
    ns, Wb = rows.shape
    L, Hw, nw = 4 * Wb, H // 4, Wb // P
    flat = u32(rows.reshape(-1))
    sid = sid.reshape(-1).to(torch.int64)
    S, live, row = sid.numel(), sid >= 0, sid.clamp(min=0)
    counts = torch.zeros(S, dtype=torch.int64)
    kd = len(end_limbs)
    words = torch.full((L, kd, S), -1, dtype=torch.int64)
    for j in range(P):
        body = row * Wb + j * nw
        ps = _warmed(lo, hi, sm, em, flat, body - Hw, Hw,
                     (sid == 0) & (j == 0))
        for i in range(nw):
            w = flat[body + i]
            for jj in range(4):
                h = ps.step((w >> (8 * jj)) & 255) & ps.em
                pos = 4 * (body + i) + jj
                h = h * (live & (pos >= window[0]) & (pos < window[1]))
                counts += popcount32(h).sum(0)
                words[4 * (j * nw + i) + jj] = h[end_limbs]
    counts32 = counts.to(torch.int32).reshape(S // 1024, 8, 128)
    if not extract:
        return counts32, None
    words = words.reshape(L, kd, S // 1024, 1024).permute(2, 0, 1, 3)
    return counts32, to_i32(words.reshape(S // 1024, L, kd, 8, 128))


LONG = bytes(range(65, 91)) * 2 + b"abcdefghijklmnopqr"  # max_len 70: H 128
STAGED_CASES = {32: NAMES, 128: NAMES + [LONG]}
# Every P with 32-byte segments of at least H bytes in a 512-byte stream.
STAGED_PS = {32: [1, 2, 4, 8, 16], 128: [1, 2, 4]}
STAGED_N = 2 * 1024 * 512  # fills two tiles of streams: no padding


@functools.lru_cache(maxsize=None)
def _staged(H):
    """(engine, rows, sid, window): a haystack that fills its buffer, with
    fingerprints ending just before segment boundaries (warm-up hits of the
    next segment), a match across the wrap from the buffer's end into
    stream 0 (which the JAX kernels drop: no history before stream 0),
    another match in stream 0 so it is a candidate, and candidates in 1024
    lanes with pad lanes; the window's both ends fall inside segments."""
    pats = STAGED_CASES[H]
    eng = TS.StagedEngine(pats, False, "cpu")
    assert eng.halo == H
    rng = np.random.default_rng(H)
    buf = bytearray(rng.integers(97, 123, STAGED_N, dtype=np.uint8)
                    .tobytes())
    for i, pos in enumerate(rng.integers(600, STAGED_N - 100, 150)):
        p = pats[i % len(pats)]
        buf[pos:pos + len(p)] = p
    for s in range(3, 1500, 37):
        for j in (1, 2, 3, 8):
            p = pats[(s + j) % len(pats)]
            end = s * 512 + 32 * j - 1 - (s % 5)
            buf[end - len(p):end] = p
    p = pats[0]
    buf[-2:] = p[:2]
    buf[:len(p) - 2] = p[2:]
    buf[100:100 + len(pats[1])] = pats[1]
    ph = eng.prepare(bytes(buf))
    assert ph.tiles * 1024 * ph.L == STAGED_N
    ncand, cand = eng.candidates(ph, 1024)
    assert 100 < ncand < 1000 and int(cand[0]) == 0
    sid = cand.to(torch.int32).reshape(1, 8, 128)
    return eng, ph.rows, sid, (37, STAGED_N - 45)


@functools.lru_cache(maxsize=None)
def _staged_want(H):
    eng, rows, sid, window = _staged(H)
    (flo, fhi, fsm, fem), (lo, hi, sm, em) = eng._args()
    return (SK.staged_flags_plain(flo, fhi, fsm, fem, rows, H),
            SK.staged_gathered_plain(lo, hi, sm, em, eng.full.end_limbs,
                                     sid, rows, H, *window, True))


STAGED_HP = [(H, P) for H, Ps in STAGED_PS.items() for P in Ps]


def test_staged_plan():
    """The P that the plan's rules allow at L = 512 (what the
    parametrisations below run), and the plans of the main path's launches:
    G3 over 64 MiB, G4 at the count and extraction shapes."""
    for H, Ps in STAGED_PS.items():
        assert Ps == [P for P in range(1, 17)
                      if 16 % P == 0 and (P == 1 or 512 // P >= H)]
        assert plan(512, H, 1024, SK.SEGMENT_ALIGN, 3) == (Ps[-1], 512 //
                                                           Ps[-1])
    assert plan(512, 32, 131072, SK.SEGMENT_ALIGN, 1) == (2, 256)
    assert plan(512, 32, 16384, SK.SEGMENT_ALIGN, 3) == (16, 32)
    assert plan(512, 128, 4096, SK.SEGMENT_ALIGN, 5) == (4, 128)


@pytest.mark.parametrize("H,P", STAGED_HP)
def test_segmented_flags_equal_whole_stream(H, P):
    """G3: raw flag words, stream 0 (whose halo wraps onto the match
    across the buffer's end) included."""
    eng, rows, _, _ = _staged(H)
    want = _staged_want(H)[0]
    assert int(want.reshape(-1)[0]) != 0 and (want != 0).sum() > 100
    got = segmented_flags(*eng._args()[0], rows, H, P)
    assert torch.equal(got, want)


@pytest.mark.parametrize("H,P", STAGED_HP)
def test_segmented_gathered_equal_whole_stream(H, P):
    """G4: counts and raw end words over the candidates' rows, with pad
    lanes, stream 0 among the candidates and a window [37, n - 45)."""
    eng, rows, sid, window = _staged(H)
    want = _staged_want(H)[1]
    counts = want[0].reshape(-1)
    assert int(counts[0]) > 0 and int(counts.sum()) > 100
    got = segmented_gathered(*eng._args()[1], eng.full.end_limbs, sid,
                             rows, H, window, True, P)
    _same(got, want)


def test_flags_warmup_hits_either_way():
    """A segment j > 0 warms up from a zero state, so its warm-up hits are
    true hits of its own stream, which segment j - 1 reports anyway: G3's
    flags are the same whether the kernel ORs them in (it does) or not.
    The haystack has such hits."""
    H, P = 32, 16
    eng, rows, _, _ = _staged(H)
    args = eng._args()[0] + (rows, H)
    want = _staged_want(H)[0]
    assert torch.equal(segmented_flags(*args, P, warm_hits=True), want)
    assert torch.equal(segmented_flags(*args, P, warm_hits=False), want)
    ns, Wb = rows.shape
    flat = u32(rows.reshape(-1))
    warm = 0
    for j in range(1, P):
        body = torch.arange(ns) * Wb + j * (Wb // P)

        def count(h):
            nonlocal warm
            warm += int((h != 0).sum())
        _warmed(*args[:4], flat, body - H // 4, H // 4,
                torch.zeros(ns, dtype=torch.bool), count)
    assert warm > 10


def test_stream0_skips_wrapped_halo():
    """Stream 0's halo wraps onto the buffer's last bytes, where a match
    begins that continues into stream 0: the JAX kernels reset after the
    halo, so it is not counted, and a walk that carried the wrapped state
    would count it."""
    H = 32
    eng, rows, sid, window = _staged(H)
    lo, hi, sm, em = eng._args()[1]
    el = eng.full.end_limbs
    full = (0, STAGED_N)
    want = SK.staged_gathered_plain(lo, hi, sm, em, el, sid, rows, H, *full,
                                    False)[0]
    got = segmented_gathered(lo, hi, sm, em, el, sid, rows, H, full, False,
                             4)[0]
    assert torch.equal(got, want)
    # The same scan with the wrapped halo walked and no reset.
    ns, Wb = rows.shape
    flat = u32(rows.reshape(-1))
    ps = _warmed(lo, hi, sm, em, flat, torch.tensor([ns * Wb - H // 4]),
                 H // 4, torch.zeros(1, dtype=torch.bool))
    carried = 0
    for i in range(Wb):
        for jj in range(4):
            carried += int(popcount32(ps.step((flat[i:i + 1] >> (8 * jj))
                                              & 255) & ps.em).sum())
    assert carried == int(want.reshape(-1)[0]) + 1
