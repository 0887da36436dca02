"""The port's Hopper kernels on the card (marker `cuda`).

Each kernel is held against its plain PyTorch version on the same CUDA
tensors, and the facade is driven through the kernels with their launch
counters checked. Outputs are integers: the tolerance is exact equality.
Run on a machine with an NVIDIA GPU and nvcc:

    python -m pytest -m cuda tests/test_torch_cuda.py

Whether a card is present is decided inside the fixture, so every worker
collects the same tests; without a card they skip.
"""

import numpy as np
import pytest
import torch

from ahocorasick_tpu_torch import AhoCorasick
from ahocorasick_tpu_torch.ops import bitap as TB
from ahocorasick_tpu_torch.ops import bitap_kernels as TK
from ahocorasick_tpu_torch.ops import fingerprint as TF
from ahocorasick_tpu_torch.ops import fingerprint_kernels as FK
from ahocorasick_tpu_torch.ops import staged as TS
from ahocorasick_tpu_torch.ops import staged_kernels as SK
from test_torch_limb_sets import SETS as LIMB_GROUP_SETS
from test_torch_limb_sets import STAGED_SETS as STAGED_GROUP_SETS
from test_torch_limb_sets import limb_sets

pytestmark = pytest.mark.cuda

NAMES = [b"Sherlock Holmes", b"John Watson", b"Irene Adler",
         b"Inspector Lestrade", b"Professor Moriarty"]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _hay(n, seed, pats):
    rng = np.random.default_rng(seed)
    buf = bytearray(rng.integers(32, 127, n, dtype=np.uint8).tobytes())
    for i, pos in enumerate(rng.integers(0, max(n - 64, 1), 50)):
        p = pats[i % len(pats)]
        buf[pos:pos + len(p)] = p
    return bytes(buf)


SETS = {
    "names": NAMES,
    "no_pad_byte": [bytes(range(8 * i, 8 * i + 8)) for i in range(32)],
    "k65": [bytes([i]) + b"ab" for i in range(92)],
    "k229": [bytes([i]) + b"ab" for i in range(256)],
}


@pytest.mark.parametrize("extract", [False, True])
@pytest.mark.parametrize("name", list(SETS))
def test_generic_kernel_equals_plain(dev, name, extract):
    eng = TB.BitapEngine(SETS[name], False, dev)
    hay = _hay(300_000, 1, SETS[name])
    ph = eng.prepare(hay, baked=False)
    lo, hi, sm, em = eng._args()
    n = len(hay)
    got = TK.bitap_scan_generic(lo, hi, sm, em, ph.halo_a, ph.body, 37, n,
                                extract)
    want = TK.bitap_scan_generic_plain(lo, hi, sm, em, ph.halo_a, ph.body,
                                       37, n, extract)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        if w is not None:
            assert torch.equal(g, w)


@pytest.mark.parametrize("extract", [False, True])
def test_baked_kernel_equals_plain(dev, extract):
    eng = TB.BitapEngine(NAMES, False, dev)
    hay = _hay(1 << 20, 2, NAMES)
    ph = eng.prepare(hay)
    assert ph.baked
    lo, hi, sm, em = eng._args()
    el = eng.tables.end_limbs
    got = TK.bitap_scan_baked(lo, hi, sm, em, el, ph.halo_a, ph.body,
                              extract)
    want = TK.bitap_scan_baked_plain(lo, hi, sm, em, el, ph.halo_a, ph.body,
                                     extract)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        if w is not None:
            assert torch.equal(g, w)


def test_facade_goes_through_kernels(dev):
    hay = _hay(1 << 20, 3, NAMES)
    ac = AhoCorasick([p.decode() for p in NAMES], device=dev)
    truth = AhoCorasick([p.decode() for p in NAMES], device="cpu",
                        engine="oracle")
    TK.reset_counts()
    assert ac.count_matches(hay) == truth.count_matches(hay)
    assert TK.baked_launches == 1 and TK.generic_launches == 0
    # At 594,915 bytes the count takes G1; find_iter, as in the JAX
    # facade, the fingerprint engine's fused extract (G5).
    small = hay[:594_915]
    assert ac.count_matches(small) == truth.count_matches(small)
    assert TK.generic_launches == 1
    FK.reset_counts()
    assert [m.astuple() for m in ac.find_iter(small)] == [
        m.astuple() for m in truth.find_iter(small)]
    assert TK.generic_launches == 1 and FK.generic_launches == 1


def _same(got, want):
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        if w is not None:
            assert torch.equal(g, w)


def _dictionary(seed, count=600):
    rng = np.random.default_rng(seed)
    pats = set()
    while len(pats) < count:
        ln = int(rng.integers(4, 13))
        pats.add(rng.integers(97, 123, ln, dtype=np.uint8).tobytes())
    return sorted(pats)


STAGED_SETS = {
    "names": NAMES,
    # K = 5 limbs: the 8-limb register bucket with three inert limbs.
    "k5": NAMES + [b"Mycroft Holmes", b"Mrs Hudson", b"Mary Morstan",
                   b"Colonel Moran", b"Baker Street"],
    # K = 107 limbs for the full set, 105 for the prefixes: once the spill
    # path, now limb groups of 4 lanes.
    "spill": STAGED_GROUP_SETS["spill"],
}


def _staged_case(dev, name, n):
    pats = STAGED_SETS[name]
    eng = TS.StagedEngine(pats, False, dev)
    hay = bytearray(_hay(n, 4, pats))
    hay[:len(pats[0])] = pats[0]
    return eng, eng.prepare(bytes(hay)), len(hay)


@pytest.mark.parametrize("name", list(STAGED_SETS))
def test_staged_kernels_equal_plain(dev, name):
    """G3 over the whole upload; G4 over the candidates' rows, with pad
    lanes (-1) and stream 0 among them, count and extract, over the whole
    haystack and over a window whose both ends fall inside segments; both
    kernels with P > 1 segments per stream."""
    eng, ph, n = _staged_case(dev, name, 3 << 20)
    (flo, fhi, fsm, fem), (lo, hi, sm, em) = eng._args()
    if name == "k5":
        assert eng.full.k == 5
    if name == "spill":
        assert eng.full.k > 64 and eng.fp.k > 64
    fargs = (flo, fhi, fsm, fem, ph.rows, eng.halo)
    _same([SK.staged_flags(*fargs)], [SK.staged_flags_plain(*fargs)])
    assert SK.flags_plan[1] > 1
    assert (SK.flags_plan[3] > 1) == (name == "spill")
    ncand, cand = eng.candidates(ph, 4096)
    assert 0 < ncand < 4096 and int(cand[0]) == 0
    sid = cand.to(torch.int32).reshape(-1, 8, 128)
    for extract in (False, True):
        for n0, n1 in ((0, n), (37, n - 45)):
            args = (lo, hi, sm, em, eng.full.end_limbs, sid, ph.rows,
                    eng.halo, n0, n1, extract)
            _same(SK.staged_gathered(*args), SK.staged_gathered_plain(*args))
            _, P, Ls, G = SK.gathered_plan
            assert P > 1 and (G > 1) == (name == "spill")
            if n0:
                assert n0 % Ls and (n1 % ph.L) % Ls


@pytest.mark.parametrize("n", [300_000, 4 << 20], ids=["one_tile", "4MiB"])
def test_staged_flags_shapes(dev, n):
    """G3 over one tile of streams (the plan's finest split) and over the
    4 MiB of the smallest staged count."""
    eng, ph, _ = _staged_case(dev, "names", n)
    assert (ph.tiles == 1) == (n < 1 << 20)
    fargs = eng._args()[0] + (ph.rows, eng.halo)
    _same([SK.staged_flags(*fargs)], [SK.staged_flags_plain(*fargs)])
    threads, P, Ls, G = SK.flags_plan
    assert P > 1 and G == 1 and threads == ph.tiles * 1024 * P
    assert Ls >= eng.halo


@pytest.mark.parametrize("baked", [False, True], ids=["G5", "G6"])
def test_fp_bitmap_kernel_equals_plain(dev, baked):
    pats = _dictionary(5)
    eng = TF.FingerprintEngine(pats, True, dev)
    hay = _hay(2 << 20, 5, pats)
    ph = eng.prepare(hay)
    assert ph.baked
    lo, hi, sm, em = eng._args()
    if baked:
        got = FK.fp_bitmap_baked(lo, hi, sm, em, ph.halo_a, ph.body)
        want = FK.fp_bitmap_plain(lo, hi, sm, em, ph.halo_a, ph.body, None)
    else:
        got = FK.fp_bitmap_generic(lo, hi, sm, em, ph.halo_a, ph.body, 9,
                                   len(hay) - 9)
        want = FK.fp_bitmap_plain(lo, hi, sm, em, ph.halo_a, ph.body,
                                  (9, len(hay) - 9))
    _same(got, want)


def _counts():
    return (TK.generic_launches, TK.baked_launches, SK.flags_launches,
            SK.gathered_launches, FK.generic_launches, FK.baked_launches)


def _reset():
    TK.reset_counts()
    SK.reset_counts()
    FK.reset_counts()


def test_facade_staged_and_fingerprint_routes(dev):
    """The routes of the JAX facade: a 4 MiB count goes staged (G3, G4),
    a 2 MiB extraction to the fingerprint engine (G6), a 300 KB
    extraction to it too (G5), each equal to the oracle walk."""
    strs = [p.decode() for p in NAMES]
    ac = AhoCorasick(strs, device=dev)
    truth = AhoCorasick(strs, device="cpu", engine="oracle")
    hay = _hay(TS.STAGED_MIN, 6, NAMES)
    _reset()
    assert ac.count_matches(hay) == truth.count_matches(hay)
    assert _counts() == (0, 0, 1, 1, 0, 0)
    for n, kernel in ((2 << 20, 5), (300_000, 4)):
        _reset()
        assert [m.astuple() for m in ac.find_overlapping_iter(hay[:n])] == [
            m.astuple() for m in truth.find_overlapping_iter(hay[:n])]
        assert [c > 0 for c in _counts()] == [i == kernel for i in range(6)]
    pats = _dictionary(6)
    big = AhoCorasick(pats, device=dev, ascii_case_insensitive=True)
    dtruth = AhoCorasick(pats, device="cpu", engine="oracle",
                         ascii_case_insensitive=True)
    h = _hay(1 << 20, 7, pats)
    _reset()
    assert big.count_matches(h) == dtruth.count_matches(h)
    assert [c > 0 for c in _counts()] == [False] * 5 + [True]


# ---------------------------------------------------------------------------
# The segment plan of G1/G2/G5/G6 at shapes that stress it
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("extract", [False, True])
def test_one_tile_most_segments(dev, extract):
    """G2 over one tile of 2048-byte streams, where the plan is finest
    (P = 64 segments of H = 32 bytes); the haystack and so the extracted
    range end 28 bytes into a segment."""
    eng = TB.BitapEngine(NAMES, False, dev)
    hay = _hay((2 << 20) - 100, 8, NAMES)
    ph = eng.prepare(hay)
    assert ph.baked and ph.tiles == 1
    args = eng._args()[:4] + (eng.tables.end_limbs, ph.halo_a, ph.body,
                              extract)
    _same(TK.bitap_scan_baked(*args), TK.bitap_scan_baked_plain(*args))
    threads, P, Ls, _ = TK.baked_plan
    assert (P, Ls) == (64, 32) and threads == 64 * 1024 and len(hay) % Ls


def test_one_tile_bitmap_most_segments(dev):
    """G5 over one tile of a 600-entry dictionary at 512 KiB."""
    pats = _dictionary(9)
    eng = TF.FingerprintEngine(pats, True, dev)
    hay = _hay(512 * 1024, 9, pats)
    ph = eng.prepare(hay)
    assert ph.tiles == 1
    args = eng._args() + (ph.halo_a, ph.body)
    _same(FK.fp_bitmap_generic(*args, 0, len(hay)),
          FK.fp_bitmap_plain(*args, (0, len(hay))))
    assert FK.generic_plan[1] > 1


@pytest.mark.parametrize("extract", [False, True])
def test_window_ends_mid_segment(dev, extract):
    """G1 and G5 with a window [n0, n) whose both ends fall inside
    segments."""
    eng = TB.BitapEngine(NAMES, False, dev)
    hay = _hay(300_000, 10, NAMES)
    ph = eng.prepare(hay, baked=False)
    n0, n = 5, len(hay) - 11
    args = eng._args() + (ph.halo_a, ph.body, n0, n, extract)
    _same(TK.bitap_scan_generic(*args), TK.bitap_scan_generic_plain(*args))
    _, P, Ls, _ = TK.generic_plan
    assert P > 1 and (n % ph.L) % Ls and n0 % Ls
    fp = TF.FingerprintEngine(NAMES, False, dev)
    fph = fp.prepare(hay)
    fargs = fp._args() + (fph.halo_a, fph.body)
    _same(FK.fp_bitmap_generic(*fargs, n0, n),
          FK.fp_bitmap_plain(*fargs, (n0, n)))
    _, P, Ls = FK.generic_plan
    assert P > 1 and (n % fph.L) % Ls


def test_spill_path_with_segments(dev):
    """K = 229 limbs (once the global-scratch path, now limb groups of 8
    lanes) at 1 MiB, P > 1: counts and end words equal the plain
    version."""
    pats = SETS["k229"]
    eng = TB.BitapEngine(pats, False, dev)
    assert eng.tables.k == 229
    hay = _hay(1 << 20, 11, pats)
    ph = eng.prepare(hay, baked=False)
    for extract in (False, True):
        args = eng._args() + (ph.halo_a, ph.body, 0, len(hay), extract)
        _same(TK.bitap_scan_generic(*args),
              TK.bitap_scan_generic_plain(*args))
        assert TK.generic_plan[1] > 1


# ---------------------------------------------------------------------------
# Limb groups: G1/G2 beyond 64 limbs
# ---------------------------------------------------------------------------
# K of each set: every group size (4, 8, 16 lanes of 32 limbs, 32 of 64).
LIMB_SETS = limb_sets()


def _limb_case(dev, pats, args, n, extract, kernel, seed):
    """Run G1 (window [7, n - 5)) or G2 through the wrapper and its plain
    version on one haystack; returns the plan the wrapper recorded."""
    eng = TB.BitapEngine(pats, False, dev)
    hay = _hay(n, seed, pats)
    ph = eng.prepare(hay, baked=False)
    lo, hi, sm, em = args if args is not None else eng._args()
    if kernel == "G1":
        a = (lo, hi, sm, em, ph.halo_a, ph.body, 7, n - 5, extract)
        _same(TK.bitap_scan_generic(*a), TK.bitap_scan_generic_plain(*a))
        plan = TK.generic_plan
    else:
        ends = [k for k in range(lo.shape[0]) if int(em[k]) != 0]
        a = (lo, hi, sm, em, ends, ph.halo_a, ph.body, extract)
        _same(TK.bitap_scan_baked(*a), TK.bitap_scan_baked_plain(*a))
        plan = TK.baked_plan
    threads, P, Ls, G = plan
    K = lo.shape[0]
    assert G == TK.limb_group(K)[0] > 1
    assert threads == ph.tiles * 1024 * P * G
    if kernel == "G1" and P > 1:
        assert ((n - 5) % ph.L) % Ls  # the window ends inside a segment
    return plan


@pytest.mark.parametrize("extract", [False, True])
@pytest.mark.parametrize("kernel", ["G1", "G2"])
@pytest.mark.parametrize("K", list(LIMB_SETS))
def test_limb_groups_equal_plain(dev, K, kernel, extract):
    """G1 and G2, count and extract, at K = 65 .. 1,121 against their plain
    versions; extraction over 64 KiB (its words are 4K bytes per byte),
    counts over 1 MiB, where the plan has P > 1."""
    pats = LIMB_SETS[K]
    assert TB.BitapTables(pats, False).k == K
    n = (64 << 10) if extract else (1 << 20)
    _, P, _, _ = _limb_case(dev, pats, None, n, extract, kernel, K)
    assert P > 1


@pytest.mark.parametrize("kernel", ["G1", "G2"])
def test_limb_groups_tables_in_device_memory(dev, kernel):
    """Past 1,728 limbs the group's tables do not fit in shared memory and
    the lanes read them from device memory, padded to whole slices: the
    tables of the 229-limb set repeated 8 times (K = 1,832), and 22 chains
    of 65 bytes that cross lane boundaries repeated 31 times (K = 2,046).
    Unpadded tables are refused."""
    for pats, reps, n in ((SETS["k229"], 8, 64 << 10),
                          (LIMB_GROUP_SETS["lane_carry"], 31, 128 << 10)):
        eng = TB.BitapEngine(pats, False, dev)
        lo, hi, sm, em = (t.repeat(reps, *([1] * (t.dim() - 1)))
                          for t in eng._args())
        K = lo.shape[0]
        assert not TK.group_tables_shared(K, *TK.limb_group(K))
        with pytest.raises(ValueError, match="allocated"):
            _limb_case(dev, pats, (lo, hi, sm, em), n, False, kernel, reps)
        args = (*TK.padded_tables(lo, hi), sm, em)
        for extract in (False, True):
            _limb_case(dev, pats, args, n, extract, kernel, reps)


@pytest.mark.parametrize("kernel", ["G1", "G2"])
@pytest.mark.parametrize("K", [461, 1121])
def test_limb_groups_in_waves(dev, K, kernel):
    """One segment per stream in several waves: S * G past the card's
    resident thread slots (as the 64 MiB counts at K = 229 reach), counts
    of 128-byte streams against the plain version, G1 with a window
    ending inside the last stream."""
    pats = LIMB_SETS[K]
    eng = TB.BitapEngine(pats, False, dev)
    G, KR = TK.limb_group(K)
    tiles = TK.resident_threads(dev) // (1024 * G) + 1
    L = 128
    n = tiles * 1024 * L - 9
    hay = _hay(n, K, pats)
    pad = (eng.tables.pad_byte or 0) if kernel == "G2" else 0
    x32 = torch.from_numpy(eng._pack(hay, L, tiles, pad=pad))
    halo, body = TB._to_stream_major(x32.to(dev), L, tiles, eng.halo)
    assert TK.scan_plan(L, eng.halo, tiles * 1024, K,
                        TK.resident_threads(dev))[:3] == (1, L, G)
    lo, hi, sm, em = eng._args()
    if kernel == "G1":
        a = (lo, hi, sm, em, halo, body, 0, n, False)
        _same(TK.bitap_scan_generic(*a), TK.bitap_scan_generic_plain(*a))
        plan = TK.generic_plan
    else:
        a = (lo, hi, sm, em, eng.tables.end_limbs, halo, body, False)
        _same(TK.bitap_scan_baked(*a), TK.bitap_scan_baked_plain(*a))
        plan = TK.baked_plan
    assert plan == (tiles * 1024 * G, 1, L, G)
    assert plan[0] > TK.resident_threads(dev)


def test_limb_group_carry_between_lanes(dev):
    """22 chains of 65 bytes (three limbs each): the chain on limbs 30-32
    carries from lane 0 into lane 1 of its group, G1 and G2."""
    pats = LIMB_GROUP_SETS["lane_carry"]
    for kernel in ("G1", "G2"):
        for extract in (False, True):
            _limb_case(dev, pats, None, 1 << 20, extract, kernel, 5)


def test_facade_count_at_103_limbs(dev):
    """The count a user's call takes with the 128-word set (K = 103, pad
    byte 0, no staged route): one G2 launch at 2 MiB, one G1 launch at
    600 KB, each equal to the native walk's count."""
    pats = LIMB_SETS[103]
    ac = AhoCorasick(pats, device=dev)
    truth = AhoCorasick(pats, device="cpu", engine="oracle")
    for n, g1, g2 in ((2 << 20, 0, 1), (600_000, 1, 0)):
        hay = _hay(n, 14, pats)
        TK.reset_counts()
        assert ac.count_matches(hay) == truth.count_matches(hay)
        assert (TK.generic_launches, TK.baked_launches) == (g1, g2)


@pytest.mark.parametrize("extract", [False, True])
def test_padded_limbs(dev, extract):
    """K between the register buckets: five more names give K = 5, run in
    the 8-limb bucket with three inert limbs (G1 and G2), and a 600-entry
    dictionary gives K = 7 (G6)."""
    pats = NAMES + [b"Mycroft Holmes", b"Mrs Hudson", b"Mary Morstan",
                    b"Colonel Moran", b"Baker Street"]
    eng = TB.BitapEngine(pats, False, dev)
    assert eng.tables.k == 5
    hay = _hay(1 << 20, 12, pats)
    lo, hi, sm, em = eng._args()
    ph = eng.prepare(hay, baked=False)
    args = (lo, hi, sm, em, ph.halo_a, ph.body, 3, len(hay) - 5, extract)
    _same(TK.bitap_scan_generic(*args), TK.bitap_scan_generic_plain(*args))
    ph = eng.prepare(hay)
    assert ph.baked
    args = (lo, hi, sm, em, eng.tables.end_limbs, ph.halo_a, ph.body,
            extract)
    _same(TK.bitap_scan_baked(*args), TK.bitap_scan_baked_plain(*args))
    fp = TF.FingerprintEngine(_dictionary(9), True, dev)
    assert fp.tables.k == 7
    fph = fp.prepare(_hay(1 << 20, 13, _dictionary(9)))
    assert fph.baked
    fargs = fp._args() + (fph.halo_a, fph.body)
    _same(FK.fp_bitmap_baked(*fargs), FK.fp_bitmap_plain(*fargs, None))



# ---------------------------------------------------------------------------
# Limb groups: G3/G4 beyond 64 limbs
# ---------------------------------------------------------------------------
# (patterns, table repeats) of each case: the 100 words on the facade's own
# rows (G = 4: Kf = 75, K = 83), then tables passed straight to the
# wrappers over rows of random words: k229 (G = 8), k461 (G = 16), k1121
# (G = 32 lanes of 64 limbs), and tables repeated past what shared memory
# holds (K = 1,832 and 2,046), which the lanes read from device memory.
STAGED_GROUP_CASES = {
    "w100": (STAGED_GROUP_SETS["w100"], 1),
    "k229": (LIMB_GROUP_SETS["k229"], 1),
    "k461": (LIMB_GROUP_SETS["k461"], 1),
    "k1121": (LIMB_GROUP_SETS["k1121"], 1),
    "k229x8": (LIMB_GROUP_SETS["k229"], 8),
    "lane_carry_x31": (LIMB_GROUP_SETS["lane_carry"], 31),
}


def _staged_group_rows(dev, pats, ns, L, seed):
    """Rows [ns, L/4] of random bytes that fill the buffer, a pattern
    every 400 bytes, the longest one across the wrap from the buffer's end
    into stream 0 and one inside stream 0."""
    n = ns * L
    buf = bytearray(_hay(n, seed, pats))
    rng = np.random.default_rng(seed)
    for i, pos in enumerate(rng.integers(64, n - 100, n // 400)):
        p = pats[i % len(pats)]
        buf[pos:pos + len(p)] = p
    p = max(pats, key=len)
    k = len(p) // 2
    buf[n - k:n] = p[:k]
    buf[:len(p) - k] = p[k:]
    buf[40:40 + len(pats[1])] = pats[1]
    x = torch.from_numpy(np.frombuffer(bytes(buf), np.int32).copy())
    return x.reshape(ns, L // 4).to(dev)


def _staged_sid(dev, ns, lanes, live, seed):
    """Candidate ids [lanes/1024, 8, 128]: stream 0, live - 1 other streams
    (with repeats where live > ns) and pad lanes (-1) after them, so one
    warp holds live and pad lanes and the last warps pad lanes only."""
    rng = np.random.default_rng(seed)
    sid = np.full(lanes, -1, np.int32)
    sid[0] = 0
    sid[1:live] = np.sort(rng.integers(1, ns, live - 1))
    return torch.from_numpy(sid).reshape(-1, 8, 128).to(dev)


def _staged_group_launches(dev, tabs, end_limbs, rows, H, sid):
    """G3 over the rows and G4 over the candidates (count and extract, the
    whole buffer and a window whose ends fall inside segments), each
    against its plain version; returns the two plans."""
    ftab, tab = tabs
    fargs = (*ftab, rows, H)
    _same([SK.staged_flags(*fargs)], [SK.staged_flags_plain(*fargs)])
    fplan = SK.flags_plan
    n = 4 * rows.numel()
    for extract in (False, True):
        for n0, n1 in ((0, n), (37, n - 45)):
            a = (*tab, end_limbs, sid, rows, H, n0, n1, extract)
            _same(SK.staged_gathered(*a), SK.staged_gathered_plain(*a))
            _, P, Ls, _ = SK.gathered_plan
            if n0 and P > 1:
                assert n0 % Ls and n1 % Ls
    return fplan, SK.gathered_plan


def _group_check(plan, K, S, resident):
    threads, P, Ls, G = plan
    G_, KR = TK.limb_group(K)
    assert G == G_ > 1 and threads == S * P * G
    assert P > 1 or S * G > resident


@pytest.mark.parametrize("name", list(STAGED_GROUP_CASES))
def test_staged_limb_groups_equal_plain(dev, name):
    """G3 and G4 beyond 64 limbs at every group size, G = 4, 8, 16 and 32
    (of 64 limbs), and with their tables in device memory, against their
    plain versions: stream 0 among the candidates (with a match across the
    wrap into it), pad lanes in a warp with live ones, warps of pad lanes
    only, windows ending inside segments. Unpadded tables past shared
    memory are refused."""
    pats, reps = STAGED_GROUP_CASES[name]
    res = TK.resident_threads(dev)
    if name == "w100":
        eng = TS.StagedEngine(pats, False, dev)
        hay = bytearray(_hay(4 << 20, 20, pats))
        hay[:len(pats[0])] = pats[0]
        ph = eng.prepare(bytes(hay))
        rows, H, tabs, el = ph.rows, eng.halo, eng._args(), \
            eng.full.end_limbs
        assert (eng.fp.k, eng.full.k) == (75, 83)
        sid = _staged_sid(dev, rows.shape[0], 4096, 1203, 20)
    else:
        t = TB.BitapTables(pats, False)
        lo, hi, sm, em = (x.repeat(reps, *([1] * (x.dim() - 1)))
                          for x in t.device_tensors(dev))
        K = lo.shape[0]
        H = max(TB._pow2(max(t.max_pattern_len - 1, 1)), 4)
        rows = _staged_group_rows(dev, pats, 2048, 512, K)
        sid = _staged_sid(dev, 2048, 2048, 1203, K)
        el = [k for k in range(K) if int(em[k]) != 0]
        shared = TK.group_tables_shared(K, *TK.limb_group(K),
                                        SK._group_ring_bytes(
                                            TK.limb_group(K)[0]))
        assert shared == (reps == 1)
        if not shared:
            with pytest.raises(ValueError, match="allocated"):
                SK.staged_flags(lo, hi, sm, em, rows, H)
            lo, hi = TK.padded_tables(lo, hi)
        tabs = ((lo, hi, sm, em),) * 2
    flat = sid.reshape(-1)
    assert int(flat[0]) == 0 and int(flat[-1]) == -1
    fplan, gplan = _staged_group_launches(dev, tabs, el, rows, H, sid)
    _group_check(fplan, tabs[0][0].shape[0], rows.shape[0], res)
    _group_check(gplan, tabs[1][0].shape[0], flat.numel(), res)
    # One warp holds live and pad lanes (where a warp holds two streams or
    # more: G < 32).
    lanes = 32 // gplan[3]
    last = int((flat >= 0).sum()) - 1
    assert lanes == 1 or last // lanes == (last + 1) // lanes


@pytest.mark.parametrize("K", [461, 1121])
def test_staged_limb_groups_in_waves(dev, K):
    """One segment per stream in several waves: S * G past the card's
    resident thread slots, G3 over that many rows of 64 bytes and G4 over
    that many candidate lanes (repeated stream ids), against their plain
    versions."""
    pats = limb_sets()[K]
    t = TB.BitapTables(pats, False)
    tab = t.device_tensors(dev)
    G, KR = TK.limb_group(K)
    res = TK.resident_threads(dev)
    tiles = res // (1024 * G) + 1
    S = tiles * 1024
    rows = _staged_group_rows(dev, pats, S, 64, K)
    sid = _staged_sid(dev, S, S, S - 700, K)
    H = max(TB._pow2(max(t.max_pattern_len - 1, 1)), 4)
    fplan, gplan = _staged_group_launches(dev, (tab, tab), t.end_limbs,
                                          rows, H, sid)
    for plan in (fplan, gplan):
        assert plan == (S * G, 1, 64, G) and plan[0] > res


def test_facade_staged_count_of_100_words(dev):
    """The count a user's call takes with the 100 words at 4 MiB: staged,
    one G3 launch at Kf = 75 and one G4 launch at K = 83, both in limb
    groups of 4 lanes, equal to the native walk's count."""
    pats = STAGED_GROUP_SETS["w100"]
    ac = AhoCorasick(pats, device=dev)
    truth = AhoCorasick(pats, device="cpu", engine="oracle")
    hay = _hay(TS.STAGED_MIN, 21, pats)
    _reset()
    assert ac.count_matches(hay) == truth.count_matches(hay)
    assert _counts() == (0, 0, 1, 1, 0, 0)
    assert SK.flags_plan[3] == SK.gathered_plan[3] == 4


# ---------------------------------------------------------------------------
# The cascade engine's coarse pass (G5/G6) and the engine on the card
# ---------------------------------------------------------------------------
CASCADE_SETS = {
    # 5,000 names: a strong pad byte, so G6 at any size.
    "names5k": ("G6", lambda: _cascade_names(5000)),
    # Every nybble pair in use: no pad byte, G5 over the window (0, n).
    "no_pad": ("G5", lambda: [bytes(range(8 * i, 8 * i + 8))
                              for i in range(32)] + _cascade_names(300)),
}


def _cascade_names(count):
    """``count`` distinct names of 2-4 syllables."""
    syl = ("bar bel bor dan dar del dor fan far gar gor hal han har kar kel "
           "kor lan lor mar mor nal nar nor pal par ral ran rok sar").split()
    rng = np.random.default_rng(count)
    pats = set()
    while len(pats) < count:
        pats.add("".join(syl[int(i)] for i in rng.integers(
            0, len(syl), int(rng.integers(2, 5)))).encode())
    return sorted(pats)


@pytest.mark.parametrize("name", list(CASCADE_SETS))
def test_cascade_coarse_bitmap_equals_plain(dev, name):
    from ahocorasick_tpu_torch.ops import cascade as TC

    kernel, make = CASCADE_SETS[name]
    pats = make()
    eng = TC.CascadeEngine(pats, True, dev)
    ph = eng.prepare(_hay(1 << 20, 14, pats))
    assert ph.baked == (kernel == "G6")
    coarse = eng.tables.device_tensors(dev)["coarse"]
    FK.reset_counts()
    got = eng._bitmap(ph, coarse)
    assert (FK.baked_launches, FK.generic_launches) == (
        (1, 0) if kernel == "G6" else (0, 1))
    _same(got, FK.fp_bitmap_plain(*coarse, ph.halo_a, ph.body,
                                  None if kernel == "G6" else (0, ph.n)))


@pytest.mark.parametrize("name", list(CASCADE_SETS))
def test_cascade_engine_equals_its_cpu_run(dev, name):
    """The engine on the card (kernels, torch stages on CUDA tensors)
    against the same engine on the CPU (plain versions), counts, pairs
    and caps."""
    from ahocorasick_tpu_torch.ops import cascade as TC

    _, make = CASCADE_SETS[name]
    pats = make() + [b"x" * 70 + b"yz"]  # and the side engine
    hay = _hay(1 << 20, 15, pats)
    card, cpu = (TC.CascadeEngine(pats, False, d) for d in (dev, "cpu"))
    assert card.count_matches(hay) == cpu.count_matches(hay)
    got, want = card.match_pairs(hay), cpu.match_pairs(hay)
    assert len(want[0]) > 30
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert card.last_caps == cpu.last_caps and card.level == cpu.level



@pytest.mark.parametrize("force", [None, "teddy", "rabinkarp"])
def test_packed_searcher_equals_its_cpu_run(dev, force):
    """The packed searcher on the card against the same searcher on the
    CPU: the default engine (G1 at this size), Teddy and Rabin-Karp, and
    a set beyond the bit-parallel bounds (the fingerprint engine)."""
    from ahocorasick_tpu_torch.packed import Config

    def build(pats, d):
        c = Config().device(d)
        if force == "teddy":
            c.only_teddy(True)
        elif force == "rabinkarp":
            c.only_rabin_karp(True)
        return c.builder().extend(pats).build()

    names = _cascade_names(360)
    big = [b"-".join(names[i::120]) for i in range(120)]
    assert sum(len(p) for p in big) > 2048
    for pats in (NAMES, big):
        hay = _hay(300_000, 16, pats)
        TK.reset_counts()
        FK.reset_counts()
        card, cpu = build(pats, dev), build(pats, "cpu")
        got = [m.astuple() for m in card.find_iter(hay)]
        assert got == [m.astuple() for m in cpu.find_iter(hay)]
        assert len(got) > 20
        assert card.memory_usage() == cpu.memory_usage()
        if force is None:
            assert (TK.generic_launches if pats is NAMES
                    else FK.generic_launches) >= 1


def test_four_entry_mesh_equals_cpu_mesh(dev):
    """Every sharded function on a mesh of four entries of the card
    against the same call on four CPU entries, with the kernels each
    launched once per shard."""
    import io

    from ahocorasick_tpu_torch.ops import cascade as TC
    from ahocorasick_tpu_torch.parallel import shard as SH

    card, cpu = SH.Mesh([dev] * 4), SH.Mesh(["cpu"] * 4)
    on = ((card, dev), (cpu, "cpu"))

    def both(fn):
        a, b = fn(card), fn(cpu)
        if isinstance(a, tuple):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        else:
            assert a == b
        return a

    def reset():
        TK.reset_counts()
        SK.reset_counts()
        FK.reset_counts()
        return lambda: (TK.generic_launches, SK.flags_launches,
                        SK.gathered_launches, FK.generic_launches,
                        FK.baked_launches)

    hay = _hay(1 << 20, 17, NAMES)
    ac = {m: AhoCorasick(NAMES, device=d) for m, d in on}
    st = {m: TS.StagedEngine(NAMES, False, d) for m, d in on}
    launched = reset()
    assert both(lambda m: SH.sharded_bitap_count(
        ac[m]._bitap_engine(), hay, m)) > 40
    both(lambda m: SH.sharded_bitap_match_pairs(ac[m]._bitap_engine(),
                                                hay, m))
    both(lambda m: SH.sharded_staged_count(st[m], hay, m))
    assert launched() == (8, 4, 4, 0, 0)
    big = _cascade_names(300)
    hb = _hay(1 << 19, 18, big)
    fp = {m: TF.FingerprintEngine(big, False, d) for m, d in on}
    cpats = _cascade_names(3000)
    hc = _hay(1 << 19, 19, cpats)
    cas = {m: TC.CascadeEngine(cpats, False, d) for m, d in on}
    launched = reset()
    assert len(both(lambda m: SH.sharded_fp_match_pairs(fp[m], hb, m))[0])
    assert len(both(lambda m: SH.sharded_cascade_match_pairs(
        cas[m], hc, m))[0]) > 10
    assert launched() == (0, 0, 0, 4, 4)
    reps = [b"<%d>" % i for i in range(len(NAMES))]

    def replace(m):
        out = io.BytesIO()
        SH.sharded_stream_replace_all(ac[m], io.BytesIO(hay), out, reps,
                                      mesh=m, chunk_size=1 << 18)
        return out.getvalue()
    assert both(replace) == ac[cpu].try_replace_all_bytes(hay, reps)


# ---------------------------------------------------------------------------
# The candidate stages S1-S4 (csrc/candidates.cu)
# ---------------------------------------------------------------------------
def _flat(x):
    if not isinstance(x, tuple):
        return (x,)
    return tuple(y for z in x for y in _flat(z))


def _stage_same(got, want):
    """A stage kernel's outputs against its plain version's, bit for bit,
    unset (None) outputs included."""
    got, want = _flat(got), _flat(want)
    assert [g is None for g in got] == [w is None for w in want]
    _same(got, want)


@pytest.mark.parametrize("cands,cap", [(43_819, 65_536), (70_000, 65_536),
                                       (0, 512)])
def test_cand_select_equals_plain(dev, cands, cap):
    """S1 on the bitmap of a 64 MiB haystack (2M words, as the dict100k
    count gives it): every candidate in the cap, more than the cap, none;
    the first and the last position set where there are candidates."""
    from ahocorasick_tpu_torch.ops import candidate_kernels as CK

    tiles, L = 16, 4096
    n = tiles * 1024 * L
    rng = np.random.default_rng(cands)
    pos = rng.choice(n, cands, replace=False) if cands else np.zeros(0, int)
    if cands:
        pos[:2] = (0, n - 1)
    words = np.zeros(n // 32, np.uint32)
    # position p of stream s = p // L lies in word (tile, t32, row, col).
    s, t = pos // L, pos % L
    flat = (((s // 1024) * (L // 32) + t // 32) * 8 + (s // 128) % 8) * 128 \
        + s % 128
    np.bitwise_or.at(words, flat, (np.uint32(1) << (t % 32)).astype(
        np.uint32))
    bmp = torch.from_numpy(words.view(np.int32).reshape(
        tiles, L // 32, 8, 128)).to(dev)
    CK.reset_counts()
    got = CK.cand_select(bmp, L, cap)
    assert CK.select_launches == 1
    want = CK.cand_select_plain(bmp, L, cap)
    _stage_same(got, want)
    assert int(got[0]) == cands
    if 0 < cands <= cap:
        assert set(got[1][:cands].tolist()) == set(pos.tolist())


def _dict_text(pats, n, seed, density=0.2):
    """n bytes of words separated by spaces: a pattern with probability
    ``density``, else 3-7 random lowercase letters."""
    rng = np.random.default_rng(seed)
    out, size = [], 0
    while size < n:
        if rng.random() < density:
            w = pats[int(rng.integers(len(pats)))]
        else:
            w = rng.integers(97, 123, int(rng.integers(3, 8)),
                             dtype=np.uint8).tobytes()
        out.append(w)
        size += len(w) + 1
    return b" ".join(out)[:n]


def _fp_stage_inputs(dev, pats, ci, n, seed):
    eng = TF.FingerprintEngine(pats, ci, dev)
    assert eng.dv is not None
    hay = _dict_text(pats, n, seed)
    ph = eng.prepare(hay)
    _, bmp = eng.bitmap(ph)
    return eng, ph, bmp


@pytest.mark.parametrize("name", ["names1k", "groups16"])
def test_fp_verify_equals_plain(dev, name):
    """S2 after S1 on a fingerprint engine's 1 MiB bitmap, count and
    extract modes: a case-insensitive 1,000-name set, and one with a
    fingerprint group of GMAX_CAP = 16 patterns."""
    from ahocorasick_tpu_torch.ops import candidate_kernels as CK

    if name == "names1k":
        pats, ci = _cascade_names(1000), True
    else:
        pats = _cascade_names(200) + [b"barbelfa" + b"xyzw"[:1 + k % 4] * (
            1 + k // 4) for k in range(16)]
        pats, ci = sorted(set(pats)), False
    eng, ph, bmp = _fp_stage_inputs(dev, pats, ci, 1 << 20, 20)
    if name == "groups16":
        assert max(g for _, _, g in eng.dv.key()[1]) == TF.GMAX_CAP
    ncand, e_pos, live = CK.cand_select(bmp, ph.L, 1 << 17)
    assert 0 < int(ncand) <= 1 << 17
    tabs = eng.dv.device_tables(dev)
    for extract in (False, True):
        a = (ph.u8f, e_pos, live, ph.n, tabs, eng.dv.W, extract)
        CK.reset_counts()
        got = CK.fp_verify(*a)
        assert CK.verify_launches == 1
        _stage_same(got, CK.fp_verify_plain(*a))


def test_cascade_probe_and_long_verify_equal_plain(dev):
    """S3 and S4 after S1 on a cascade engine's 1 MiB bitmap (5,000 names,
    all-0xFF patterns and windows, a LONG class), count and extract modes,
    S4 with a cap that holds every expansion row and one that does not."""
    from ahocorasick_tpu_torch.ops import candidate_kernels as CK
    from ahocorasick_tpu_torch.ops import cascade as TC

    pats = _cascade_names(5000) + [b"\xff" * 4, b"\xff" * 8, b"\xff" * 12]
    eng = TC.CascadeEngine(pats, True, dev)
    hay = _dict_text(pats, 1 << 20, 21) + b"\xff" * 40
    ph = eng.prepare(hay)
    t = eng.tables
    assert TC.LONG in t.classes
    dv = t.device_tensors(dev)
    _, bmp = eng._bitmap(ph, dv["coarse"])
    ncand, e_pos, live = CK.cand_select(bmp, ph.L, 1 << 17)
    assert 0 < int(ncand) <= 1 << 17
    for extract in (False, True):
        a = (ph.u8f, e_pos, live, ph.n, dv["classes"], t.q, t.W, extract)
        CK.reset_counts()
        got = CK.cascade_probe(*a)
        assert CK.probe_launches == 1
        _stage_same(got, CK.cascade_probe_plain(*a))
        rows = int(got[4][0].sum())
        assert rows > 100
        for cap_e in (1 << 17, rows // 2):
            b = (*got[4], e_pos, ph.u8f, dv["pidarr"], dv["pv"], ph.n, cap_e,
                 t.tail_w0, t.W, extract)
            got4 = CK.cascade_long_verify(*b)
            _stage_same(got4, CK.cascade_long_verify_plain(*b))
            assert int(got4[4]) == rows


@pytest.mark.parametrize("kind", ["dict1k", "dict100k"])
def test_facade_dictionaries_equal_cpu_runs(dev, kind):
    """The facade's count and extraction of a 1,000-name dictionary (the
    fingerprint engine: G6, S1, S2) and of 100,000 names (the cascade: G6,
    S1, S3, S4) over 2 MiB of text with the names at rate 0.01, against
    the same facade on the CPU; once the first call has settled the caps,
    a count is one pass: one launch of each stage kernel."""
    from ahocorasick_tpu_torch.ops import candidate_kernels as CK

    pats = _cascade_names(1000 if kind == "dict1k" else 100_000)
    hay = _dict_text(pats, 2 << 20, 22, 0.01)
    card, cpu = (AhoCorasick(pats, ascii_case_insensitive=True, device=d)
                 for d in (dev, "cpu"))
    assert card.count_matches(hay) == cpu.count_matches(hay)
    CK.reset_counts()
    assert card.count_matches(hay) == cpu.count_matches(hay)
    stages = (CK.select_launches, CK.verify_launches, CK.probe_launches,
              CK.long_launches)
    assert stages == ((1, 1, 0, 0) if kind == "dict1k" else (1, 0, 1, 1))
    got = [m.astuple() for m in card.find_overlapping_iter(hay)]
    assert got == [m.astuple() for m in cpu.find_overlapping_iter(hay)]
    assert len(got) > 1000


def test_sharded_filters_launch_the_candidate_kernels(dev):
    """On a mesh of four entries of the card the sharded fingerprint search
    selects each shard's candidates with S1 (its verify stays on the
    host), and the sharded cascade runs S1, S3 and S4 per shard; both equal
    the same call on four CPU entries."""
    from ahocorasick_tpu_torch.ops import candidate_kernels as CK
    from ahocorasick_tpu_torch.ops import cascade as TC
    from ahocorasick_tpu_torch.parallel import shard as SH

    card, cpu = SH.Mesh([dev] * 4), SH.Mesh(["cpu"] * 4)
    big = _cascade_names(300)
    hb = _hay(1 << 19, 18, big)
    cpats = _cascade_names(3000)
    hc = _hay(1 << 19, 19, cpats)
    for make, pats, hay, run, stages in (
            (TF.FingerprintEngine, big, hb, SH.sharded_fp_match_pairs,
             (1, 0, 0, 0)),
            (TC.CascadeEngine, cpats, hc, SH.sharded_cascade_match_pairs,
             (1, 0, 1, 1))):
        want = run(make(pats, False, "cpu"), hay, cpu)
        eng = make(pats, False, dev)
        CK.reset_counts()
        got = run(eng, hay, card)
        launched = (CK.select_launches, CK.verify_launches,
                    CK.probe_launches, CK.long_launches)
        # One launch per shard and pass, the same number of passes each.
        assert all((v > 0 and v % 4 == 0) == bool(s)
                   for v, s in zip(launched, stages)), launched
        assert len(got[0]) > 10
        for x, y in zip(got, want):
            np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# The blocked DFA walk W1/W2 (csrc/dfa_walk.cu)
# ---------------------------------------------------------------------------
def _walk_case(dev, name):
    """(device automaton, the walk's arguments on the JAX layout, n) of a
    walk case: the five names (a table that fits shared memory), 600
    names (one that does not), and a 200-byte pattern over b"a" that
    fills its bucket (a halo longer than a block, R7)."""
    from ahocorasick_tpu_torch.ops import block_scan as TBS

    if name == "halo_over_block":
        pats, hay = [b"a" * 200, b"ab"], b"a" * (128 << 10)
    else:
        pats = NAMES if name == "names" else _cascade_names(600)
        hay = _hay(1 << 20, 21, pats)
    da = TBS.DeviceAutomaton(AhoCorasick(pats, device="cpu")._dfa, dev)
    buf, n, L, H = da._prepare(hay)
    return da, (da.trans_flat, da.classes, buf, da.alphabet_len, da.start_id,
                L, H), n


@pytest.mark.parametrize("name", ["names", "names600", "halo_over_block"])
def test_walk_kernels_equal_plain(dev, name):
    """W1 and W2 against their plain versions on the same CUDA tensors,
    with the table in shared memory (the five names, R7's set) or read
    from device memory (600 names), over the whole buffer and over
    windows."""
    from ahocorasick_tpu_torch.ops import walk_kernels as WK

    da, a, n = _walk_case(dev, name)
    shared = name != "names600"
    assert WK.table_in_shared(da.trans_flat) == shared
    WK.reset_counts()
    states = WK.walk_states(*a)
    assert torch.equal(states, WK.walk_states_plain(*a))
    assert WK.walk_shape[2:] == (WK.walk_plan(len(a[2]), a[6]), a[6], shared)
    for n0, n1 in ((0, n), (0, 0), (n // 3, n - n // 5), (n - 1, n)):
        got = WK.walk_count(*a, da.match_count, n0, n1)
        want = WK.walk_count_plain(*a, da.match_count, n0, n1)
        assert got.dtype == torch.int64 and int(got) == int(want)
    assert WK.count_shape[2:] == WK.walk_shape[2:]
    assert (WK.walk_launches, WK.count_launches) == (1, 4)


@pytest.mark.parametrize("name", ["names", "names600", "halo_over_block"])
def test_walk_kernels_on_the_jax_layout(dev, name):
    """W1 and W2 through their private launches on the JAX layout's
    blocks and on walk_plan's sub-blocks, with the table in each place it
    fits, against the plain versions, over the whole buffer and a
    window."""
    from ahocorasick_tpu_torch.ops import walk_kernels as WK

    da, a, n = _walk_case(dev, name)
    trans, classes, buf, A, start, L, H = a
    places = (True, False) if WK.table_in_shared(trans) else (False,)
    want = WK.walk_states_plain(*a)
    for sub in (L, WK.walk_plan(len(buf), H)):
        for shared in places:
            got = WK._states_on_card(trans, classes, buf, A, start, H, sub,
                                     shared)
            assert torch.equal(got, want), (sub, shared)
            assert WK.walk_shape[2:] == (sub, H, shared)
            for n0, n1 in ((0, n), (n // 3, n - n // 5)):
                c = WK._count_on_card(trans, classes, buf, A, start, H,
                                      da.match_count, n0, n1, sub, shared)
                assert int(c) == int(WK.walk_count_plain(
                    *a, da.match_count, n0, n1)), (sub, shared, n0, n1)


def test_dfa_scan_facade_runs_the_walk_kernels(dev, monkeypatch):
    """engine='dfa-scan' on the card: a count is one W2 launch, an
    extraction one W1 launch, neither runs a plain walk; both equal the
    same calls on the CPU."""
    from ahocorasick_tpu_torch.ops import walk_kernels as WK

    pats = _cascade_names(600)
    hay = _hay(3 << 20, 22, pats)
    card = AhoCorasick(pats, device=dev, engine="dfa-scan")
    cpu = AhoCorasick(pats, device="cpu", device_threshold=1 << 62)

    def refuse(*a):
        raise AssertionError("a plain walk ran on the card's path")
    monkeypatch.setattr(WK, "walk_states_plain", refuse)
    monkeypatch.setattr(WK, "walk_count_plain", refuse)
    WK.reset_counts()
    want = [m.astuple() for m in cpu.find_overlapping_iter(hay)]
    assert card.count_matches(hay) == len(want) > 40
    assert (WK.walk_launches, WK.count_launches) == (0, 1)
    assert [m.astuple() for m in card.find_overlapping_iter(hay)] == want
    assert (WK.walk_launches, WK.count_launches) == (1, 1)
    long = AhoCorasick([b"a" * 200, b"ab"], device=dev, engine="dfa-scan")
    assert long.count_matches(b"a" * (128 << 10)) == (128 << 10) - 199


def test_sharded_walk_count_launches_w2_per_shard(dev):
    """sharded_count_matches on a mesh of four entries of the card: one
    W2 launch per shard, equal to four CPU entries and to the facade."""
    from ahocorasick_tpu_torch.ops import walk_kernels as WK
    from ahocorasick_tpu_torch.parallel import shard as SH

    pats = _cascade_names(600)
    hay = _hay(1 << 20, 23, pats)
    card = AhoCorasick(pats, device=dev)._device_automaton()
    cpu = AhoCorasick(pats, device="cpu")
    WK.reset_counts()
    got = SH.sharded_count_matches(card, hay, SH.Mesh([dev] * 4))
    assert WK.count_launches == 4
    assert got == SH.sharded_count_matches(cpu._device_automaton(), hay,
                                           SH.Mesh(["cpu"] * 4))
    assert got == cpu.count_matches(hay) > 40


@pytest.mark.parametrize("op", ["find_iter", "count_matches"])
def test_tracing_on_the_card(dev, op):
    """The program's spans on the card: the same answers with tracing on,
    one record a call with its upload's bytes and its reads, and the
    spans' `ac.` ranges in a profile that records the device."""
    from torch.profiler import ProfilerActivity, profile

    from ahocorasick_tpu_torch.utils import log

    ac = AhoCorasick([b"Sherlock", b"Street"], device=dev)
    hay = _hay(1 << 20, 9, [b"Sherlock", b"Street"])

    def run():
        if op == "count_matches":
            return ac.count_matches(hay)
        return [m.astuple() for m in ac.find_iter(hay)]
    off = run()
    log.take()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        log.enable(ranges=True)
        try:
            on = run()
            torch.cuda.synchronize()
        finally:
            log.disable()
    (rec,) = log.take()
    assert on == off and off
    assert rec["#call"] == 1 and rec["h2d_bytes"] >= len(hay)
    assert rec["d2h_reads"] >= 1 and rec["passes"] >= 1
    names = {e.name for e in prof.events()}
    assert {"ac.call", "ac.prepare.upload", "ac.pass.read"} <= names
