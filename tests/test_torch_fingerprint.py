"""The port's fingerprint engine held against the JAX package's.

Same inputs, made from seeds with numpy, go through both packages: the
host tables (bucket plans, chain masks, pad bytes, the cuckoo verify
tables, the host verify index), the Pallas kernels G5
(`_make_fp_kernel`) and G6 (`_make_fp_baked_kernel`) in interpret mode
against the plain PyTorch versions of the port's Hopper kernels, the
candidate positions, the verify windows, the device verification and the
engines with their escalation and hostile guards. Every output is an
integer: the tolerance is exact equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ahocorasick_tpu.ops.fingerprint as JF
import ahocorasick_tpu_torch.ops.bitap as TB
import ahocorasick_tpu_torch.ops.fingerprint as TF
from ahocorasick_tpu_torch.ops import candidate_kernels as CK
from ahocorasick_tpu_torch.ops import fingerprint_kernels as FK
from ahocorasick_tpu_torch.ops.compaction import select_matches
from torch_suite import per_test_time_limit  # noqa: F401

NAMES = [b"Sherlock Holmes", b"John Watson", b"Irene Adler",
         b"Inspector Lestrade", b"Professor Moriarty"]


def _dictionary(rng, count, lmin=3, lmax=14, alphabet=b"abcdefgh"):
    pats = set()
    while len(pats) < count:
        ln = int(rng.integers(lmin, lmax + 1))
        pats.add(rng.choice(list(alphabet), ln).astype(np.uint8).tobytes())
    return sorted(pats)


def _text(rng, n, pats, density=0.01, alphabet=b"abcdefghijklmnop"):
    out, size = [], 0
    while size < n:
        if rng.random() < density:
            w = pats[int(rng.integers(len(pats)))]
        else:
            w = rng.choice(list(alphabet),
                           int(rng.integers(2, 9))).astype(np.uint8).tobytes()
        out.append(w)
        size += len(w)
    return b"".join(out)[:n]


def _set(name):
    """(patterns, case_insensitive, haystack)."""
    rng = np.random.default_rng(sum(name.encode()))
    if name == "dict150":
        pats = _dictionary(rng, 150)
        return pats, False, _text(rng, 1 << 15, pats)
    if name == "dict_ci":
        pats = _dictionary(rng, 300, 4, 12, b"abcdefghABCDEFGH")
        return pats, True, _text(rng, 1 << 15, pats, 0.02,
                                 b"abcdefghijABCDEFGHIJ")
    if name == "names":
        hay = _text(rng, 1 << 15, NAMES, 0.01,
                    b"abcdefghijklmnopqrstuvwxyz ")
        return NAMES, False, hay
    if name == "short_mixed":
        pats = [b"a", b"ab", b"abc", b"abcd", b"abcdefg", b"abcdefgh",
                b"abcdefghij"] + _dictionary(rng, 100, 2, 20)
        return pats, False, _text(rng, 1 << 14, pats, 0.05)
    raise KeyError(name)


SETS = ["dict150", "dict_ci", "names", "short_mixed"]


# ---------------------------------------------------------------------------
# Host tables
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", SETS)
def test_host_tables_equal(name):
    pats, ci, _ = _set(name)
    assert TF.strong_pad_byte(pats, ci) == JF.strong_pad_byte(pats, ci)
    for budget in TF.PLAN_LEVELS:
        assert TF.plan_buckets(pats, ci, budget) == \
            JF.plan_buckets(pats, ci, budget), budget
        if TF.plan_buckets(pats, ci, budget) is None:
            continue
        tt = TF.FingerprintTables(pats, ci, budget)
        jt = JF.FingerprintTables(pats, ci, budget)
        for f in ("k", "num_buckets", "max_chain", "pad_byte"):
            assert getattr(tt, f) == getattr(jt, f), f
        for f in ("lo", "hi", "start", "end"):
            np.testing.assert_array_equal(getattr(tt, f), getattr(jt, f))
    te, je = TF.FingerprintEngine(pats, ci, "cpu"), JF.FingerprintEngine(
        pats, ci)
    assert (te.level, te.tables.k, te.halo, te.pad_byte) == (
        je.level, je.tables.k, je.halo, je.pad_byte)
    tv, jv = te.verif, je.verif
    np.testing.assert_array_equal(tv.pid_rank, jv.pid_rank)
    np.testing.assert_array_equal(tv.tail_row, jv.tail_row)
    assert sorted(tv.classes) == sorted(jv.classes)
    for c in tv.classes:
        for a, b in zip(tv.classes[c], jv.classes[c]):
            np.testing.assert_array_equal(a, b)
    assert sorted(tv.tails) == sorted(jv.tails)
    for k in tv.tails:
        np.testing.assert_array_equal(tv.tails[k], jv.tails[k])
    assert (te.dv is None) == (je.dv is None)
    if te.dv is not None:
        _dv_equal(te.dv, je.dv)


def _dv_equal(tdv, jdv):
    """DeviceVerify tables: window, per class (mult, a, b, logT, tkeys,
    gmax, grow), the rng draws of seed 0xAC included."""
    assert tdv.W == jdv.W and tdv.key() == jdv.key()
    assert sorted(tdv.classes) == sorted(jdv.classes)
    for c in tdv.classes:
        tm, ta, tb, tl, ttk, tg, tgr = tdv.classes[c]
        jm, ja, jb, jl, jtk, jg, jgr = jdv.classes[c]
        assert (int(tm), int(ta), int(tb), tl, tg) == (
            int(jm), int(ja), int(jb), jl, jg), c
        np.testing.assert_array_equal(ttk, jtk)
        np.testing.assert_array_equal(tgr, jgr)


@pytest.mark.parametrize("ci", [False, True])
def test_device_verify_tables_equal_on_a_large_set(ci):
    """About 2,000 keys per class: several cuckoo retries' worth of draws."""
    rng = np.random.default_rng(41)
    pats = _dictionary(rng, 2500, 3, 12, bytes(range(97, 123)))
    _dv_equal(TF.DeviceVerify(pats, ci), JF.DeviceVerify(pats, ci))


def test_mul32_wraps_like_uint32():
    rng = np.random.default_rng(7)
    x = np.concatenate([rng.integers(0, 1 << 32, 1000, dtype=np.uint64),
                        np.array([0, 1, 0xFFFFFFFF], np.uint64)])
    for c in (1, 0xFFFFFFFF, 0x9E3779B1, int(rng.integers(1, 1 << 32))):
        want = (x.astype(np.uint32) * np.uint32(c)).astype(np.int64)
        got = CK.mul32(torch.from_numpy(x.astype(np.int64)), c)
        np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# Kernels: plain versions against the Pallas kernels
# ---------------------------------------------------------------------------
def _layouts(name):
    pats, ci, hay = _set(name)
    te = TF.FingerprintEngine(pats, ci, "cpu")
    je = JF.FingerprintEngine(pats, ci)
    ph = te.prepare(hay)
    jph = je.prepare(hay)
    np.testing.assert_array_equal(ph.halo_a.numpy(), np.asarray(jph.halo_a))
    np.testing.assert_array_equal(ph.body.numpy(), np.asarray(jph.body))
    assert (ph.L, ph.Lc, ph.tiles) == (jph.L, jph.Lc, jph.tiles)
    return te, je, ph, hay


def _jax_bitmap(je, ph, baked, nn):
    t = je.tables
    halo, body = jnp.asarray(ph.halo_a.numpy()), jnp.asarray(ph.body.numpy())
    if baked:
        kern = JF._make_fp_baked_kernel(*t.baked_key(), t.k, ph.Lc, je.halo)
        args = None
    else:
        kern = JF._make_fp_kernel(t.k, ph.L, ph.Lc, je.halo)
        args = (*t.device_args(), jnp.asarray(nn, jnp.int32))
    cnt, bmp = JF._fp_pallas(kern, args, halo, body, t.k, ph.L, ph.Lc,
                             ph.tiles, je.halo // 4)
    return np.asarray(cnt), np.asarray(bmp)


@pytest.mark.parametrize("name,baked", [
    ("dict150", False), ("dict_ci", True), ("names", False), ("names", True),
], ids=["dict150-G5", "dict_ci-G6", "names-G5", "names-G6"])
def test_bitmap_plain_equals_pallas(name, baked):
    te, je, ph, hay = _layouts(name)
    nn = (5, len(hay) - 3)
    want = _jax_bitmap(je, ph, baked, nn)
    lo, hi, sm, em = te._args()
    got = FK.fp_bitmap_plain(lo, hi, sm, em, ph.halo_a, ph.body,
                             None if baked else nn)
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    assert want[0].sum() > 10


@pytest.mark.parametrize("baked", [False, True], ids=["generic", "baked"])
def test_candidates_equal_jax(baked):
    """(ncand, e_pos, live) of `_fp_call` (at a cap that holds every
    candidate) and `_fp_baked_jit` (at one that overflows)."""
    te, je, ph, hay = _layouts("dict150")
    t = je.tables
    halo, body = jnp.asarray(ph.halo_a.numpy()), jnp.asarray(ph.body.numpy())
    lo, hi, sm, em = te._args()
    if baked:
        _, bmp = FK.fp_bitmap_plain(lo, hi, sm, em, ph.halo_a, ph.body, None)
    else:
        _, bmp = FK.fp_bitmap_plain(lo, hi, sm, em, ph.halo_a, ph.body,
                                    (0, len(hay)))
    for cap in ((64,) if baked else (4096,)):
        if baked:
            fn = JF._fp_baked_jit(t.baked_key(), t.k, ph.L, ph.Lc, je.halo,
                                  ph.tiles)
            jn, jpos, jlive = fn(halo, body, cap=cap)
        else:
            jn, jpos, jlive = JF._fp_call(
                *t.device_args(), halo, body,
                jnp.asarray([0, len(hay)], jnp.int32), K=t.k, L=ph.L,
                Lc=ph.Lc, H=je.halo, tiles=ph.tiles, cap=cap)
        n, pos, live = TF._rank_select(bmp, ph.L, cap)
        jlive = np.asarray(jlive)
        assert n == int(jn) > 64
        np.testing.assert_array_equal(live.numpy(), jlive)
        np.testing.assert_array_equal(pos.numpy()[jlive],
                                      np.asarray(jpos)[jlive])


@pytest.mark.parametrize("fold", [False, True])
def test_windows_equal_jax(fold):
    """[C, W] windows anchored at e_pos - (FP_LEN - 1), at live candidates
    and at the buffer's edges (first bytes, the haystack's end, the
    padding's end)."""
    te, je, ph, hay = _layouts("dict_ci")
    W = te.dv.W
    lo, hi, sm, em = te._args()
    _, bmp = FK.fp_bitmap_plain(lo, hi, sm, em, ph.halo_a, ph.body,
                                (0, len(hay)))
    _, pos, live = TF._rank_select(bmp, ph.L, 4096)
    total = ph.tiles * 1024 * ph.L
    e_pos = torch.cat([pos[live], torch.tensor(
        [0, 1, 7, 8, len(hay) - 1, len(hay), total - 1])])
    buf = TB.stage(hay, ph.tiles * TB.LANES * ph.L, te.pad_byte or 0,
                   "cpu").numpy()
    got = CK.gather_windows(TF._verify_buffer(torch.from_numpy(buf), W,
                                              fold), e_pos, W)
    want = JF._gather_windows(JF._unpack_fold(jnp.asarray(buf), W, fold),
                              jnp.asarray(e_pos.numpy(), jnp.int32), W)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("baked,extract", [(False, True), (True, True),
                                           (True, False)],
                         ids=["generic-extract", "baked-extract",
                              "baked-count"])
def test_device_verify_equals_fused_jits(baked, extract):
    """(ncand, total, out_pid, out_end) of `_fp_verified_jit` /
    `_fp_verified_generic_jit` against the port's bitmap, the candidate
    selection (S1), the device verify (S2) and the matches' compaction,
    element for element (both compact the per-class matches in the same
    order)."""
    te, je, ph, hay = _layouts("dict_ci")
    t, dv = je.tables, je.dv
    n = len(hay)
    cap_c, cap_m = 8192, 2048
    buf = TB.stage(hay, ph.tiles * TB.LANES * ph.L, te.pad_byte or 0,
                   "cpu").numpy()
    u8f = JF._unpack_fold(jnp.asarray(buf), dv.W, True)
    halo, body = jnp.asarray(ph.halo_a.numpy()), jnp.asarray(ph.body.numpy())
    kw = dict(cap_c=cap_c, cap_m=cap_m) if extract else dict(cap_c=cap_c)
    if baked:
        fn = JF._fp_verified_jit(t.baked_key(), dv.key(), t.k, ph.L, ph.Lc,
                                 je.halo, ph.tiles, dv.W, extract)
        res = fn(halo, body, u8f, jnp.int32(n), dv.device_args(), **kw)
    else:
        fn = JF._fp_verified_generic_jit(dv.key(), t.k, ph.L, ph.Lc, je.halo,
                                         ph.tiles, dv.W, extract)
        res = fn(*t.device_args(), jnp.asarray([0, n], jnp.int32), halo,
                 body, u8f, jnp.int32(n), dv.device_args(), **kw)
    lo, hi, sm, em = te._args()
    _, bmp = FK.fp_bitmap_plain(lo, hi, sm, em, ph.halo_a, ph.body,
                                None if baked else (0, n))
    ncand, e_pos, live = CK.cand_select(bmp, ph.L, cap_c)
    ok, pid, end, total = CK.fp_verify(
        TF._verify_buffer(torch.from_numpy(buf), te.dv.W, True), e_pos, live,
        n, te.dv.device_tables(torch.device("cpu")), te.dv.W, extract)
    assert int(ncand) == int(res[0]) < cap_c
    assert int(total) == int(res[1]) > 100
    if extract:
        assert int(total) < cap_m
        pid, end = select_matches(ok, pid, end, cap_m)
        np.testing.assert_array_equal(pid.numpy(), np.asarray(res[2]))
        np.testing.assert_array_equal(end.numpy(), np.asarray(res[3]))


# ---------------------------------------------------------------------------
# Engines
# ---------------------------------------------------------------------------
def _engines_agree(pats, ci, hay):
    te = TF.FingerprintEngine(pats, ci, "cpu")
    je = JF.FingerprintEngine(pats, ci)
    got, want = te.match_pairs(hay), je.match_pairs(hay)
    if want is None:
        assert got is None
    else:
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    assert (te.level, te.hostile, te._caps) == (je.level, je.hostile,
                                                je._caps)
    assert getattr(te, "last_caps", None) == getattr(je, "last_caps", None)
    # The count takes the same route with the settled caps.
    assert te.count_matches(hay) == (None if got is None else len(got[0]))
    return te, got


@pytest.mark.parametrize("name,route", [
    ("dict150", "host_verify"), ("dict_ci", "device_generic"),
    ("names", "device_baked"), ("short_mixed", "device_baked"),
    ("short_mixed", "host_verify"),
])
def test_engine_equals_jax(name, route, monkeypatch):
    if route != "host_verify":
        for mod in (JF, TF):
            monkeypatch.setattr(mod, "FP_DV_MIN", 0)
    if route == "device_baked":
        for mod in (JF, TF):
            monkeypatch.setattr(mod, "FP_BAKED_MIN", 0)
    pats, ci, hay = _set(name)
    te, got = _engines_agree(pats, ci, hay)
    assert len(got[0]) > 10
    ph = te.prepare(hay)
    assert (ph.u8f is not None) == (route != "host_verify" and
                                    te.dv is not None)
    assert ph.baked == (route == "device_baked")


def test_device_verify_window_covers_class4_tails(monkeypatch):
    """A class-4 pattern (length 5-7) occupies window columns [4, 4+len),
    so W = FP_LEN - class + len (here 10), not max(FP_LEN, max_len):
    "Streatham" must not match "Street"."""
    monkeypatch.setattr(TF, "FP_DV_MIN", 0)
    pats = [b"Sherlock", b"Street"]
    eng = TF.FingerprintEngine(pats, False, "cpu")
    assert eng.dv is not None and eng.dv.W == 10
    hs = b"going to Streatham via Baker Street with Sherlock today"
    pids, ends = eng.match_pairs(hs)
    assert list(zip(pids.tolist(), ends.tolist())) == [(1, 35), (0, 49)]
    assert eng.count_matches(hs) == 2


def test_escalation_equals_jax(monkeypatch):
    """A candidate rate above the escalation limit moves both engines to
    the same finer plan level, with the same result. (A two-level ladder
    keeps the interpret-mode compiles of the JAX side small.)"""
    for mod in (JF, TF):
        monkeypatch.setattr(mod, "ESC_FLOOR", 16)
        monkeypatch.setattr(mod, "FP_DV_MIN", 0)
        monkeypatch.setattr(mod, "PLAN_LEVELS", (8, 12))
    rng = np.random.default_rng(3)
    pats = _dictionary(rng, 400, 4, 9, b"abcdefgh")
    hay = _text(rng, 1 << 14, pats, 0.05)
    te, _ = _engines_agree(pats, False, hay)
    assert te.level == 1 and te.tables.k > 8


def _hostile_case(monkeypatch, dv):
    for mod in (JF, TF):
        monkeypatch.setattr(mod, "CAND_FLOOR", 64)
        monkeypatch.setattr(mod, "FP_DV_MIN", 0 if dv else 1 << 40)
    pats = [bytes([c]) * 4 for c in b"abcdefgh"] + _dictionary(
        np.random.default_rng(31), 400, 5, 9)
    return pats, b"aaaaaaaa" * 512


def test_hostile_guard_equals_jax(monkeypatch):
    """Candidate-dense input (every position a candidate): both engines
    mark themselves hostile and return None."""
    pats, hay = _hostile_case(monkeypatch, dv=False)
    te, got = _engines_agree(pats, False, hay)
    assert got is None and te.hostile


def test_hostile_guard_device_verify(monkeypatch):
    pats, hay = _hostile_case(monkeypatch, dv=True)
    te = TF.FingerprintEngine(pats, False, "cpu")
    assert te.dv is not None and te.prepare(hay).u8f is not None
    assert te.count_matches(hay) is None and te.hostile
    assert te.match_pairs(hay) is None


def test_empty_and_no_match():
    pats, ci, _ = _set("dict150")
    eng = TF.FingerprintEngine(pats, ci, "cpu")
    assert eng.count_matches(b"") == 0
    pids, ends = eng.match_pairs(b"QQQQ" * 1000)
    assert len(pids) == 0 and len(ends) == 0
    assert TF.FingerprintEngine.eligible(pats) and \
        not TF.FingerprintEngine.eligible(pats + [b""])


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------
def test_wrappers_on_cpu_use_plain_and_count_nothing():
    te, _, ph, hay = _layouts("names")
    lo, hi, sm, em = te._args()
    FK.reset_counts()
    g = FK.fp_bitmap_generic(lo, hi, sm, em, ph.halo_a, ph.body, 0, len(hay))
    b = FK.fp_bitmap_baked(lo, hi, sm, em, ph.halo_a, ph.body)
    w = FK.fp_bitmap_plain(lo, hi, sm, em, ph.halo_a, ph.body, (0, len(hay)))
    for x, y in zip(g, w):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    assert b[1].shape == g[1].shape
    assert FK.generic_launches == 0 and FK.baked_launches == 0


def test_wrapper_rejects_a_stream_length_off_32():
    te, _, ph, _ = _layouts("names")
    lo, hi, sm, em = te._args()
    with pytest.raises(ValueError):
        FK.fp_bitmap_baked(lo, hi, sm, em, ph.halo_a,
                           ph.body[:-1].contiguous())
