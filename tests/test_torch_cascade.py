"""The port's cascade engine held against the JAX package's.

Same inputs, made from seeds with numpy, go through both packages: the
host tables (coarse plan, class cuckoo tables, verify records, duplicate
map), the probe / expansion / tail-verify stages on the same windows
(pure ``jnp`` on the JAX side, no Pallas), and the engines (the JAX one
with its Pallas kernels G5/G6 in interpret mode, a few cases at 16 KB).
The twelve cases of ``tests/test_cascade.py`` run the port's engine and
facade alone against a brute-force enumeration, and the facade's routing
through the cascade is checked with a spy. Every output is an integer:
the tolerance is exact equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ahocorasick_tpu as J
import ahocorasick_tpu.ops.cascade as JC
import ahocorasick_tpu_torch as T
import ahocorasick_tpu_torch.ops.cascade as TC
import ahocorasick_tpu_torch.ops.fingerprint as TF
from ahocorasick_tpu_torch.ops import candidate_kernels as CK
from ahocorasick_tpu_torch.ops import fingerprint_kernels as FK
from ahocorasick_tpu_torch.ops.compaction import select_matches
from test_cascade import NAME_SYL, brute_pairs, make_dict, make_text
from torch_suite import per_test_time_limit  # noqa: F401

FF = [b"\xff" * 8, b"\xff" * 4, b"\xff" * 7, b"\xff" * 12]


def _set(name):
    """(patterns, case_insensitive, haystack) of a named case."""
    rng = np.random.default_rng(sum(name.encode()))
    if name == "classes":
        # Lengths 1-8 and LONG, a short and a long duplicate pair.
        pats = [b"q", b"zx", b"wqa", b"gorm", b"haldn", b"barbel",
                b"danvors", b"barbelfa", b"barbelfandanvor"]
        pats += make_dict(rng, 80, NAME_SYL)
        pats += [pats[3], b"barbelfandanvor"]
        hay = make_text(rng, 12_000, pats, 0.05) + b" q zx wqa gorm"
        return pats, False, hay
    if name == "ci":
        pats = make_dict(rng, 150, NAME_SYL, cap=0.4)
        arr = np.frombuffer(make_text(rng, 12_000, pats, 0.04),
                            np.uint8).copy()
        alpha = ((arr | 0x20) >= 0x61) & ((arr | 0x20) <= 0x7A)
        arr[alpha & (rng.random(len(arr)) < 0.3)] ^= 0x20
        return pats, True, arr.tobytes()
    if name == "ff_and_long":
        pats = make_dict(rng, 60, NAME_SYL) + FF
        pats += [b"x" * 70 + b"end", b"barbar" * 14]  # > W_CASCADE
        hay = (make_text(rng, 8_000, pats, 0.04) + b"\xff" * 40
               + pats[-2] + b" " + pats[-1] + b"barbar")
        return pats, False, hay
    if name == "no_pad":
        # Every nybble pair in use: no strong pad byte, the G5 route.
        pats = [bytes(range(8 * i, 8 * i + 8)) for i in range(32)]
        pats += make_dict(rng, 40, NAME_SYL)
        hay = bytearray(make_text(rng, 12_000, pats, 0.03))
        for at in range(100, len(hay) - 8, 997):
            hay[at:at + 8] = pats[at % 32]
        return pats, False, bytes(hay)
    raise KeyError(name)


TABLE_SETS = ["classes", "ci", "ff_and_long", "no_pad"]


# ---------------------------------------------------------------------------
# Host tables
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", TABLE_SETS)
def test_tables_equal_jax(name):
    pats, ci, _ = _set(name)
    je, te = JC.CascadeEngine(pats, ci), TC.CascadeEngine(pats, ci, "cpu")
    assert te.level == je.level and te.q == je.q
    assert te.pad_byte == je.pad_byte
    np.testing.assert_array_equal(te.long_pids, je.long_pids)
    np.testing.assert_array_equal(te.main_pids, je.main_pids)
    np.testing.assert_array_equal(te.pid_rank, je.pid_rank)
    assert (te.side is None) == (je.side is None)
    jt, tt = je.tables, te.tables
    for a in ("lo", "hi", "start", "end"):
        np.testing.assert_array_equal(getattr(tt.coarse, a),
                                      getattr(jt.coarse, a))
    assert tt.coarse.k == jt.coarse.k
    for a in ("W", "Ww", "tail_w0", "q", "num_prefixes"):
        assert getattr(tt, a) == getattr(jt, a), a
    for a in ("pv", "pidarr", "plens"):
        np.testing.assert_array_equal(getattr(tt, a), getattr(jt, a))
    assert sorted(tt.classes) == sorted(jt.classes)
    for c, jct in jt.classes.items():
        tct = tt.classes[c]
        assert tct.mults == jct.mults and tct.logT == jct.logT
        for a in ("rec", "pidlist", "empty_mask"):
            np.testing.assert_array_equal(getattr(tct, a), getattr(jct, a))
    assert sorted(tt.dups8) == sorted(jt.dups8)
    for k, v in jt.dups8.items():
        np.testing.assert_array_equal(tt.dups8[k], v)
    assert tt.meta_key() == jt.meta_key()
    assert tt.memory_usage() == jt.memory_usage()
    assert TC.CascadeEngine.eligible(pats, ci) == JC.CascadeEngine.eligible(
        pats, ci)
    if name == "classes":
        assert set(tt.classes) == {TC.LONG, 1, 2, 3, 4, 5, 6, 7, 8}
        assert tt.dups8 and (tt.classes[TC.LONG].rec[:, 3] > 1).any()
    if name == "ff_and_long":
        assert te.side is not None and len(te.long_pids) == 2


# ---------------------------------------------------------------------------
# Stages 2 and 3 on the same windows
# ---------------------------------------------------------------------------
def _windows(pats, ci, hay, cap, seed):
    """(engine, e_pos, live, u8f, wnd, n) for a port engine: the verify
    buffer and its windows at candidate ends at the
    coarse-prefix end of true matches (so every class hits), at all-0xFF
    stretches and at random positions, some of them not live."""
    te = TC.CascadeEngine(pats, ci, "cpu")
    t = te.tables
    rng = np.random.default_rng(seed)
    wp, we = brute_pairs(pats, hay, ci)
    plens = np.array([len(p) for p in pats])[wp]
    e = we - plens + np.minimum(plens, t.q) - 1
    ff = [m for m in range(len(hay)) if hay[m] == 0xFF]
    e = np.concatenate([e, ff, rng.integers(0, len(hay), cap)])
    e = rng.permutation(e)[:cap]
    e_pos = torch.zeros(cap, dtype=torch.int64)
    e_pos[:len(e)] = torch.from_numpy(e.astype(np.int64))
    live = torch.from_numpy(rng.random(cap) < 0.95)
    live[len(e):] = False
    ph = te.prepare(hay)
    wnd = CK.gather_windows(ph.u8f, e_pos, t.W)
    return te, e_pos, live, ph.u8f, wnd, len(hay)


def _jax_stages(pats, ci, e_pos, live, wnd, n, extract, cap_e, cap_m):
    jt = JC.CascadeEngine(pats, ci).tables
    W, q, cls = jt.meta_key()
    out = JC._probe_expand_verify(
        jnp.asarray(e_pos.numpy().astype(np.int32)), jnp.asarray(
            live.numpy()), jnp.asarray(wnd.numpy()), jnp.int32(n),
        jt.device_args(), dict(cls), extract, cap_e, cap_m, q, jt.tail_w0)
    return [np.asarray(o) for o in out]


@pytest.mark.parametrize("name", ["classes", "ff_and_long", "ci"])
@pytest.mark.parametrize("extract", [False, True])
@pytest.mark.parametrize("caps", ["fit", "overflow"])
def test_stages_equal_jax(name, extract, caps):
    pats, ci, hay = _set(name)
    te, e_pos, live, u8f, wnd, n = _windows(pats, ci, hay, 1024, 5)
    t = te.tables
    dv = t.device_tensors(torch.device("cpu"))

    def stages(extract, cap_e, cap_m):
        total, total_e, flags = TC.verify_candidates(u8f, e_pos, live, n, t,
                                                     dv, cap_e, extract)
        if not extract:
            return total_e, total
        return (total_e, total) + select_matches(*flags, cap_m)
    full = stages(False, 1 << 14, 1 << 14)
    total_e, total = int(full[0]), int(full[1])
    assert total > 50 and (TC.LONG not in t.classes or total_e > 20)
    cap_e, cap_m = ((1 << 14, 1 << 14) if caps == "fit"
                    else (max(total_e // 2, 1), max(total // 3, 1)))
    got = stages(extract, cap_e, cap_m)
    want = _jax_stages(pats, ci, e_pos, live, wnd, n, extract, cap_e, cap_m)
    assert [int(got[0]), int(got[1])] == [int(want[0]), int(want[1])]
    if caps == "overflow":
        # Expansion rows past cap_e are dropped, matches past cap_m cut.
        assert int(got[0]) == total_e > cap_e or TC.LONG not in t.classes
        assert int(got[1]) > cap_m
    else:
        assert int(got[1]) == total
    if extract:
        np.testing.assert_array_equal(got[2].numpy(), want[2])
        np.testing.assert_array_equal(got[3].numpy(), want[3])


@pytest.mark.parametrize("counts,cap", [
    ([0, 3, 0, 0, 2, 1, 0, 4], 16),     # zero-count groups, room to spare
    ([0, 3, 0, 0, 2, 1, 0, 4], 7),      # overflow: total 10 > cap 7
    ([5, 0, 0, 0], 3),                  # a group past the cap's end
    ([0, 0, 0], 4),                     # nothing to expand
])
def test_expand_gid_equals_jax(counts, cap):
    tot, gid, resid, live = CK.expand_gid(torch.tensor(counts), cap)
    jtot, jgid, jresid, jlive = (np.asarray(a) for a in JC._expand_gid(
        jnp.asarray(np.array(counts, np.int32)), cap))
    assert int(tot) == int(jtot) == sum(counts)
    np.testing.assert_array_equal(live.numpy(), jlive)
    lv = live.numpy()
    np.testing.assert_array_equal(gid.numpy()[lv], jgid[lv])
    np.testing.assert_array_equal(resid.numpy()[lv], jresid[lv])


def test_class_key_of_all_ff_window_is_the_empty_sentinel():
    """An all-0xFF window builds the key of empty slots, (2^32-1, 2^32-1)
    in the port's unsigned representation; only the occupancy test keeps
    it from hitting."""
    wnd = torch.full((2, 24), 0xFF, dtype=torch.uint8)
    lo, hi = CK.class_key(wnd, TC.LONG, 8)
    assert lo.tolist() == hi.tolist() == [0xFFFFFFFF] * 2
    te = TC.CascadeEngine(make_dict(np.random.default_rng(1), 30, NAME_SYL)
                          + [b"\xff" * 9], False, "cpu")
    rec = te.tables.device_tensors(torch.device("cpu"))["classes"][TC.LONG][2]
    empty = rec[:, 3] == 0
    assert (rec[empty, 0] == 0xFFFFFFFF).all() and empty.any()


# ---------------------------------------------------------------------------
# Engine against the JAX engine (Pallas interpret mode)
# ---------------------------------------------------------------------------
def _engines_agree(pats, ci, hay):
    je, te = JC.CascadeEngine(pats, ci), TC.CascadeEngine(pats, ci, "cpu")
    got_c, want_c = te.count_matches(hay), je.count_matches(hay)
    assert got_c == want_c
    got, want = te.match_pairs(hay), je.match_pairs(hay)
    assert (got is None) == (want is None)
    if got is not None:
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    assert te.level == je.level and te.hostile == je.hostile
    assert te.last_caps == je.last_caps
    return te, got


@pytest.mark.parametrize("name", ["classes", "no_pad"], ids=["G6", "G5"])
def test_engine_equals_jax(name):
    pats, ci, hay = _set(name)
    te, got = _engines_agree(pats, ci, hay[:1 << 14])
    assert te.prepare(b"x").baked == (name == "classes")
    wp, _ = brute_pairs(pats, hay[:1 << 14], ci)
    assert len(got[0]) == len(wp) > 50


def test_escalation_equals_jax(monkeypatch):
    """A candidate count above the limit moves both engines to the same
    finer coarse plan, with the same result (a two-level ladder keeps
    the interpret-mode compiles of the JAX side small; the limit is set
    between the two levels' candidate counts)."""
    for mod in (JC, TC):
        monkeypatch.setattr(mod, "CASCADE_LEVELS", (10, 16))
        monkeypatch.setattr(mod, "CAND_FLOOR", 1000)
        monkeypatch.setattr(mod, "CAND_SHIFT", 30)
    rng = np.random.default_rng(11)
    pats = set()
    while len(pats) < 300:
        pats.add(rng.choice(list(b"abcdefghijklmnopqrstuvwxyz"), int(
            rng.integers(3, 10))).astype(np.uint8).tobytes())
    pats = sorted(pats)
    hay = rng.choice(list(b"abcdefghijklmnopqrstuvwxyz "),
                     1 << 14).astype(np.uint8).tobytes()
    te = TC.CascadeEngine(pats, False, "cpu")
    assert te.level == 0 and te.tables.coarse.k == 10
    te, got = _engines_agree(pats, False, hay)
    assert te.level == 1 and te.tables.coarse.k > 10 and not te.hostile
    assert len(got[0]) == len(brute_pairs(pats, hay)[0])


# ---------------------------------------------------------------------------
# tests/test_cascade.py, on the port alone (plain G5/G6, no JAX)
# ---------------------------------------------------------------------------
def check_engine(patterns, hay, ci=False):
    eng = TC.CascadeEngine(patterns, ci, "cpu")
    want_p, want_e = brute_pairs(patterns, hay, ci)
    assert eng.count_matches(hay) == len(want_p)
    pairs = eng.match_pairs(hay)
    assert pairs is not None
    np.testing.assert_array_equal(pairs[1], want_e)
    np.testing.assert_array_equal(pairs[0], want_p)
    return eng


def test_cascade_basic_dictionary():
    rng = np.random.default_rng(42)
    pats = make_dict(rng, 300, NAME_SYL)
    hay = make_text(rng, 20_000, pats)
    assert TC.CascadeEngine.eligible(pats)
    check_engine(pats, hay)


def test_cascade_case_insensitive():
    rng = np.random.default_rng(43)
    pats = make_dict(rng, 200, NAME_SYL, cap=0.4)
    arr = np.frombuffer(make_text(rng, 16_000, pats), np.uint8).copy()
    flip = np.random.default_rng(7).random(len(arr)) < 0.3
    lower = arr | 0x20
    arr[flip & (lower >= 0x61) & (lower <= 0x7A)] ^= 0x20
    check_engine(pats, arr.tobytes(), ci=True)


def test_cascade_shared_prefix_groups_beyond_gmax():
    rng = np.random.default_rng(44)
    base = b"barbarda"
    pats = [base + bytes([97 + i % 26, 97 + (i // 26) % 26])
            for i in range(40)]
    pats = sorted(set(pats + make_dict(rng, 100, NAME_SYL)))
    check_engine(pats, make_text(rng, 12_000, pats, density=0.05))


def test_cascade_short_and_mixed_lengths():
    rng = np.random.default_rng(45)
    pats = [b"q", b"zx", b"wqa", b"gorm", b"haldan", b"barbelfan",
            b"danvors", b"xy"]
    pats = sorted(set(pats + make_dict(rng, 80, NAME_SYL)))
    hay = make_text(rng, 10_000, pats, density=0.03) + b" q zx wqa gorm"
    check_engine(pats, hay)


def test_cascade_long_pattern_side_engine():
    rng = np.random.default_rng(46)
    pats = make_dict(rng, 60, NAME_SYL)
    long1 = b"x" * 70 + b"end"
    long2 = b"barbar" * 14  # 84 bytes
    pats = sorted(set(pats + [long1, long2]))
    assert TC.CascadeEngine(pats, False, "cpu").side is not None
    hay = (make_text(rng, 6_000, pats, density=0.04)
           + long1 + b" pad " + long2 + long2[:6])
    check_engine(pats, hay)


def test_cascade_empty_and_tiny_haystacks():
    rng = np.random.default_rng(47)
    pats = make_dict(rng, 120, NAME_SYL)
    eng = TC.CascadeEngine(pats, False, "cpu")
    assert eng.count_matches(b"") == 0
    p, e = eng.match_pairs(b"")
    assert len(p) == 0 and len(e) == 0
    tiny = pats[5] + b"!"
    assert eng.count_matches(tiny) == brute_pairs(pats, tiny)[0].size
    check_engine(pats, pats[0][:2])  # shorter than any pattern


def test_cascade_repeated_search_reuses_prepared_layout():
    rng = np.random.default_rng(48)
    pats = make_dict(rng, 150, NAME_SYL)
    eng = TC.CascadeEngine(pats, False, "cpu")
    hay = make_text(rng, 8_000, pats)
    ph = eng.prepare(hay)
    want = brute_pairs(pats, hay)[0].size
    assert eng.count_matches(ph) == want
    caps = eng.last_caps
    assert eng.count_matches(ph) == want and eng.last_caps == caps
    gp, ge = eng.match_pairs(ph)
    assert len(gp) == want


def test_facade_cascade_forced_and_semantics():
    rng = np.random.default_rng(49)
    pats = make_dict(rng, 130, NAME_SYL)
    pats = sorted(set(pats + [b"barbel", b"barbelfan", b"bar"]))
    hay = make_text(rng, 9_000, pats, density=0.04)
    for mk in (T.MatchKind.STANDARD, T.MatchKind.LEFTMOST_FIRST,
               T.MatchKind.LEFTMOST_LONGEST):
        ac = T.AhoCorasick(pats, match_kind=mk, engine="cascade",
                           device_threshold=1, device="cpu")
        ref = T.AhoCorasick(pats, match_kind=mk, engine="oracle",
                            device="cpu")
        assert _triples(ac.find_iter(hay)) == _triples(ref.find_iter(hay))
        assert ac._engines.get("cascade") is not None


def test_facade_auto_routes_large_sets_to_cascade(spy):
    rng = np.random.default_rng(50)
    syl = [a + b for a in "bcdfghjklmnpqrstvwz" for b in "aeiouy"][:90]
    pats = make_dict(rng, 6000, syl, (3, 4))
    assert TC.CascadeEngine.eligible(pats)
    hay = make_text(rng, 30_000, pats, density=0.01)
    ac = T.AhoCorasick(pats, device_threshold=1, device="cpu")
    want_p, _ = brute_pairs(pats, hay)
    assert ac.count_matches(hay) == len(want_p)
    assert not ac._engines["cascade"].hostile
    assert spy == [("CascadeEngine", "count_matches")]


def test_cascade_duplicate_patterns():
    rng = np.random.default_rng(52)
    base = make_dict(rng, 60, NAME_SYL)
    dup_short = base[3]
    dup_long = b"barbelfandanvor"
    pats = list(base) + [dup_short, dup_short, dup_long, dup_long]
    hay = make_text(rng, 8_000, pats, density=0.05) + dup_long + dup_short
    check_engine(pats, hay)


def test_host_pairs_expand_duplicate_groups():
    """The host's duplicate expansion gives each selected representative
    pid's group, once per match site, mapped to full-set pids: held
    against a direct expansion, with groups of two and three, one
    representative matched at several ends, and -1 slots dropped."""
    rng = np.random.default_rng(54)
    base = make_dict(rng, 40, NAME_SYL)
    pats = [b"qubo", b"vexa"] + list(base) + [b"qubo", b"qubo", b"vexa",
                                             b"x" * 80]
    eng = TC.CascadeEngine(pats, False, "cpu")
    groups = {int(k): v for k, v in eng.tables.dups8.items()}
    assert sorted(groups) == [0, 1]
    assert sorted(len(g) for g in groups.values()) == [2, 3]
    pid = np.array([0, 4, 1, 0, -1, 5, -1], np.int64)
    end = np.array([10, 11, 12, 13, -1, 14, -1], np.int64)
    got_p, got_e = eng._host_pairs(torch.from_numpy(pid),
                                   torch.from_numpy(end))
    want = []
    for p, e in zip(pid, end):
        if p >= 0:
            want += [(int(eng.main_pids[q]), int(e))
                     for q in groups.get(int(p), [p])]
    assert sorted(zip(got_p.tolist(), got_e.tolist())) == sorted(want)
    assert len(got_p) == len(want) == 10


def test_cascade_all_ff_bytes():
    rng = np.random.default_rng(53)
    pats = make_dict(rng, 50, NAME_SYL)
    pats = sorted(set(pats + FF[:3]))
    hay = (make_text(rng, 5_000, pats, density=0.03)
           + b"\xff" * 40 + make_text(rng, 2_000, pats))
    check_engine(pats, hay)


def test_cascade_hostile_input_falls_back():
    rng = np.random.default_rng(51)
    pats = make_dict(rng, 250, NAME_SYL)
    hay = b" ".join(
        pats[int(rng.integers(len(pats)))] for _ in range(30_000)
    )[:150_000]
    eng = TC.CascadeEngine(pats, False, "cpu")
    got = eng.count_matches(hay)
    want = brute_pairs(pats, hay)[0].size
    if got is None:
        assert eng.hostile
        ac = T.AhoCorasick(pats, device_threshold=1, device="cpu")
        assert ac.count_matches(hay) == want
    else:
        assert got == want


# ---------------------------------------------------------------------------
# Facade routing
# ---------------------------------------------------------------------------
def _triples(it):
    return [m.astuple() for m in it]


@pytest.fixture
def spy(monkeypatch):
    """Records (engine class, method) of each filter-engine call the
    facade makes (calls an engine makes to itself are not recorded)."""
    calls = []
    depth = [0]
    for cls in (TF.FingerprintEngine, TC.CascadeEngine):
        for meth in ("count_matches", "match_pairs"):
            orig = getattr(cls, meth)

            def wrapped(self, hs, _orig=orig, _name=(cls.__name__, meth)):
                if not depth[0]:
                    calls.append(_name)
                depth[0] += 1
                try:
                    return _orig(self, hs)
                finally:
                    depth[0] -= 1
            monkeypatch.setattr(cls, meth, wrapped)
    return calls


def test_hostile_cascade_falls_back_to_fingerprint_then_native(
        monkeypatch, spy):
    """Above CASCADE_MIN_PATTERNS the cascade leads; once it is hostile
    the fingerprint engine serves, and once that is hostile too the
    native walk. Every answer equals the JAX facade's."""
    import ahocorasick_tpu.ahocorasick as JA
    import ahocorasick_tpu.ops.fingerprint as JF
    import ahocorasick_tpu_torch.ahocorasick as TA

    for mod in (JA, TA):
        monkeypatch.setattr(mod, "CASCADE_MIN_PATTERNS", 100)
    for mod in (JC, TC):
        monkeypatch.setattr(mod, "CAND_FLOOR", 64)
    rng = np.random.default_rng(61)
    pats = make_dict(rng, 250, NAME_SYL)
    hostile = b" ".join(pats[int(rng.integers(len(pats)))]
                        for _ in range(1500))[:8000]
    tac = T.AhoCorasick(pats, device_threshold=1, device="cpu")
    want = brute_pairs(pats, hostile)[0].size
    assert tac.count_matches(hostile) == want
    assert tac._engines["cascade"].hostile
    assert not tac._engines["fingerprint"].hostile
    assert spy == [("CascadeEngine", "count_matches"),
                   ("FingerprintEngine", "count_matches")]
    monkeypatch.setattr(TF, "CAND_FLOOR", 64)
    monkeypatch.setattr(JF, "CAND_FLOOR", 64)
    spy.clear()
    got = _triples(tac.find_overlapping_iter(hostile))
    assert tac._engines["fingerprint"].hostile
    assert spy == [("FingerprintEngine", "match_pairs")]
    jac = J.AhoCorasick(pats, device_threshold=1)
    assert got == _triples(jac.find_overlapping_iter(J.Input(hostile)))
    spy.clear()
    assert tac.count_matches(hostile) == want and spy == []


def test_ineligible_fingerprint_set_takes_cascade(monkeypatch, spy):
    """A set of at most CASCADE_MIN_PATTERNS that the fingerprint planner
    declines is offered to the cascade, as in the JAX facade (the
    planner's verdict is patched here)."""
    monkeypatch.setattr(TF.FingerprintEngine, "eligible",
                        classmethod(lambda cls, p, ci=False: False))
    rng = np.random.default_rng(62)
    pats = make_dict(rng, 300, NAME_SYL)
    hay = make_text(rng, 20_000, pats, density=0.02)
    tac = T.AhoCorasick(pats, device_threshold=1, device="cpu")
    want = brute_pairs(pats, hay)
    assert tac.count_matches(hay) == len(want[0]) > 50
    got = [(m.pattern, m.end) for m in tac.find_overlapping_iter(hay)]
    assert got == list(zip(want[0].tolist(), want[1].tolist()))
    assert tac._engines["fingerprint"] is None
    assert tac._engines["cascade"] is not None
    assert spy == [("CascadeEngine", "count_matches"),
                   ("CascadeEngine", "match_pairs")]


@pytest.mark.parametrize("baked", [False, True], ids=["G5", "G6"])
def test_coarse_bitmap_launches_nothing_on_the_cpu(baked):
    """On CPU tensors the cascade's coarse pass takes the plain G5/G6 and
    counts no launch."""
    name = "classes" if baked else "no_pad"
    pats, ci, hay = _set(name)
    eng = TC.CascadeEngine(pats, ci, "cpu")
    FK.reset_counts()
    ph = eng.prepare(hay)
    assert ph.baked == baked
    coarse = eng.tables.device_tensors(torch.device("cpu"))["coarse"]
    got = TF.bitmap(coarse, ph)
    want = FK.fp_bitmap_plain(*coarse, ph.halo_a, ph.body,
                              None if baked else (0, ph.n))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert FK.generic_launches == FK.baked_launches == 0
