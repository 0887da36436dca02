"""The plain versions of the candidate-stage kernels S1-S4
(`ahocorasick_tpu_torch/ops/candidate_kernels.py`) held against the JAX
stages they port, and the engines' one-read passes against the JAX
engines.

S1 `cand_select` against `fingerprint._rank_select`, S2 `fp_verify` against
`fingerprint._device_verify`, S3 `cascade_probe` against `cascade._probe`
and S4 `cascade_long_verify` against `cascade._probe_expand_verify` (its
`expand_gid` against `cascade._expand_gid` in `test_torch_cascade.py`):
plain `jnp`, no Pallas. The two engine
cases run the JAX engines, their Pallas kernels in interpret mode, over
16 KiB. Bitmaps, haystacks and pattern sets are made with numpy from
seeds; every output is an integer, and the tolerance is exact equality,
in output order. Past the count the JAX selection leaves arbitrary
in-range values, so positions and groups are compared where they are
live.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ahocorasick_tpu.ops.cascade as JC
import ahocorasick_tpu.ops.fingerprint as JF
import ahocorasick_tpu_torch.ops.cascade as TC
import ahocorasick_tpu_torch.ops.fingerprint as TF
from ahocorasick_tpu_torch.ops import candidate_kernels as CK
from ahocorasick_tpu_torch.ops.compaction import select_matches
from test_cascade import NAME_SYL, brute_pairs, make_dict, make_text

CPU = torch.device("cpu")


# ---------------------------------------------------------------------------
# S1: candidate selection
# ---------------------------------------------------------------------------
def _bitmap(seed, tiles, L, p):
    """[tiles, L/32, 8, 128] int32 with each position's bit set at rate p,
    and the bits of the first and the last position set."""
    rng = np.random.default_rng(seed)
    bits = rng.random((tiles, L // 32, 8, 128, 32)) < p
    bits[0, 0, 0, 0, 0] = True          # position 0: stream 0, t = 0
    bits[-1, -1, -1, -1, 31] = True     # position n - 1: last stream, t = L-1
    words = (bits.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(
        axis=-1).astype(np.uint32)
    return words.view(np.int32)


@pytest.mark.parametrize("tiles,L,p,cap", [
    (1, 128, 0.01, 4096),      # the cap holds every candidate
    (2, 256, 0.02, 1000),      # a cap smaller than the count
    (3, 512, 0.001, 64),
])
def test_cand_select_equals_jax(tiles, L, p, cap):
    bmp = _bitmap(tiles * L, tiles, L, p)
    ncand, e_pos, live = CK.cand_select_plain(torch.from_numpy(bmp), L, cap)
    jn, jpos, jlive = JF._rank_select(jnp.asarray(bmp), L, cap)
    jlive = np.asarray(jlive)
    count = int(np.unpackbits(bmp.view(np.uint8)).sum())
    assert int(ncand) == int(jn) == count
    assert (count < cap) == (p == 0.01)
    np.testing.assert_array_equal(live.numpy(), jlive)
    np.testing.assert_array_equal(e_pos.numpy()[jlive],
                                  np.asarray(jpos)[jlive])
    assert (e_pos.numpy()[~jlive] == 0).all()
    n = tiles * 1024 * L
    assert e_pos[0] == 0
    if count <= cap:
        assert int(e_pos[count - 1]) == n - 1
    # On the CPU the wrapper runs the plain version and counts nothing.
    CK.reset_counts()
    got = CK.cand_select(torch.from_numpy(bmp), L, cap)
    for a, b in zip(got, (ncand, e_pos, live)):
        assert torch.equal(a, b)
    assert CK.select_launches == 0


def test_cand_select_of_an_empty_bitmap():
    bmp = torch.zeros((1, 4, 8, 128), dtype=torch.int32)
    ncand, e_pos, live = CK.cand_select(bmp, 128, 8)
    assert int(ncand) == 0 and not live.any() and (e_pos == 0).all()


def test_cand_select_takes_the_plain_bitmaps_strided_view():
    """G5/G6's plain version returns its bitmap as a permuted view; on the
    CPU the wrapper takes it as it is."""
    bmp = torch.from_numpy(_bitmap(7, 3, 256, 0.01))
    view = bmp.permute(1, 0, 2, 3).contiguous().permute(1, 0, 2, 3)
    assert not view.is_contiguous()
    for a, b in zip(CK.cand_select(view, 256, 2048),
                    CK.cand_select(bmp, 256, 2048)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# S2: the fingerprint engine's device verify
# ---------------------------------------------------------------------------
def _fp_set(name):
    """(patterns, case_insensitive, haystack)."""
    rng = np.random.default_rng(sum(name.encode()))
    if name == "groups16":
        # 16 patterns of one 8-byte fingerprint: a group of GMAX_CAP.
        group = [b"barbelfa" + rng.choice(list(b"xyzw"), int(k)).astype(
            np.uint8).tobytes() for k in range(1, 17)]
        pats = sorted(set(group + make_dict(rng, 120, NAME_SYL)))
        hay = make_text(rng, 12_000, pats, 0.08)
        return pats, False, hay
    if name == "ci":
        pats = make_dict(rng, 200, NAME_SYL, (1, 4), cap=0.4)
        arr = np.frombuffer(make_text(rng, 12_000, pats, 0.06),
                            np.uint8).copy()
        alpha = ((arr | 0x20) >= 0x61) & ((arr | 0x20) <= 0x7A)
        arr[alpha & (rng.random(len(arr)) < 0.3)] ^= 0x20
        return pats, True, arr.tobytes()
    raise KeyError(name)


def _verify_buffer(hay, W, ci):
    """The port's verify buffer of the haystack's bytes (padded to a whole
    int32 word)."""
    buf = np.zeros(-(-len(hay) // 4) * 4, np.uint8)
    buf[:len(hay)] = np.frombuffer(hay, np.uint8)
    return TF._verify_buffer(torch.from_numpy(buf.view(np.int32)), W, ci)


def _fp_candidates(pats, ci, hay, cap, seed):
    """(e_pos, live): the fingerprint ends of the true matches, positions 0
    and n - 1 and random positions, some of them not live."""
    rng = np.random.default_rng(seed)
    wp, we = brute_pairs(pats, hay, ci)
    plens = np.array([len(p) for p in pats])[wp]
    c = np.array([TF._mclass(int(x)) for x in plens])
    e = np.concatenate([[0, len(hay) - 1], rng.permutation(np.concatenate(
        [we - plens + c - 1, rng.integers(0, len(hay), cap)]))])[:cap]
    e_pos = torch.from_numpy(np.sort(e).astype(np.int64))
    live = torch.from_numpy(rng.random(cap) < 0.95)
    return e_pos, live


@pytest.mark.parametrize("name", ["groups16", "ci"])
@pytest.mark.parametrize("extract,caps", [(False, "fit"), (True, "fit"),
                                          (True, "overflow")])
def test_fp_verify_equals_jax(name, extract, caps):
    pats, ci, hay = _fp_set(name)
    tdv, jdv = TF.DeviceVerify(pats, ci), JF.DeviceVerify(pats, ci)
    assert tdv.key() == jdv.key()
    if name == "groups16":
        assert max(g for _, _, g in tdv.key()[1]) == TF.GMAX_CAP
    n = len(hay)
    e_pos, live = _fp_candidates(pats, ci, hay, 2048, 3)
    u8f = _verify_buffer(hay, tdv.W, ci)
    ok, pid, end, total = CK.fp_verify(u8f, e_pos, live, n,
                                       tdv.device_tables(CPU), tdv.W,
                                       extract)
    cap_m = 1 << 14 if caps == "fit" else int(total) // 3
    meta = {c: (logT, g) for c, logT, g in jdv.key()[1]}
    wnd = CK.gather_windows(u8f, e_pos, tdv.W).numpy()
    want = JF._device_verify(
        jnp.asarray(wnd), jnp.asarray(e_pos.numpy().astype(np.int32)),
        jnp.asarray(live.numpy()), jnp.int32(n), jdv.device_args(), tdv.W,
        extract, cap_m, meta)
    assert int(total) == int(want[0]) > 100
    if not extract:
        assert ok is None
        return
    assert ok.numel() == sum(2048 * g for _, _, g in tdv.key()[1])
    out_pid, out_end = select_matches(ok, pid, end, cap_m)
    np.testing.assert_array_equal(out_pid.numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(out_end.numpy(), np.asarray(want[3]))
    assert (int(total) > cap_m) == (caps == "overflow")


# ---------------------------------------------------------------------------
# S3, S4: the cascade's probes, expansion and tail verify
# ---------------------------------------------------------------------------
FF = [b"\xff" * 8, b"\xff" * 4, b"\xff" * 12]


def _cascade_set(name):
    rng = np.random.default_rng(sum(name.encode()))
    if name == "classes":
        # Lengths 1-8 and LONG, duplicates, all-0xFF patterns and windows.
        pats = [b"q", b"zx", b"wqa", b"gorm", b"haldn", b"barbel",
                b"danvors", b"barbelfa", b"barbelfandanvor"]
        pats += make_dict(rng, 80, NAME_SYL) + FF
        pats += [pats[3], b"barbelfandanvor"]
        hay = (make_text(rng, 10_000, pats, 0.05) + b" q zx wqa gorm "
               + b"\xff" * 40)
        return pats, False, hay
    if name == "ci":
        pats = make_dict(rng, 150, NAME_SYL, cap=0.4)
        arr = np.frombuffer(make_text(rng, 10_000, pats, 0.05),
                            np.uint8).copy()
        alpha = ((arr | 0x20) >= 0x61) & ((arr | 0x20) <= 0x7A)
        arr[alpha & (rng.random(len(arr)) < 0.3)] ^= 0x20
        return pats, True, arr.tobytes()
    raise KeyError(name)


def _cascade_inputs(name, cap=1024, seed=5):
    """(port engine, JAX tables, e_pos, live, u8f, haystack length):
    candidates at the coarse-prefix ends of true matches (so every class
    hits), at the all-0xFF stretch and at random positions, some of them
    not live."""
    pats, ci, hay = _cascade_set(name)
    te = TC.CascadeEngine(pats, ci, "cpu")
    jt = JC.CascadeEngine(pats, ci).tables
    t = te.tables
    rng = np.random.default_rng(seed)
    wp, we = brute_pairs(pats, hay, ci)
    plens = np.array([len(p) for p in pats])[wp]
    e = we - plens + np.minimum(plens, t.q) - 1
    ff = [m for m in range(len(hay)) if hay[m] == 0xFF]
    e = np.concatenate([e, ff, rng.integers(0, len(hay), cap)])
    e = rng.permutation(e)[:cap]
    e_pos = torch.from_numpy(e.astype(np.int64))
    live = torch.from_numpy(rng.random(cap) < 0.95)
    return te, jt, e_pos, live, te.prepare(hay).u8f, len(hay)


@pytest.mark.parametrize("name", ["classes", "ci"])
@pytest.mark.parametrize("extract", [False, True])
def test_cascade_probe_equals_jax(name, extract):
    te, jt, e_pos, live, u8f, n = _cascade_inputs(name)
    t = te.tables
    dv = t.device_tensors(CPU)
    ok, pid, end, total, long = CK.cascade_probe(
        u8f, e_pos, live, n, dv["classes"], t.q, t.W, extract)
    W, q, cls = jt.meta_key()
    meta = dict(cls)
    wnd = jnp.asarray(CK.gather_windows(u8f, e_pos, W).numpy())
    jpos = jnp.asarray(e_pos.numpy().astype(np.int32))
    jlive = jnp.asarray(live.numpy())
    jdv = jt.device_args()
    exact = sorted(c for c in meta if c != JC.LONG)
    want_total = 0
    for k, c in enumerate(exact):
        hit, rec, sp = (np.asarray(a) for a in JC._probe(
            jdv, meta, c, wnd, jpos, jlive, jnp.int32(n), q))
        rec = rec.astype(np.uint32).astype(np.int64)
        want_total += int(np.where(hit, rec[:, 3], 0).sum())
        if extract:
            np.testing.assert_array_equal(ok[k].numpy(), hit)
            np.testing.assert_array_equal(pid[k].numpy(), rec[:, 2])
            np.testing.assert_array_equal(end[k].numpy(), sp + c)
    assert int(total) == want_total > 30
    hit, rec, sp = (np.asarray(a) for a in JC._probe(
        jdv, meta, JC.LONG, wnd, jpos, jlive, jnp.int32(n), q))
    rec = rec.astype(np.uint32).astype(np.int64)
    counts, lbase, lsp = (a.numpy() for a in long)
    np.testing.assert_array_equal(counts, np.where(hit, rec[:, 3], 0))
    np.testing.assert_array_equal(lbase, rec[:, 2])
    np.testing.assert_array_equal(lsp, sp)
    assert (counts > 1).any()  # a LONG group of several patterns
    if name == "classes":
        # An all-0xFF window builds the empty slots' key; the occupancy
        # test keeps it from hitting them, and the 0xFF patterns hit.
        lo, hi = CK.class_key(CK.gather_windows(u8f, e_pos, W), JC.LONG, q)
        ffw = (lo == 0xFFFFFFFF) & (hi == 0xFFFFFFFF) & live
        assert ffw.any() and (counts[ffw.numpy()] == 1).all()
    assert (ok is None) == (not extract)


@pytest.mark.parametrize("name", ["classes", "ci"])
@pytest.mark.parametrize("caps", ["fit", "overflow"])
def test_cascade_long_verify_equals_jax(name, caps):
    """S3 + cumsum + S4 and the matches' compaction against
    `_probe_expand_verify`: (total_e, total, out_pid, out_end), with LONG
    counts whose expansion passes cap_e in the overflow case."""
    te, jt, e_pos, live, u8f, n = _cascade_inputs(name)
    t = te.tables
    dv = t.device_tensors(CPU)
    ok, pid, end, total, long = CK.cascade_probe(
        u8f, e_pos, live, n, dv["classes"], t.q, t.W, True)
    full = CK.cascade_long_verify(*long, e_pos, u8f, dv["pidarr"], dv["pv"],
                                  n, 1 << 14, t.tail_w0, t.W, False)
    total_e = int(full[4])
    assert total_e > 20
    cap_e, cap_m = ((1 << 14, 1 << 14) if caps == "fit"
                    else (total_e // 2, int(total) // 2))
    lok, lpid, lend, ltotal, te_ = CK.cascade_long_verify(
        *long, e_pos, u8f, dv["pidarr"], dv["pv"], n, cap_e, t.tail_w0, t.W,
        True)
    assert lok.shape == (cap_e,) and int(te_) == total_e
    assert int(ltotal) == int(lok.sum())
    out_pid, out_end = select_matches(
        torch.cat([ok.reshape(-1), lok]), torch.cat([pid.reshape(-1), lpid]),
        torch.cat([end.reshape(-1), lend]), cap_m)
    W, q, cls = jt.meta_key()
    want = JC._probe_expand_verify(
        jnp.asarray(e_pos.numpy().astype(np.int32)), jnp.asarray(live.numpy()),
        jnp.asarray(CK.gather_windows(u8f, e_pos, W).numpy()), jnp.int32(n),
        jt.device_args(), dict(cls), True, cap_e, cap_m, q, jt.tail_w0)
    assert int(te_) == int(want[0])
    assert int(total) + int(ltotal) == int(want[1])
    np.testing.assert_array_equal(out_pid.numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(out_end.numpy(), np.asarray(want[3]))
    if caps == "overflow":
        assert total_e > cap_e and int(want[1]) > cap_m
    # The count mode's total is the extraction's.
    assert int(full[3]) >= int(ltotal)


def test_wrappers_on_cpu_count_nothing():
    te, _, e_pos, live, u8f, n = _cascade_inputs("classes", 256)
    t = te.tables
    dv = t.device_tensors(CPU)
    CK.reset_counts()
    got = CK.cascade_probe(u8f, e_pos, live, n, dv["classes"], t.q, t.W,
                           True)
    want = CK.cascade_probe_plain(u8f, e_pos, live, n, dv["classes"], t.q,
                                  t.W, True)
    for a, b in zip(got[:4] + got[4], want[:4] + want[4]):
        assert torch.equal(a, b)
    args = (*got[4], e_pos, u8f, dv["pidarr"], dv["pv"], n, 512, t.tail_w0,
            t.W, True)
    for a, b in zip(CK.cascade_long_verify(*args),
                    CK.cascade_long_verify_plain(*args)):
        assert torch.equal(a, b)
    assert (CK.select_launches, CK.verify_launches, CK.probe_launches,
            CK.long_launches) == (0, 0, 0, 0)


# ---------------------------------------------------------------------------
# The engines' passes: one read of the scalars, the JAX engines' caps
# ---------------------------------------------------------------------------
def _count_passes(monkeypatch, jmod, jits):
    """(the cap_c of every pass of the port's engines, the number of the
    JAX engines' dispatches through the fused functions ``jits`` of
    ``jmod``)."""
    passes, dispatches = [], []
    real = CK.cand_select

    def spy(*a):
        passes.append(a[2])
        return real(*a)
    monkeypatch.setattr(CK, "cand_select", spy)

    def jit_spy(make):
        def made(*a, **k):
            fn = make(*a, **k)

            def call(*b, **kw):
                dispatches.append(kw["cap_c"])
                return fn(*b, **kw)
            return call
        return made
    for name in jits:
        monkeypatch.setattr(jmod, name, jit_spy(getattr(jmod, name)))
    return passes, dispatches


def test_fp_caps_grow_together_as_in_jax(monkeypatch):
    """A first pass whose candidates overflow cap_c and whose matches
    overflow cap_m grows both caps, as the JAX dispatch does: the second
    pass settles, with the JAX engine's outputs, caps and last_caps."""
    for mod in (JF, TF):
        monkeypatch.setattr(mod, "FP_DV_MIN", 0)
    pats, ci, _ = _fp_set("ci")
    hay = make_text(np.random.default_rng(9), 1 << 14, pats, 0.5)
    te, je = TF.FingerprintEngine(pats, ci, "cpu"), JF.FingerprintEngine(
        pats, ci)
    passes, dispatches = _count_passes(
        monkeypatch, JF, ("_fp_verified_jit", "_fp_verified_generic_jit"))
    got, want = te.match_pairs(hay), je.match_pairs(hay)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert te._caps == je._caps and te.last_caps == je.last_caps
    assert passes == dispatches and passes[0] == 512 < passes[1]
    assert len(got[0]) > 512
    assert te.count_matches(hay) == len(got[0])
    assert passes[-1] == te.last_caps[0]


def test_cascade_caps_grow_together_as_in_jax(monkeypatch):
    for mod in (JC, TC):
        monkeypatch.setattr(mod, "CAP0", 256)
    pats, ci, _ = _cascade_set("classes")
    hay = make_text(np.random.default_rng(9), 1 << 14, pats, 0.5)
    te, je = TC.CascadeEngine(pats, ci, "cpu"), JC.CascadeEngine(pats, ci)
    passes, dispatches = _count_passes(
        monkeypatch, JC, ("_cascade_jit", "_cascade_generic_jit"))
    got, want = te.match_pairs(hay), je.match_pairs(hay)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert te._caps == je._caps and te.last_caps == je.last_caps
    assert passes == dispatches and passes[0] == 256 < passes[1]
    assert te.last_caps[1] > 256 and te.last_caps[2] > 1024
    assert te.count_matches(hay) == len(got[0]) == len(
        brute_pairs(pats, hay)[0])


def test_signatures_match_the_c_entry_points():
    """The ctypes argument codes of each entry point of csrc/candidates.cu,
    the caller's stream last, read from the source: one code per C
    parameter (a pointer or the stream c_void_p, an int c_int, a long
    long c_longlong)."""
    import ctypes
    import re

    with open(CK.LIBRARY.src) as f:
        src = f.read()
    code = {"int": ctypes.c_int, "long long": ctypes.c_longlong}
    for name, argtypes in CK.LIBRARY.signatures.items():
        params = re.search(rf"\nint {name}\(([^)]*)\)", src).group(1)
        want = []
        for decl in params.split(","):
            typ = " ".join(decl.split()[:-1]).replace("const ", "")
            want.append(ctypes.c_void_p if "*" in typ else code[typ])
        assert want[-1] is ctypes.c_void_p  # the stream
        assert list(argtypes) == want, name
