"""The port's staged engine held against the JAX package's.

Same inputs, made from seeds with numpy, go through the JAX package's
Pallas kernels G3 (`_make_flags_kernel`) and G4 (`_make_gathered_kernel`),
run in interpret mode on the CPU as its own tests run them, and through
the plain PyTorch versions of the port's Hopper kernels; then through both
packages' staged pipelines and engines. G3 and the pipelines are held in
`tests/test_torch_staged_kernels.py`, on this file's inputs, so that they
run on another test worker than the engines. The Pallas kernels get the JAX
package's own inputs (its stream-major layouts from `prepare`, its gather
of the candidate rows by `jnp.take`); the port's kernels read the upload's
row-major words and the candidates' stream ids. Every output is an
integer: the tolerance is exact equality of tables, layouts, raw flags,
candidate ids, per-lane counts, raw end words, totals and (pid, end)
pairs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import ahocorasick_tpu.ops.staged as JS
import ahocorasick_tpu_torch.ops.bitap as TB
import ahocorasick_tpu_torch.ops.staged as TS
from ahocorasick_tpu_torch.ops import staged_kernels as SK
from test_torch_limb_sets import STAGED_SETS
from torch_suite import per_test_time_limit  # noqa: F401

PATS = [b"Sherlock Holmes", b"John Watson", b"Irene Adler",
        b"Inspector Lestrade", b"Professor Moriarty"]
L = TS.STAGED_L
R = 8


def plant(buf, at, pat):
    buf[at:at + len(pat)] = pat


def make_hay(n, seed=0, pats=PATS):
    """Sparse hits, matches straddling stream boundaries, matches whose
    fingerprint ends in the previous stream (in the next stream's halo)
    and one at the very start (stream 0)."""
    rng = np.random.default_rng(seed)
    buf = bytearray(rng.integers(97, 123, size=n, dtype=np.uint8).tobytes())
    for i, at in enumerate(range(1000, n - 64, 7919)):
        plant(buf, at, pats[i % len(pats)])
    for s in range(1, 6):
        for off in (1, 4, 7, 14):
            plant(buf, s * L - off, pats[off % len(pats)])
    plant(buf, 0, pats[0])
    return bytes(buf)


def _case(name):
    if name == "names":
        return PATS, make_hay(L * 1024 + 77), False
    if name == "case_insensitive":
        hay = bytearray(make_hay(L * 1024 + 5, seed=1))
        plant(hay, 50_000, b"sHERLOCK hOLMES")
        plant(hay, 3 * L - 2, b"iRENE aDLER")
        return PATS, bytes(hay), True
    if name == "long_pattern":
        # max_len 70: halo 128 bytes, so fingerprints can end deep in it.
        pats = PATS + [bytes(range(65, 91)) * 2 + b"abcdefghijklmnopqr"]
        hay = bytearray(make_hay(2 * L * 1024, seed=2))
        for s in (1, 9, 600):
            plant(hay, s * L - 40, pats[-1])
        return pats, bytes(hay), False
    if name == "w100":
        # 100 words of 8-16 bytes: Kf = 75 and K = 83 limbs, past the
        # register bucket of the port's kernels (their limb groups).
        pats = STAGED_SETS["w100"]
        return pats, make_hay(L * 1024 + 5, seed=3, pats=pats), False
    raise KeyError(name)


CASES = ["names", "case_insensitive", "long_pattern", "w100"]


def _engines(name):
    pats, hay, ci = _case(name)
    return JS.StagedEngine(pats, ci), TS.StagedEngine(pats, ci, "cpu"), hay


def _np(t):
    return np.asarray(t)


# ---------------------------------------------------------------------------
# Host tables, eligibility and layouts
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", CASES)
def test_tables_and_layouts_equal(name):
    jeng, teng, hay = _engines(name)
    for which in ("fp", "full"):
        jt, tt = getattr(jeng, which), getattr(teng, which)
        for field in ("k", "pad_byte", "end_limbs", "max_pattern_len"):
            assert getattr(tt, field) == getattr(jt, field), (which, field)
        for field in ("lo", "hi", "start", "end", "endbit_pid", "pid_rank"):
            np.testing.assert_array_equal(getattr(tt, field),
                                          getattr(jt, field))
    assert teng.halo == jeng.halo
    for n in (1, 1000, L * 1024, (1 << 22) + 3, 64 << 20, (64 << 20) + 1):
        assert teng._layout(n) == jeng._layout(n), n
    jph, tph = jeng.prepare(hay), teng.prepare(hay)
    assert (tph.n, tph.L, tph.Lc, tph.tiles) == (jph.n, jph.L, jph.Lc,
                                                 jph.tiles)
    rows = tph.rows.numpy()
    np.testing.assert_array_equal(rows, _np(jph.rows))
    # The halo of stream s is the tail of row s - 1 (stream 0's that of the
    # last row): the JAX package's halo rows, read in place.
    Hw = teng.halo // 4
    np.testing.assert_array_equal(np.roll(rows, 1, axis=0)[:, -Hw:],
                                  _np(jph.hrows))
    # The plain versions' stream-major copies are the JAX package's.
    halo, body = SK.stream_major(tph.rows, teng.halo)
    np.testing.assert_array_equal(halo.numpy(), _np(jph.halo_a))
    np.testing.assert_array_equal(body.numpy(), _np(jph.body))


def test_eligibility_equals_jax():
    sets = [PATS, [b"ab", b"cd"], [b"abcdefgh"] * 3, _case("long_pattern")[0],
            [bytes(range(8 * i, 8 * i + 8)) for i in range(32)],
            [b""], [b"x" * 3000], *STAGED_SETS.values()]
    for pats in sets:
        for n in (1 << 10, TS.STAGED_MIN - 1, TS.STAGED_MIN, 1 << 26):
            for ci in (False, True):
                assert TS.StagedEngine.eligible(pats, n, ci) == \
                    JS.StagedEngine.eligible(pats, n, ci), (pats[:2], n, ci)


# ---------------------------------------------------------------------------
# Kernels: plain versions against the Pallas kernels (G3 in
# test_torch_staged_kernels.py)
# ---------------------------------------------------------------------------
def _jax_gathered(jeng, jph, sid, ghal, gbody, nn, extract):
    t = jeng.full
    Ke = len(t.end_limbs)
    kern = JS._make_gathered_kernel(*t.baked_key(), t.k, jph.L, jph.Lc,
                                    jeng.halo, extract=extract)
    tiles_c = sid.shape[0]
    Hw, Wc = jeng.halo // 4, jph.Lc // 4
    out_specs = [pl.BlockSpec((1, R, 128), lambda i, j: (i, 0, 0),
                              memory_space=pltpu.VMEM)]
    out_shape = [jax.ShapeDtypeStruct((tiles_c, R, 128), jnp.int32)]
    if extract:
        out_specs.append(pl.BlockSpec((1, jph.Lc, Ke, R, 128),
                                      lambda i, j: (i, j, 0, 0, 0),
                                      memory_space=pltpu.VMEM))
        out_shape.append(jax.ShapeDtypeStruct((tiles_c, jph.L, Ke, R, 128),
                                              jnp.int32))
    res = pl.pallas_call(
        kern, grid=(tiles_c, jph.L // jph.Lc),
        in_specs=[
            pl.BlockSpec(memory_space=pltpu.SMEM),
            pl.BlockSpec((1, R, 128), lambda i, j: (i, 0, 0),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((Hw, R, 128), lambda i, j: (0, i, 0),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((Wc, R, 128), lambda i, j: (j, i, 0),
                         memory_space=pltpu.VMEM),
        ],
        out_specs=out_specs, out_shape=out_shape,
        scratch_shapes=[pltpu.VMEM((t.k, R, 128), jnp.int32)],
        interpret=True,
    )(jnp.asarray(nn, jnp.int32), jnp.asarray(sid), jnp.asarray(ghal),
      jnp.asarray(gbody))
    return [_np(r) for r in res]


@pytest.mark.parametrize("extract", [False, True], ids=["count", "extract"])
@pytest.mark.parametrize("name", ["names", "long_pattern"])
def test_gathered_plain_equals_pallas(name, extract):
    """Per-lane counts and raw end words over gathered candidates, with
    pad lanes (sid -1), original stream 0 and a shifted count window."""
    jeng, teng, hay = _engines(name)
    jph, tph = jeng.prepare(hay), teng.prepare(hay)
    ncand, cand = teng.candidates(tph, 1024)
    assert 5 < ncand < 1024 and int(cand[0]) == 0 and int(cand[-1]) == -1
    sid = cand.to(torch.int32).reshape(1, 8, 128)
    # The JAX package's stage-2 input (staged.py:284-288): the candidate
    # rows and halo rows, pad lanes reading stream 0's, stream-major.
    safe = jnp.maximum(jnp.asarray(cand.numpy()), 0)
    Hw, Wb = jeng.halo // 4, jph.L // 4
    ghal = jnp.take(jph.hrows, safe, axis=0).T.reshape(Hw, 8, 128)
    gbody = jnp.take(jph.rows, safe, axis=0).T.reshape(Wb, 8, 128)
    nn = (3, len(hay) - 2)
    want = _jax_gathered(jeng, jph, sid.numpy(), ghal, gbody, nn, extract)
    _, (lo, hi, sm, em) = teng._args()
    got = SK.staged_gathered_plain(lo, hi, sm, em, teng.full.end_limbs, sid,
                                   tph.rows, teng.halo, *nn, extract)
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    if extract:
        np.testing.assert_array_equal(got[1].numpy(), want[1])
        assert (want[1] != 0).any()
    assert want[0].sum() > 0 and (want[0].reshape(-1)[ncand:] == 0).all()


# ---------------------------------------------------------------------------
# Engines
# ---------------------------------------------------------------------------
def _pairs_equal(a, b):
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


@pytest.mark.parametrize("name", CASES)
def test_engine_equals_jax_and_bitap(name):
    jeng, teng, hay = _engines(name)
    pats, _, ci = _case(name)
    bit = TB.BitapEngine(pats, ci, "cpu")
    want = bit.count_matches(hay)
    assert teng.count_matches(hay) == jeng.count_matches(hay) == want > 0
    got = teng.match_pairs(hay)
    _pairs_equal(got, jeng.match_pairs(hay))
    _pairs_equal(got, bit.match_pairs(hay))
    assert (teng._cap_s, teng._cap_w) == (jeng._cap_s, jeng._cap_w)
    # Repeated search on a prepared layout: settled caps, same result.
    ph = teng.prepare(hay)
    _pairs_equal(teng.match_pairs(ph), got)
    assert teng.count_matches(ph) == want


def test_cap_growth_equals_jax():
    """More candidates than the first cap (1024 lanes for 2048 streams):
    both engines grow the cap to the same power of two and stay exact."""
    n = 2 * L * 1024
    buf = bytearray(make_hay(n, seed=5))
    for s in range(n // L):  # three quarters of the streams flagged
        if s % 4:
            plant(buf, s * L + 100, PATS[s % 5])
    hay = bytes(buf)
    jeng, teng = JS.StagedEngine(PATS, False), TS.StagedEngine(PATS, False,
                                                              "cpu")
    bit = TB.BitapEngine(PATS, False, "cpu")
    assert teng.count_matches(hay) == jeng.count_matches(hay) == \
        bit.count_matches(hay)
    got = teng.match_pairs(hay)
    _pairs_equal(got, bit.match_pairs(hay))
    _pairs_equal(got, jeng.match_pairs(hay))
    assert teng._cap_s == jeng._cap_s == 2048
    assert teng._cap_w == jeng._cap_w


def test_overflow_returns_none():
    """Every stream flagged on a non-power-of-two stream count: the cap
    cannot grow past it, so both engines return None (the facade then
    takes the single-pass engine; see test_torch_routes)."""
    pats = [b"Sherlock Holmes"]
    n = 3 * L * 1024
    hay = (b"Sherlock Holmes " * (n // 16))[:n]
    jeng, teng = JS.StagedEngine(pats, False), TS.StagedEngine(pats, False,
                                                              "cpu")
    assert teng._layout(n)[2] == 3
    assert teng.count_matches(hay) is None
    assert jeng.count_matches(hay) is None
    assert teng.match_pairs(hay) is None and jeng.match_pairs(hay) is None


def test_empty_haystack():
    teng = TS.StagedEngine(PATS, False, "cpu")
    assert teng.count_matches(b"") == 0
    assert len(teng.match_pairs(b"")[0]) == 0


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------
def test_wrappers_on_cpu_use_plain_and_count_nothing():
    _, teng, hay = _engines("names")
    ph = teng.prepare(hay)
    SK.reset_counts()
    (flo, fhi, fsm, fem), (lo, hi, sm, em) = teng._args()
    flags = SK.staged_flags(flo, fhi, fsm, fem, ph.rows, teng.halo)
    np.testing.assert_array_equal(
        flags.numpy(),
        SK.staged_flags_plain(flo, fhi, fsm, fem, ph.rows,
                              teng.halo).numpy())
    _, cand = teng.candidates(ph, 1024)
    sid = cand.to(torch.int32).reshape(1, 8, 128)
    SK.staged_gathered(lo, hi, sm, em, teng.full.end_limbs, sid, ph.rows,
                       teng.halo, 0, ph.n, False)
    assert SK.flags_launches == 0 and SK.gathered_launches == 0


def test_wrapper_rejects_bad_sid():
    _, teng, hay = _engines("names")
    ph = teng.prepare(hay)
    _, (lo, hi, sm, em) = teng._args()
    _, cand = teng.candidates(ph, 1024)
    sid = cand.to(torch.int32).reshape(1, 8, 128)
    with pytest.raises(TypeError):
        SK.staged_gathered(lo, hi, sm, em, teng.full.end_limbs, sid.long(),
                           ph.rows, teng.halo, 0, ph.n, False)
    with pytest.raises(ValueError):
        SK.staged_gathered(lo, hi, sm, em, teng.full.end_limbs,
                           sid.reshape(-1)[:512].contiguous(), ph.rows,
                           teng.halo, 0, ph.n, False)


@pytest.mark.parametrize("bad", ["int64", "strided", "not_whole_tiles",
                                 "ragged_slot", "halo_over_row",
                                 "halo_unaligned"])
def test_wrappers_reject_bad_rows(bad):
    """The kernels read whole 32-byte slots of rows [tiles*1024, Wb] and a
    halo of whole words within one row; anything else raises before a
    launch."""
    _, teng, hay = _engines("names")
    ph = teng.prepare(hay)
    flo, fhi, fsm, fem = teng._args()[0]
    rows, H = ph.rows, teng.halo
    if bad == "int64":
        rows = rows.long()
    elif bad == "strided":
        rows = rows[:, ::2]
    elif bad == "not_whole_tiles":
        rows = rows[:1000].contiguous()
    elif bad == "ragged_slot":
        rows = rows[:, :124].contiguous()
    elif bad == "halo_over_row":
        H = 4 * rows.shape[1] + 4
    else:
        H = 30
    with pytest.raises(TypeError if bad == "int64" else ValueError):
        SK.staged_flags(flo, fhi, fsm, fem, rows, H)
