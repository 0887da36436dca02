"""The port's bit-parallel engine held against the JAX package's.

Same inputs, made from seeds with numpy, go through the JAX package's
Pallas kernels (interpret mode on the CPU, as its own tests run them) and
through the plain PyTorch versions of the port's Hopper kernels G1
(table-generic, position-masked) and G2 (pad-byte padded, end-bearing
limbs only). Every output is an integer: the tolerance is exact equality
of per-stream counts, raw end words, totals and (pid, end) pairs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import ahocorasick_tpu.ops.bitap as JB
import ahocorasick_tpu_torch.ops.bitap as TB
from ahocorasick_tpu_torch.ops import bitap_kernels as TK
from torch_suite import per_test_time_limit  # noqa: F401

NAMES = [b"Sherlock Holmes", b"John Watson", b"Irene Adler",
         b"Inspector Lestrade", b"Professor Moriarty"]


def _english(n, seed):
    rng = np.random.default_rng(seed)
    words = np.array(b"the quick brown fox jumps over lazy dog time of".split()
                     + NAMES, dtype=object)
    p = np.full(len(words), 0.97 / (len(words) - len(NAMES)))
    p[-len(NAMES):] = 0.03 / len(NAMES)
    picks = rng.choice(len(words), size=n // 3, p=p)
    return b" ".join(words[picks].tolist())[:n]


def _case(name):
    rng = np.random.default_rng(sum(name.encode()))
    if name == "boundaries":
        pat = b"boundary!"
        hay = bytearray(b"." * 8192)
        for pos in [0, 13, 511, 2043, 4095, 8183]:
            hay[pos:pos + len(pat)] = pat
        return [pat, b".."], bytes(hay), False
    if name == "long_halo":
        pat = bytes(range(65, 65 + 50))
        return [pat], b"z" * 3000 + pat + b"z" * 1000 + pat, False
    if name == "case_insensitive":
        return [b"aBc", b"XY"], b"AbC abc ABC xy Xy xbc " * 40, True
    if name == "no_pad_byte":
        pats = [bytes(range(8 * i, 8 * i + 8)) for i in range(32)]
        hay = bytearray(rng.integers(0, 256, 3000, dtype=np.uint8).tobytes())
        for i, pos in enumerate([5, 700, 1499, 2990]):
            hay[pos:pos + 8] = pats[(7 * i) % 32]
        return pats, bytes(hay), False
    if name == "single_tile":
        pats = [b"abra", b"cadabra", b"bra", b"Abc"]
        hay = bytes(rng.choice([97, 98, 99, 100, 114, 65],
                               size=9000).astype(np.uint8))
        return pats, hay, False
    if name == "multi_tile":
        return NAMES, _english(300_000, 7), False
    if name == "k_over_64":
        # Decollided packing spreads 92 three-byte chains over 65 limbs.
        pats = [bytes([i]) + b"ab" for i in range(92)]
        return pats, bytes([5]) + b"ab" + bytes([91]) + b"abab", False
    raise KeyError(name)


CASES = ["boundaries", "long_halo", "case_insensitive", "no_pad_byte",
         "single_tile", "multi_tile", "k_over_64"]
# The K > 64 set compiles its interpret-mode kernel for minutes, so it
# gets one JAX call of its own (test_k_over_64_generic_equals_pallas, in
# tests/test_torch_limb_groups.py).
KERNEL_CASES = [c for c in CASES if c != "k_over_64"]
PAD_CASES = [c for c in KERNEL_CASES if c != "no_pad_byte"]


def _engines(name):
    pats, hay, ci = _case(name)
    return JB.BitapEngine(pats, ci), TB.BitapEngine(pats, ci, "cpu"), hay


def _packed(jeng, hay, pad):
    """Stream-major halo/body from the JAX package, as numpy arrays."""
    L, Lc, tiles = jeng._layout(max(len(hay), 1))
    x32 = jeng._pack(hay, L, tiles, pad=pad)
    halo, body = JB._to_stream_major(x32, L, tiles, jeng.halo)
    return L, Lc, tiles, np.asarray(halo), np.asarray(body)


def _jax_raw(t, L, Lc, H, tiles, halo, body, baked, extract, nn=None):
    """Per-stream counts and raw end words of the JAX kernels, from the
    same pallas_call wiring as `_bitap_call` / `_baked_jit`."""
    K, R = t.k, JB.R
    Hw, Wc = H // 4, Lc // 4
    vmem = pltpu.VMEM
    halo_spec = pl.BlockSpec((max(Hw, 1), R, 128), lambda i, j: (0, i, 0),
                             memory_space=vmem)
    body_spec = pl.BlockSpec((Wc, R, 128), lambda i, j: (j, i, 0),
                             memory_space=vmem)
    if baked:
        kernel = JB._make_baked_kernel(*t.baked_key(), K, Lc, H, extract)
        kd = len(t.end_limbs)
        in_specs = [halo_spec, body_spec]
        args = (halo, body)
    else:
        kernel = JB._make_kernel(K, L, Lc, H, extract)
        kd = K
        in_specs = [pl.BlockSpec(memory_space=pltpu.SMEM)] * 5 + [
            halo_spec, body_spec]
        args = tuple(t.device_args()) + (jnp.asarray(nn, jnp.int32),
                                         halo, body)
    out_shape = [jax_struct((tiles, R, 128))]
    out_specs = [pl.BlockSpec((1, R, 128), lambda i, j: (i, 0, 0),
                              memory_space=vmem)]
    if extract:
        out_shape.append(jax_struct((tiles, L, kd, R, 128)))
        out_specs.append(pl.BlockSpec((1, Lc, kd, R, 128),
                                      lambda i, j: (i, j, 0, 0, 0),
                                      memory_space=vmem))
    res = pl.pallas_call(
        kernel, grid=(tiles, L // Lc), in_specs=in_specs,
        out_specs=out_specs, out_shape=out_shape,
        scratch_shapes=[vmem((K, R, 128), jnp.int32)], interpret=True,
    )(*args)
    return [np.asarray(r) for r in res]


def jax_struct(shape):
    return jax.ShapeDtypeStruct(shape, jnp.int32)


def _port_tables(teng):
    return teng.tables.device_tensors("cpu")


# ---------------------------------------------------------------------------
# Host tables and layouts
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", CASES)
def test_tables_equal(name):
    jeng, teng, _ = _engines(name)
    jt, tt = jeng.tables, teng.tables
    for field in ("k", "pad_byte", "end_limbs", "max_pattern_len"):
        assert getattr(tt, field) == getattr(jt, field), field
    for field in ("lo", "hi", "start", "end", "endbit_pid", "pid_rank"):
        np.testing.assert_array_equal(getattr(tt, field),
                                      getattr(jt, field), err_msg=field)
    assert teng.halo == jeng.halo


def test_k_over_64_limbs():
    """Eligibility bounds total bytes only; decollided packing can need
    more than MAX_LIMBS limbs (256 three-byte patterns: K = 229)."""
    pats = [bytes([i]) + b"ab" for i in range(256)]
    assert TB.BitapEngine.eligible(pats)
    t = TB.BitapTables(pats, False)
    assert t.k == 229 and t.pad_byte is None
    jeng, teng, _ = _engines("k_over_64")
    assert teng.tables.k > TK.MAX_REG_LIMBS == TB.MAX_LIMBS


@pytest.mark.parametrize("name", CASES)
def test_layout_and_stream_major(name):
    jeng, teng, hay = _engines(name)
    for n in (1, 4, 1000, 1 << 17, 594915, 1 << 20, (1 << 26) + 5):
        assert teng._layout(n) == jeng._layout(n)[::2], n
    pad = jeng.tables.pad_byte or 0
    L, Lc, tiles, jhalo, jbody = _packed(jeng, hay, pad)
    ph = teng.prepare(hay, baked=bool(pad))
    assert (ph.L, ph.tiles) == (L, tiles)
    np.testing.assert_array_equal(ph.halo_a.numpy(), jhalo)
    np.testing.assert_array_equal(ph.body.numpy(), jbody)


# ---------------------------------------------------------------------------
# Kernels: plain versions against the Pallas kernels
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("extract", [False, True], ids=["count", "extract"])
@pytest.mark.parametrize("name", KERNEL_CASES)
def test_generic_plain_equals_pallas(name, extract):
    jeng, teng, hay = _engines(name)
    t = jeng.tables
    L, Lc, tiles, halo, body = _packed(jeng, hay, 0)
    lo, hi, sm, em = _port_tables(teng)
    n = len(hay)
    for n0 in (0, min(101, n - 1)):
        total, jwords = JB._bitap_call(
            *t.device_args(), jnp.asarray(halo), jnp.asarray(body),
            jnp.asarray([n0, n], jnp.int32), K=t.k, L=L, Lc=Lc,
            H=jeng.halo, tiles=tiles, extract=extract)
        counts, words = TK.bitap_scan_generic_plain(
            lo, hi, sm, em, _t(halo), _t(body), n0, n, extract)
        assert int(counts.sum()) == int(total)
        if extract:
            jwords = np.asarray(jwords)
            np.testing.assert_array_equal(words.numpy(), jwords)
            # Per-stream counts are the popcounts of each stream's words.
            np.testing.assert_array_equal(
                counts.numpy(), _popcount(jwords).sum(axis=(1, 2)))


def _popcount(a):
    b = np.ascontiguousarray(a).view(np.uint8)
    return np.unpackbits(b).reshape(a.shape + (32,)).sum(-1)


@pytest.mark.parametrize("extract", [False, True], ids=["count", "extract"])
@pytest.mark.parametrize("name", PAD_CASES)
def test_baked_plain_equals_pallas(name, extract):
    jeng, teng, hay = _engines(name)
    t = jeng.tables
    L, Lc, tiles, halo, body = _packed(jeng, hay, t.pad_byte)
    jres = _jax_raw(t, L, Lc, jeng.halo, tiles, halo, body, True, extract)
    lo, hi, sm, em = _port_tables(teng)
    counts, words = TK.bitap_scan_baked_plain(
        lo, hi, sm, em, teng.tables.end_limbs, _t(halo), _t(body), extract)
    np.testing.assert_array_equal(counts.numpy(), jres[0])
    fn = JB._baked_jit(t.baked_key(), t.k, L, Lc, jeng.halo, tiles, extract)
    if not extract:
        assert int(counts.sum()) == int(fn(jnp.asarray(halo),
                                           jnp.asarray(body)))
        return
    # Raw words before compaction, then the fused compaction's output.
    np.testing.assert_array_equal(words.numpy(), jres[1])
    flat = words.numpy().reshape(-1)
    nz = np.flatnonzero(flat)
    total, nnzw, idx, vals = fn(jnp.asarray(halo), jnp.asarray(body),
                                cap=max(64, JB._pow2(len(nz))))
    assert int(counts.sum()) == int(total) and int(nnzw) == len(nz)
    np.testing.assert_array_equal(np.asarray(idx)[:len(nz)], nz)
    np.testing.assert_array_equal(np.asarray(vals)[:len(nz)], flat[nz])


def _t(a):
    """A writable torch copy of a numpy (or JAX-backed) array."""
    return torch.from_numpy(np.array(a))


def test_wrappers_on_cpu_use_plain_and_count_nothing():
    jeng, teng, hay = _engines("single_tile")
    ph = teng.prepare(hay, baked=True)
    lo, hi, sm, em = _port_tables(teng)
    TK.reset_counts()
    got = TK.bitap_scan_baked(lo, hi, sm, em, teng.tables.end_limbs,
                              ph.halo_a, ph.body, True)
    want = TK.bitap_scan_baked_plain(lo, hi, sm, em, teng.tables.end_limbs,
                                     ph.halo_a, ph.body, True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    TK.bitap_scan_generic(lo, hi, sm, em, ph.halo_a, ph.body, 0, len(hay),
                          False)
    assert TK.generic_launches == 0 and TK.baked_launches == 0


def test_wrapper_rejects_bad_inputs():
    _, teng, hay = _engines("single_tile")
    ph = teng.prepare(hay)
    lo, hi, sm, em = _port_tables(teng)
    with pytest.raises(TypeError):
        TK.bitap_scan_generic(lo.long(), hi, sm, em, ph.halo_a, ph.body, 0,
                              1, False)
    with pytest.raises(ValueError):
        TK.bitap_scan_generic(lo, hi, sm, em, ph.halo_a,
                              ph.body.transpose(0, 1), 0, 1, False)
    with pytest.raises(ValueError):
        TK.bitap_scan_generic(lo[:, :8].contiguous(), hi, sm, em, ph.halo_a,
                              ph.body, 0, 1, False)


# ---------------------------------------------------------------------------
# Engine: counts and (pid, end) pairs against the JAX engine
# ---------------------------------------------------------------------------
def _engine_check(jeng, teng, hay):
    assert teng.count_matches(hay) == jeng.count_matches(hay)
    jp, je = jeng.match_pairs(hay)
    tp, te = teng.match_pairs(hay)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(te, je)
    return len(tp)


@pytest.mark.parametrize("name", KERNEL_CASES)
def test_engine_equals_jax(name):
    jeng, teng, hay = _engines(name)
    _engine_check(jeng, teng, hay)


@pytest.mark.parametrize("name", ["single_tile", "case_insensitive",
                                  "long_halo"])
def test_engine_pad_byte_kernel_equals_jax(name, monkeypatch):
    """BAKED_MIN at 0 in both packages routes the engine through the
    pad-byte kernel at a small size."""
    monkeypatch.setattr(JB, "BAKED_MIN", 0)
    monkeypatch.setattr(TB, "BAKED_MIN", 0)
    jeng, teng, hay = _engines(name)
    assert teng._use_baked(len(hay)) and jeng._use_baked(len(hay))
    assert _engine_check(jeng, teng, hay) > 0


def test_engine_chunked_extraction(monkeypatch):
    """The >MAX_EXTRACT_CHUNK split with a max_len-1 overlap, with matches
    straddling chunk boundaries, in both packages."""
    monkeypatch.setattr(JB, "MAX_EXTRACT_CHUNK", 1 << 14)
    monkeypatch.setattr(TB, "MAX_EXTRACT_CHUNK", 1 << 14)
    pats = [b"needle", b"edl"]
    hay = bytearray(np.random.default_rng(3).integers(
        97, 123, size=40000, dtype=np.uint8).tobytes())
    for p in [100, 8190, 8195, 16383, 30000, 39990]:
        hay[p:p + 6] = b"needle"
    hay = bytes(hay)
    assert _engine_check(JB.BitapEngine(pats, False),
                         TB.BitapEngine(pats, False, "cpu"), hay) >= 12


def test_engine_prepared_haystack_reuse():
    jeng, teng, hay = _engines("single_tile")
    ph = teng.prepare(hay)
    assert teng.count_matches(ph) == jeng.count_matches(hay)
    tp, te = teng.match_pairs(ph)
    jp, je = jeng.match_pairs(hay)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(te, je)
    assert teng.count_matches(b"") == 0
    assert len(teng.match_pairs(b"")[0]) == 0
