"""The port's facade routes held against the JAX facade's.

The routing thresholds (`STAGED_MIN`, `FP_DV_MIN`, `FP_BAKED_MIN`) are
lowered in both packages' modules so every route is reached at a small
size. Each case asserts which engine served the call (a spy on the port's
engine methods) and that the `(pattern, start, end)` triples and counts
equal the JAX facade's, whose Pallas kernels run in interpret mode.
Outputs are integers: the tolerance is exact equality.
"""

import numpy as np
import pytest

import ahocorasick_tpu as J
import ahocorasick_tpu.ops.fingerprint as JF
import ahocorasick_tpu.ops.staged as JS
import ahocorasick_tpu_torch as T
import ahocorasick_tpu_torch.ops.bitap as TB
import ahocorasick_tpu_torch.ops.fingerprint as TF
import ahocorasick_tpu_torch.ops.staged as TS

NAMES = ["Sherlock Holmes", "John Watson", "Irene Adler",
         "Inspector Lestrade", "Professor Moriarty"]
L = TS.STAGED_L


def _hay(n, seed, pats, every=7919):
    rng = np.random.default_rng(seed)
    buf = bytearray(rng.integers(97, 123, size=n, dtype=np.uint8).tobytes())
    for i, at in enumerate(range(333, n - 80, every)):
        p = pats[i % len(pats)]
        buf[at:at + len(p)] = p
    for s in range(1, 9):  # straddling stream boundaries
        p = pats[s % len(pats)]
        buf[s * L - 3:s * L - 3 + len(p)] = p
    return bytes(buf)


@pytest.fixture
def spy(monkeypatch):
    """Records (engine class, method) of each engine call the facade
    makes (calls an engine makes to itself are not recorded)."""
    calls = []
    depth = [0]
    for cls in (TB.BitapEngine, TS.StagedEngine, TF.FingerprintEngine):
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


@pytest.fixture
def small_thresholds(monkeypatch):
    """Staged from 256 KiB; device verify from 0; pad-byte fingerprint
    kernel from 256 KiB, in both packages."""
    for mod in (JS, TS):
        monkeypatch.setattr(mod, "STAGED_MIN", 1 << 18)
    for mod in (JF, TF):
        monkeypatch.setattr(mod, "FP_DV_MIN", 0)
        monkeypatch.setattr(mod, "FP_BAKED_MIN", 1 << 18)


def _triples(it):
    return [m.astuple() for m in it]


def _both(pats, **kw):
    return (J.AhoCorasick(pats, **kw),
            T.AhoCorasick(pats, device="cpu", **kw))


def _same_overlapping(jac, tac, hay):
    want = _triples(jac.find_overlapping_iter(J.Input(hay)))
    assert _triples(tac.find_overlapping_iter(T.Input(hay))) == want
    return want


# ---------------------------------------------------------------------------
# Bit-parallel-eligible sets
# ---------------------------------------------------------------------------
def test_count_takes_staged(small_thresholds, spy):
    jac, tac = _both(NAMES)
    hay = _hay(L * 1024, 1, [p.encode() for p in NAMES])
    assert tac.count_matches(hay) == jac.count_matches(J.Input(hay)) > 0
    assert spy == [("StagedEngine", "count_matches")]
    assert jac._staged is not None and tac._staged is not None


def test_count_below_staged_min_takes_bitap(small_thresholds, spy):
    jac, tac = _both(NAMES)
    hay = _hay(200_000, 2, [p.encode() for p in NAMES])
    assert tac.count_matches(hay) == jac.count_matches(J.Input(hay)) > 0
    assert spy == [("BitapEngine", "count_matches")]


def test_staged_overflow_falls_back_to_bitap(small_thresholds, spy):
    """Every stream flagged on a three-tile layout: the staged count
    returns None and the bit-parallel count serves the call."""
    n = 3 * L * 1024
    hay = (b"Sherlock Holmes " * (n // 16))[:n]
    jac, tac = _both(NAMES)
    assert tac.count_matches(hay) == jac.count_matches(J.Input(hay)) == \
        n // 16
    assert spy == [("StagedEngine", "count_matches"),
                   ("BitapEngine", "count_matches")]


@pytest.mark.parametrize("ci", [False, True])
def test_extraction_takes_fingerprint_fused(small_thresholds, spy, ci):
    """find_iter and find_overlapping_iter of an eligible set: the
    fingerprint engine's fused extract (device verify, pad-byte kernel
    at this size), as in the JAX facade."""
    jac, tac = _both(NAMES, ascii_case_insensitive=ci)
    hay = _hay(300_000, 3, [p.encode() for p in NAMES])
    if ci:
        hay = hay.replace(b"Irene", b"iRENE")
    assert len(_same_overlapping(jac, tac, hay)) > 30
    assert _triples(tac.find_iter(T.Input(hay))) == _triples(
        jac.find_iter(J.Input(hay)))
    assert set(spy) == {("FingerprintEngine", "match_pairs")}
    assert tac._fp.dv is not None and tac._fp.prepare(hay).baked
    assert tac._fp._caps == jac._fp._caps


def test_long_pattern_takes_staged_extract(small_thresholds, spy):
    """A pattern longer than W_MAX = 64 bytes: no device verify, so the
    staged extract serves the eligible set."""
    long = "ABCDEFGHIJKLMNOPQRSTUVWXYZ" * 2 + "abcdefghijklmnopqr"
    pats = NAMES + [long]
    jac, tac = _both(pats)
    hay = _hay(L * 1024, 4, [p.encode() for p in pats], every=3001)
    assert len(_same_overlapping(jac, tac, hay)) > 50
    assert tac._fp is not None and tac._fp.dv is None
    assert spy == [("StagedEngine", "match_pairs")]
    assert tac._staged._cap_s == jac._staged._cap_s > 0


def test_bitap_mode_skips_filter_extracts(small_thresholds, spy):
    jac, tac = _both(NAMES, engine="bitap")
    hay = _hay(L * 1024, 5, [p.encode() for p in NAMES])
    _same_overlapping(jac, tac, hay)
    assert spy == [("BitapEngine", "match_pairs")]


def test_below_device_threshold_takes_native_walk(spy):
    jac, tac = _both(NAMES)
    hay = b"x Sherlock Holmes y"
    _same_overlapping(jac, tac, hay)
    assert spy == []


# ---------------------------------------------------------------------------
# Sets beyond the bit-parallel engine
# ---------------------------------------------------------------------------
def _dictionary(seed, count=400, lmin=4, lmax=12, letters=8):
    rng = np.random.default_rng(seed)
    pats = set()
    while len(pats) < count:
        ln = int(rng.integers(lmin, lmax + 1))
        pats.add(rng.integers(97, 97 + letters, ln, dtype=np.uint8)
                 .tobytes())
    return sorted(pats)


@pytest.mark.parametrize("dv_min", [0, 1 << 40], ids=["device", "host"])
def test_large_set_takes_fingerprint(dv_min, monkeypatch, spy):
    for mod in (JF, TF):
        monkeypatch.setattr(mod, "FP_DV_MIN", dv_min)
    pats = _dictionary(7, 260, 6, 12, letters=16)
    assert not TB.BitapEngine.eligible(pats)
    jac, tac = _both(pats, device_threshold=1024)
    hay = _hay(1 << 14, 8, pats, every=97)
    want = _same_overlapping(jac, tac, hay)
    assert len(want) > 100
    assert tac.count_matches(hay) == jac.count_matches(J.Input(hay))
    assert set(spy) == {("FingerprintEngine", "match_pairs"),
                        ("FingerprintEngine", "count_matches")}


def test_hostile_fingerprint_falls_back_to_native_walk(monkeypatch, spy):
    for mod in (JF, TF):
        monkeypatch.setattr(mod, "CAND_FLOOR", 64)
    pats = [bytes([c]) * 4 for c in b"abcdefgh"] + _dictionary(31, 400, 5, 9)
    hay = b"aaaaaaaa" * 512
    jac, tac = _both(pats, device_threshold=1024)
    assert tac.count_matches(hay) == jac.count_matches(J.Input(hay))
    assert tac._fp.hostile and jac._fp.hostile
    # Once hostile, the facade no longer offers the engine.
    _same_overlapping(jac, tac, hay)
    assert spy == [("FingerprintEngine", "count_matches")]


def test_forced_fingerprint_on_an_eligible_set(spy):
    jac, tac = _both(NAMES, engine="fingerprint")
    hay = _hay(20_000, 9, [p.encode() for p in NAMES], every=501)
    _same_overlapping(jac, tac, hay)
    assert tac.count_matches(hay) == jac.count_matches(J.Input(hay))
    assert tac._bitap_engine() is None
    assert {c[0] for c in spy} == {"FingerprintEngine"}
