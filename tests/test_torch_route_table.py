"""The facade's whole route matrix, pinned as a table.

Five pattern sets (one the bit-parallel engine accepts; the same with a
pattern past the device verify's window and `STAGED_MIN` lowered; one of
more than 2,048 pattern bytes; the same with `CASCADE_MIN_PATTERNS`
lowered; the same with a family of 20 words under one 8-byte prefix, which
keeps the device verify out, and the host verify's candidate floor
lowered) are crossed with every `engine=` mode and a haystack below and
above `device_threshold`. Each case runs `find_iter`, `count_matches` and
`find_overlapping_iter` on one searcher, in that order, and pins the
`served.*` and `declined.*` counters of each call; a candidate-dense
haystack, searched several times, pins the `declined.*` fallbacks. Every
answer equals `engine="oracle"`'s. Everything runs on the CPU.
"""

import numpy as np
import pytest

import ahocorasick_tpu_torch as T
import ahocorasick_tpu_torch.ahocorasick as TA
import ahocorasick_tpu_torch.ops.cascade as TC
import ahocorasick_tpu_torch.ops.fingerprint as TF
import ahocorasick_tpu_torch.ops.staged as TS
from ahocorasick_tpu_torch.utils import log
from torch_suite import per_test_time_limit  # noqa: F401

NAMES = [b"Sherlock Holmes", b"John Watson", b"Irene Adler",
         b"Inspector Lestrade", b"Professor Moriarty"]
LONG = b"ABCDEFGHIJKLMNOPQRSTUVWXYZ" * 2 + b"abcdefghijklmnopqr"


def _dictionary(seed, count, lmin, lmax, letters):
    rng = np.random.default_rng(seed)
    pats = set()
    while len(pats) < count:
        ln = int(rng.integers(lmin, lmax + 1))
        pats.add(rng.integers(97, 97 + letters, ln, dtype=np.uint8)
                 .tobytes())
    return sorted(pats)


LARGE = _dictionary(7, 260, 6, 12, letters=16)
# More words under one 8-byte prefix than a device verify group holds
# (GMAX_CAP): the fingerprint engine verifies on the host.
FAMILY = [b"cadebfag" + bytes([97 + i % 16]) * (1 + i // 16)
          for i in range(20)]
# Between the candidates of _hay (85 at 5,000 B) and of _dense (795).
HOST_FLOOR = 256
# set: (patterns, module settings lowered for it)
SETS = {
    "bitap": (NAMES, {}),
    "staged": (NAMES + [LONG], {(TS, "STAGED_MIN"): 1024}),
    "large": (LARGE, {}),
    "cascade": (LARGE, {(TA, "CASCADE_MIN_PATTERNS"): 100}),
    "nodv": (sorted(set(LARGE) | set(FAMILY)),
             {(TF, "HOST_CAND_FLOOR"): HOST_FLOOR}),
}
SIZES = {"below": 1500, "above": 5000}  # device_threshold is 2048
OPS = ("find_iter", "count_matches", "find_overlapping_iter")


def _hay(n, pats, seed):
    rng = np.random.default_rng(seed)
    buf = bytearray(rng.integers(97, 123, size=n, dtype=np.uint8).tobytes())
    for i, at in enumerate(range(37, n - 80, 211)):
        p = pats[i % len(pats)]
        buf[at:at + len(p)] = p
    return bytes(buf)


def _dense(pats):
    """Patterns end to end: a candidate at almost every byte."""
    return b"".join(pats[i % len(pats)] for i in range(2000))[:5000]


def _answer(ac, op, hay):
    if op == "count_matches":
        return ac.count_matches(hay)
    return [m.astuple() for m in getattr(ac, op)(hay)]


def _want(pats, op, hay):
    oracle = T.AhoCorasick(pats, device="cpu", engine="oracle")
    if op == "count_matches":
        return len(list(oracle.find_overlapping_iter(hay)))
    return _answer(oracle, op, hay)


def _routed(ac, op, hay):
    """The call's answer and its served.* / declined.* counters."""
    log.take()
    log.enable()
    try:
        got = _answer(ac, op, hay)
    finally:
        log.disable()
    counters = {}
    for rec in log.take():
        for k, v in rec.items():
            if k.startswith(("served.", "declined.")):
                counters[k] = counters.get(k, 0) + v
    return got, counters


def _lower(monkeypatch, name):
    pats, lowered = SETS[name]
    for (mod, attr), v in lowered.items():
        monkeypatch.setattr(mod, attr, v)
    return pats


# (set, engine mode, size): the counters of find_iter, count_matches and
# find_overlapping_iter, in that order, on one searcher.
MATRIX = {
    ("bitap", "auto", "above"): [
        {"served.fingerprint_host": 1}, {"served.bitap": 1},
        {"served.fingerprint_host": 1}],
    ("bitap", "auto", "below"): [
        {"served.native_walk": 1}, {"served.bitap": 1},
        {"served.native_walk": 1}],
    ("bitap", "bitap", "above"): [
        {"served.bitap": 1}, {"served.bitap": 1}, {"served.bitap": 1}],
    ("bitap", "bitap", "below"): [
        {"served.bitap": 1}, {"served.bitap": 1}, {"served.bitap": 1}],
    ("bitap", "cascade", "above"): [
        {"served.cascade": 1}, {"served.cascade": 1}, {"served.cascade": 1}],
    ("bitap", "cascade", "below"): [
        {"served.cascade": 1}, {"served.cascade": 1}, {"served.cascade": 1}],
    ("bitap", "device-only", "above"): [
        {"served.fingerprint_host": 1}, {"served.bitap": 1},
        {"served.fingerprint_host": 1}],
    ("bitap", "device-only", "below"): [
        {"served.device_walk": 1}, {"served.bitap": 1},
        {"served.device_walk": 1}],
    ("bitap", "dfa-scan", "above"): [
        {"served.device_walk": 1}, {"served.device_walk": 1},
        {"served.device_walk": 1}],
    ("bitap", "dfa-scan", "below"): [
        {"served.host_walk": 1}, {"served.device_walk": 1},
        {"served.host_walk": 1}],
    ("bitap", "fingerprint", "above"): [
        {"served.fingerprint_host": 1}, {"served.fingerprint_host": 1},
        {"served.fingerprint_host": 1}],
    ("bitap", "fingerprint", "below"): [
        {"served.fingerprint_host": 1}, {"served.fingerprint_host": 1},
        {"served.fingerprint_host": 1}],
    ("bitap", "oracle", "above"): [
        {}, {"served.bitap": 1}, {}],
    ("bitap", "oracle", "below"): [
        {}, {"served.bitap": 1}, {}],
    ("cascade", "auto", "above"): [
        {"served.cascade": 1}, {"served.cascade": 1}, {"served.cascade": 1}],
    ("cascade", "auto", "below"): [
        {"served.native_walk": 1}, {"served.native_walk": 1},
        {"served.native_walk": 1}],
    ("cascade", "bitap", "above"): [
        {"served.native_walk": 1}, {"served.native_walk": 1},
        {"served.native_walk": 1}],
    ("cascade", "bitap", "below"): [
        {"served.native_walk": 1}, {"served.native_walk": 1},
        {"served.native_walk": 1}],
    ("cascade", "cascade", "above"): [
        {"served.cascade": 1}, {"served.cascade": 1}, {"served.cascade": 1}],
    ("cascade", "cascade", "below"): [
        {"served.cascade": 1}, {"served.cascade": 1}, {"served.cascade": 1}],
    ("cascade", "device-only", "above"): [
        {"served.cascade": 1}, {"served.cascade": 1}, {"served.cascade": 1}],
    ("cascade", "device-only", "below"): [
        {"served.device_walk": 1}, {"served.device_walk": 1},
        {"served.device_walk": 1}],
    ("cascade", "dfa-scan", "above"): [
        {"served.device_walk": 1}, {"served.device_walk": 1},
        {"served.device_walk": 1}],
    ("cascade", "dfa-scan", "below"): [
        {"served.host_walk": 1}, {"served.device_walk": 1},
        {"served.host_walk": 1}],
    ("cascade", "fingerprint", "above"): [
        {"served.fingerprint_host": 1}, {"served.fingerprint_host": 1},
        {"served.fingerprint_host": 1}],
    ("cascade", "fingerprint", "below"): [
        {"served.fingerprint_host": 1}, {"served.fingerprint_host": 1},
        {"served.fingerprint_host": 1}],
    ("cascade", "oracle", "above"): [
        {}, {"served.native_walk": 1}, {}],
    ("cascade", "oracle", "below"): [
        {}, {"served.native_walk": 1}, {}],
    ("large", "auto", "above"): [
        {"served.fingerprint_host": 1}, {"served.fingerprint_host": 1},
        {"served.fingerprint_host": 1}],
    ("large", "auto", "below"): [
        {"served.native_walk": 1}, {"served.native_walk": 1},
        {"served.native_walk": 1}],
    ("large", "bitap", "above"): [
        {"served.native_walk": 1}, {"served.native_walk": 1},
        {"served.native_walk": 1}],
    ("large", "bitap", "below"): [
        {"served.native_walk": 1}, {"served.native_walk": 1},
        {"served.native_walk": 1}],
    ("large", "cascade", "above"): [
        {"served.cascade": 1}, {"served.cascade": 1}, {"served.cascade": 1}],
    ("large", "cascade", "below"): [
        {"served.cascade": 1}, {"served.cascade": 1}, {"served.cascade": 1}],
    ("large", "device-only", "above"): [
        {"served.fingerprint_host": 1}, {"served.fingerprint_host": 1},
        {"served.fingerprint_host": 1}],
    ("large", "device-only", "below"): [
        {"served.device_walk": 1}, {"served.device_walk": 1},
        {"served.device_walk": 1}],
    ("large", "dfa-scan", "above"): [
        {"served.device_walk": 1}, {"served.device_walk": 1},
        {"served.device_walk": 1}],
    ("large", "dfa-scan", "below"): [
        {"served.host_walk": 1}, {"served.device_walk": 1},
        {"served.host_walk": 1}],
    ("large", "fingerprint", "above"): [
        {"served.fingerprint_host": 1}, {"served.fingerprint_host": 1},
        {"served.fingerprint_host": 1}],
    ("large", "fingerprint", "below"): [
        {"served.fingerprint_host": 1}, {"served.fingerprint_host": 1},
        {"served.fingerprint_host": 1}],
    ("large", "oracle", "above"): [
        {}, {"served.native_walk": 1}, {}],
    ("large", "oracle", "below"): [
        {}, {"served.native_walk": 1}, {}],
    ("nodv", "auto", "above"): [
        {"served.fingerprint_host": 1}, {"served.fingerprint_host": 1},
        {"served.fingerprint_host": 1}],
    ("nodv", "auto", "below"): [
        {"served.native_walk": 1}, {"served.native_walk": 1},
        {"served.native_walk": 1}],
    ("nodv", "bitap", "above"): [
        {"served.native_walk": 1}, {"served.native_walk": 1},
        {"served.native_walk": 1}],
    ("nodv", "bitap", "below"): [
        {"served.native_walk": 1}, {"served.native_walk": 1},
        {"served.native_walk": 1}],
    ("nodv", "cascade", "above"): [
        {"served.cascade": 1}, {"served.cascade": 1}, {"served.cascade": 1}],
    ("nodv", "cascade", "below"): [
        {"served.cascade": 1}, {"served.cascade": 1}, {"served.cascade": 1}],
    ("nodv", "device-only", "above"): [
        {"served.fingerprint_host": 1}, {"served.fingerprint_host": 1},
        {"served.fingerprint_host": 1}],
    ("nodv", "device-only", "below"): [
        {"served.device_walk": 1}, {"served.device_walk": 1},
        {"served.device_walk": 1}],
    ("nodv", "dfa-scan", "above"): [
        {"served.device_walk": 1}, {"served.device_walk": 1},
        {"served.device_walk": 1}],
    ("nodv", "dfa-scan", "below"): [
        {"served.host_walk": 1}, {"served.device_walk": 1},
        {"served.host_walk": 1}],
    ("nodv", "fingerprint", "above"): [
        {"served.fingerprint_host": 1}, {"served.fingerprint_host": 1},
        {"served.fingerprint_host": 1}],
    ("nodv", "fingerprint", "below"): [
        {"served.fingerprint_host": 1}, {"served.fingerprint_host": 1},
        {"served.fingerprint_host": 1}],
    ("nodv", "oracle", "above"): [
        {}, {"served.native_walk": 1}, {}],
    ("nodv", "oracle", "below"): [
        {}, {"served.native_walk": 1}, {}],
    ("staged", "auto", "above"): [
        {"served.staged": 1}, {"served.staged": 1}, {"served.staged": 1}],
    ("staged", "auto", "below"): [
        {"served.native_walk": 1}, {"served.staged": 1},
        {"served.native_walk": 1}],
    ("staged", "bitap", "above"): [
        {"served.bitap": 1}, {"served.staged": 1}, {"served.bitap": 1}],
    ("staged", "bitap", "below"): [
        {"served.bitap": 1}, {"served.staged": 1}, {"served.bitap": 1}],
    ("staged", "cascade", "above"): [
        {"served.cascade": 1}, {"served.cascade": 1}, {"served.cascade": 1}],
    ("staged", "cascade", "below"): [
        {"served.cascade": 1}, {"served.cascade": 1}, {"served.cascade": 1}],
    ("staged", "device-only", "above"): [
        {"served.bitap": 1}, {"served.bitap": 1}, {"served.bitap": 1}],
    ("staged", "device-only", "below"): [
        {"served.device_walk": 1}, {"served.bitap": 1},
        {"served.device_walk": 1}],
    ("staged", "dfa-scan", "above"): [
        {"served.device_walk": 1}, {"served.device_walk": 1},
        {"served.device_walk": 1}],
    ("staged", "dfa-scan", "below"): [
        {"served.host_walk": 1}, {"served.device_walk": 1},
        {"served.host_walk": 1}],
    ("staged", "fingerprint", "above"): [
        {"served.fingerprint_host": 1}, {"served.fingerprint_host": 1},
        {"served.fingerprint_host": 1}],
    ("staged", "fingerprint", "below"): [
        {"served.fingerprint_host": 1}, {"served.fingerprint_host": 1},
        {"served.fingerprint_host": 1}],
    ("staged", "oracle", "above"): [
        {}, {"served.bitap": 1}, {}],
    ("staged", "oracle", "below"): [
        {}, {"served.bitap": 1}, {}],
}


@pytest.mark.parametrize("size", sorted(SIZES))
@pytest.mark.parametrize("mode", T.ahocorasick.ENGINE_MODES)
@pytest.mark.parametrize("name", sorted(SETS))
def test_route_matrix(name, mode, size, monkeypatch):
    pats = _lower(monkeypatch, name)
    hay = _hay(SIZES[size], pats, seed=len(name) + SIZES[size])
    ac = T.AhoCorasick(pats, device="cpu", engine=mode)
    routes = []
    for op in OPS:
        got, counters = _routed(ac, op, hay)
        assert got == _want(pats, op, hay), op
        routes.append(counters)
    assert routes == MATRIX[name, mode, size]


# (set, engine mode, hostile): the counters of each call of DENSE_CALLS on
# one searcher over a candidate-dense haystack, with the hostile limit of
# the fingerprint engine, the cascade or both lowered (the "nodv" set's
# fingerprint engine declines by the host verify's limit in each). Under
# `auto`, counts that a filter engine found dense take the device walk,
# extractions the native walk.
DENSE_CALLS = ("count_matches", "count_matches", "find_overlapping_iter",
               "count_matches")
HOSTILE = {"fingerprint": (TF,), "cascade": (TC,), "both": (TF, TC)}
DENSE = {
    ("cascade", "auto", "both"): [
        {"declined.cascade": 1, "declined.fingerprint": 1,
         "served.device_walk": 1},
        {"declined.fingerprint": 1, "declined.cascade": 1,
         "served.device_walk": 1},
        {"declined.fingerprint": 1, "declined.cascade": 1,
         "served.native_walk": 1},
        {"declined.fingerprint": 1, "declined.cascade": 1,
         "served.device_walk": 1}],
    ("cascade", "auto", "cascade"): [
        {"declined.cascade": 1, "served.fingerprint_host": 1},
        {"declined.cascade": 1, "served.fingerprint_host": 1},
        {"declined.cascade": 1, "served.fingerprint_host": 1},
        {"declined.cascade": 1, "served.fingerprint_host": 1}],
    ("cascade", "auto", "fingerprint"): [
        {"served.cascade": 1}, {"served.cascade": 1}, {"served.cascade": 1},
        {"served.cascade": 1}],
    ("cascade", "device-only", "both"): [
        {"declined.cascade": 1, "declined.fingerprint": 1,
         "served.device_walk": 1},
        {"declined.fingerprint": 1, "declined.cascade": 1,
         "served.device_walk": 1},
        {"declined.fingerprint": 1, "declined.cascade": 1,
         "served.device_walk": 1},
        {"declined.fingerprint": 1, "declined.cascade": 1,
         "served.device_walk": 1}],
    ("cascade", "device-only", "cascade"): [
        {"declined.cascade": 1, "served.fingerprint_host": 1},
        {"declined.cascade": 1, "served.fingerprint_host": 1},
        {"declined.cascade": 1, "served.fingerprint_host": 1},
        {"declined.cascade": 1, "served.fingerprint_host": 1}],
    ("cascade", "device-only", "fingerprint"): [
        {"served.cascade": 1}, {"served.cascade": 1}, {"served.cascade": 1},
        {"served.cascade": 1}],
    ("large", "auto", "both"): [
        {"declined.fingerprint": 1, "served.device_walk": 1},
        {"declined.fingerprint": 1, "declined.cascade": 1,
         "served.device_walk": 1},
        {"declined.fingerprint": 1, "declined.cascade": 1,
         "served.native_walk": 1},
        {"declined.fingerprint": 1, "declined.cascade": 1,
         "served.device_walk": 1}],
    ("large", "auto", "cascade"): [
        {"served.fingerprint_host": 1}, {"served.fingerprint_host": 1},
        {"served.fingerprint_host": 1}, {"served.fingerprint_host": 1}],
    ("large", "auto", "fingerprint"): [
        {"declined.fingerprint": 1, "served.device_walk": 1},
        {"declined.fingerprint": 1, "served.cascade": 1},
        {"declined.fingerprint": 1, "served.cascade": 1},
        {"declined.fingerprint": 1, "served.cascade": 1}],
    ("large", "device-only", "both"): [
        {"declined.fingerprint": 1, "served.device_walk": 1},
        {"declined.fingerprint": 1, "declined.cascade": 1,
         "served.device_walk": 1},
        {"declined.fingerprint": 1, "declined.cascade": 1,
         "served.device_walk": 1},
        {"declined.fingerprint": 1, "declined.cascade": 1,
         "served.device_walk": 1}],
    ("large", "device-only", "cascade"): [
        {"served.fingerprint_host": 1}, {"served.fingerprint_host": 1},
        {"served.fingerprint_host": 1}, {"served.fingerprint_host": 1}],
    ("large", "device-only", "fingerprint"): [
        {"declined.fingerprint": 1, "served.device_walk": 1},
        {"declined.fingerprint": 1, "served.cascade": 1},
        {"declined.fingerprint": 1, "served.cascade": 1},
        {"declined.fingerprint": 1, "served.cascade": 1}],
    ("nodv", "auto", "both"): [
        {"declined.fingerprint": 1, "served.device_walk": 1},
        {"declined.fingerprint": 1, "declined.cascade": 1,
         "served.device_walk": 1},
        {"declined.fingerprint": 1, "declined.cascade": 1,
         "served.native_walk": 1},
        {"declined.fingerprint": 1, "declined.cascade": 1,
         "served.device_walk": 1}],
    ("nodv", "auto", "cascade"): [
        {"declined.fingerprint": 1, "served.device_walk": 1},
        {"declined.fingerprint": 1, "declined.cascade": 1,
         "served.device_walk": 1},
        {"declined.fingerprint": 1, "declined.cascade": 1,
         "served.native_walk": 1},
        {"declined.fingerprint": 1, "declined.cascade": 1,
         "served.device_walk": 1}],
    ("nodv", "auto", "fingerprint"): [
        {"declined.fingerprint": 1, "served.device_walk": 1},
        {"declined.fingerprint": 1, "served.cascade": 1},
        {"declined.fingerprint": 1, "served.cascade": 1},
        {"declined.fingerprint": 1, "served.cascade": 1}],
    ("nodv", "device-only", "both"): [
        {"declined.fingerprint": 1, "served.device_walk": 1},
        {"declined.fingerprint": 1, "declined.cascade": 1,
         "served.device_walk": 1},
        {"declined.fingerprint": 1, "declined.cascade": 1,
         "served.device_walk": 1},
        {"declined.fingerprint": 1, "declined.cascade": 1,
         "served.device_walk": 1}],
    ("nodv", "device-only", "cascade"): [
        {"declined.fingerprint": 1, "served.device_walk": 1},
        {"declined.fingerprint": 1, "declined.cascade": 1,
         "served.device_walk": 1},
        {"declined.fingerprint": 1, "declined.cascade": 1,
         "served.device_walk": 1},
        {"declined.fingerprint": 1, "declined.cascade": 1,
         "served.device_walk": 1}],
    ("nodv", "device-only", "fingerprint"): [
        {"declined.fingerprint": 1, "served.device_walk": 1},
        {"declined.fingerprint": 1, "served.cascade": 1},
        {"declined.fingerprint": 1, "served.cascade": 1},
        {"declined.fingerprint": 1, "served.cascade": 1}],
}


@pytest.mark.parametrize("hostile", sorted(HOSTILE))
@pytest.mark.parametrize("mode", ["auto", "device-only"])
@pytest.mark.parametrize("name", ["large", "cascade", "nodv"])
def test_declined_fallbacks(name, mode, hostile, monkeypatch):
    pats = _lower(monkeypatch, name)
    for mod in HOSTILE[hostile]:
        monkeypatch.setattr(mod, "CAND_FLOOR", 64)
    hay = _dense(pats)
    ac = T.AhoCorasick(pats, device="cpu", engine=mode)
    routes = []
    for op in DENSE_CALLS:
        got, counters = _routed(ac, op, hay)
        assert got == _want(pats, op, hay), op
        routes.append(counters)
    assert routes == DENSE[name, mode, hostile]


@pytest.mark.parametrize("op", DENSE_CALLS[1:3])
def test_device_verify_set_keeps_its_limit_below_dv_min(op, monkeypatch):
    """A set with a device verify verifies a haystack under FP_DV_MIN on
    the host, under the device verify's limit and not the host verify's
    (lowered here past the dense haystack's candidates): the call is
    served, and no later large call loses the device verify."""
    pats = _lower(monkeypatch, "large")
    monkeypatch.setattr(TF, "HOST_CAND_FLOOR", HOST_FLOOR)
    hay = _dense(pats)
    assert len(hay) < TF.FP_DV_MIN
    ac = T.AhoCorasick(pats, device="cpu")
    got, counters = _routed(ac, op, hay)
    assert got == _want(pats, op, hay)
    assert counters == {"served.fingerprint_host": 1}
    fp = ac._engines["fingerprint"]
    assert fp.dv is not None and not fp.hostile
    assert len(fp.candidates(hay)) > HOST_FLOOR
