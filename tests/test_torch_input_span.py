"""Earliest searches of an ``Input`` span that starts inside the haystack.

Every standard-kind ``find`` and every ``is_match`` takes the earliest
match of the span's match set, whose starts count from the span's first
byte. Each route is held against the JAX package's host oracle
(``engine="oracle"``, which walks the span itself) on spans that start
at every byte, for every match kind. The JAX package's other routes skip
the span's first ``start`` bytes there (ROADMAP R9); the port does not,
a deliberate difference pinned by the last test.
"""

import pytest

import ahocorasick_tpu as J
import ahocorasick_tpu_torch as T
from ahocorasick_tpu_torch.utils import log
from torch_suite import per_test_time_limit  # noqa: F401

PATS = [b"ab", b"b", b"xab", b"abc", b"bxa"]
HAY = b"xxab xab abc bxab b"
KINDS = [T.MatchKind.STANDARD, T.MatchKind.LEFTMOST_FIRST,
         T.MatchKind.LEFTMOST_LONGEST]
# route: (searcher options, the served.* counter the route records)
ROUTES = {
    "bitap": ({"engine": "bitap"}, "served.bitap"),
    "fingerprint": ({"engine": "fingerprint", "device_threshold": 0},
                    "served.fingerprint_host"),
    "device_walk": ({"engine": "dfa-scan", "device_threshold": 0},
                    "served.device_walk"),
    "native_walk": ({}, "served.native_walk"),
    "host_walk": ({"engine": "dfa-scan"}, "served.host_walk"),
}
SPANS = ([(s, len(HAY)) for s in range(len(HAY) + 1)]
         + [(s, s + 4) for s in range(len(HAY) - 3)])


def _ac(kind, **kw):
    return T.AhoCorasick(PATS, match_kind=kind, device="cpu", **kw)


def _answers(ac, package=T):
    out = []
    for s, e in SPANS:
        m = ac.find(package.Input(HAY, start=s, end=e))
        out.append((m and m.astuple(),
                    ac.is_match(package.Input(HAY, start=s, end=e))))
    return out


def _oracle_answers(kind):
    ac = J.AhoCorasick(PATS, match_kind=J.MatchKind(kind.value),
                       engine="oracle")
    return _answers(ac, J)


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("kind", KINDS, ids=lambda k: k.value)
def test_span_searches_equal_the_oracle(kind, route):
    opts, served = ROUTES[route]
    ac = _ac(kind, **opts)
    log.take()
    log.enable()
    try:
        got = _answers(ac)
    finally:
        log.disable()
    recs = log.take()
    assert got == _oracle_answers(kind)
    assert any(m for m, _ in got)
    # Two calls a span (find, is_match); the fingerprint engine answers an
    # empty span before it chooses a verify, and counts no route there.
    assert len(recs) == 2 * len(SPANS)
    assert all(rec.get(served) == 1
               for i, rec in enumerate(recs) if SPANS[i // 2][0] < len(HAY))


def test_jax_package_skips_the_span_head():
    hay = b"xxab xab"
    port = T.AhoCorasick(["ab", "b"], device="cpu", device_threshold=0)
    assert port.find(T.Input(hay, start=2)).astuple() == (0, 2, 4)
    jax_facade = J.AhoCorasick(["ab", "b"], device_threshold=0)
    assert jax_facade.find(J.Input(hay, start=2)).astuple() == (0, 6, 8)
