"""Checkpoints between the two packages.

A `.npz` written by either package's `save()` loads in the other, and
`ahocorasick_tpu_torch.serialize.from_arrays` turns the JAX package's
compiled arrays into a port searcher. Outputs are match triples: the
tolerance is exact equality.
"""

import io

import numpy as np
import pytest

import ahocorasick_tpu as J
import ahocorasick_tpu_torch as T
from ahocorasick_tpu_torch import serialize as TS

PATS = ["append", "appendage", "app", "ap", "Snap"]
HAY = "the appendage Snapped app ap append " * 7


def triples(it):
    return [m.astuple() for m in it]


KINDS = ["standard", "leftmost-first", "leftmost-longest"]


@pytest.mark.parametrize("kind", KINDS)
def test_jax_save_loads_in_port(tmp_path, kind):
    jac = J.AhoCorasick(PATS, match_kind=J.MatchKind(kind),
                        device_threshold=0)
    p = str(tmp_path / "jax.npz")
    jac.save(p)
    tac = T.AhoCorasick.load(p, device="cpu")
    assert triples(tac.find_iter(T.Input(HAY))) == triples(
        jac.find_iter(J.Input(HAY)))
    assert tac.match_kind().value == kind
    assert tac.kind().value == jac.kind().value
    assert tac.memory_usage() == jac.memory_usage()
    assert tac.max_pattern_len() == jac.max_pattern_len()


@pytest.mark.parametrize("kind", KINDS)
def test_port_save_loads_in_jax(tmp_path, kind):
    tac = T.AhoCorasick(PATS, match_kind=T.MatchKind(kind),
                        device_threshold=0, device="cpu")
    p = str(tmp_path / "port.npz")
    tac.save(p)
    jac = J.AhoCorasick.load(p)
    assert triples(jac.find_iter(J.Input(HAY))) == triples(
        tac.find_iter(T.Input(HAY)))
    assert jac.memory_usage() == tac.memory_usage()
    tac2 = T.AhoCorasick.load(p, device="cpu")
    assert triples(tac2.find_iter(T.Input(HAY))) == triples(
        tac.find_iter(T.Input(HAY)))


def test_from_arrays_of_a_jax_searcher():
    jac = J.AhoCorasick(["aB", "cd"], ascii_case_insensitive=True,
                        start_kind=J.StartKind.BOTH, engine="bitap",
                        device_threshold=0)
    arrays = TS.to_arrays(jac)
    tac = TS.from_arrays(arrays, device="cpu")
    h = "xAb cD ab"
    assert triples(tac.find_iter(T.Input(h))) == triples(
        jac.find_iter(J.Input(h)))
    assert tac.start_kind() is T.StartKind.BOTH
    inp = T.Input("aB xx", anchored=T.Anchored.YES)
    jinp = J.Input("aB xx", anchored=J.Anchored.YES)
    assert triples(tac.find_iter(inp)) == triples(jac.find_iter(jinp))
    for name in ("dfa_trans", "nfa_fail", "pat_blob", "config"):
        np.testing.assert_array_equal(arrays[name], TS.to_arrays(tac)[name])


def test_roundtrip_overlapping_and_stream(tmp_path):
    jac = J.AhoCorasick(["abba", "b", "ba"])
    p = str(tmp_path / "ac.npz")
    jac.save(p)
    tac = T.AhoCorasick.load(p, device="cpu")
    h = "abbabba"
    assert triples(tac.find_overlapping_iter(T.Input(h))) == triples(
        jac.find_overlapping_iter(J.Input(h)))
    assert triples(tac.stream_find_iter(io.BytesIO(h.encode()))) == \
        triples(jac.stream_find_iter(io.BytesIO(h.encode())))


def test_dfa_scan_searcher_roundtrip(tmp_path):
    """A JAX-saved engine="dfa-scan" searcher loads in the port with its
    engine mode and searches the same, through the device walk."""
    jac = J.AhoCorasick(["abc", "bcd", "cab"], engine="dfa-scan",
                        device_threshold=0)
    p = str(tmp_path / "dfa.npz")
    jac.save(p)
    tac = T.AhoCorasick.load(p, device="cpu")
    assert tac._engine_mode == "dfa-scan"
    hay = "abcdcabcab xbcd " * 30
    assert triples(tac.find_overlapping_iter(T.Input(hay))) == triples(
        jac.find_overlapping_iter(J.Input(hay)))
    assert tac.count_matches(T.Input(hay)) == jac.count_matches(
        J.Input(hay))
    assert tac._dev_automaton is not None


def test_fingerprint_searcher_roundtrip(tmp_path):
    """A forced engine="fingerprint" searcher saved by either package
    loads in the port with its engine mode and searches the same."""
    pats = ["append", "appendage", "snapped", "apple", "maple"]
    jac = J.AhoCorasick(pats, engine="fingerprint")
    tac = T.AhoCorasick(pats, engine="fingerprint", device="cpu")
    hay = "the appendage snapped an apple maple append " * 40
    want = triples(jac.find_overlapping_iter(J.Input(hay)))
    for i, src in enumerate((jac, tac)):
        p = str(tmp_path / f"fp{i}.npz")
        src.save(p)
        back = T.AhoCorasick.load(p, device="cpu")
        assert back._engine_mode == "fingerprint"
        assert back._bitap_engine() is None
        assert triples(back.find_overlapping_iter(T.Input(hay))) == want
        assert back._fp is not None
    back = TS.from_arrays(TS.to_arrays(tac), device="cpu")
    assert back.count_matches(T.Input(hay)) == len(want)
