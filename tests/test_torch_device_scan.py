"""The port's blocked device DFA walk held against the JAX package's.

The port's `DeviceAutomaton` (its walk's plain versions, on the CPU) and
the JAX jits `_scan_states_jit`, `_count_matches_jit` and
`_compact_matches_jit` (pure ``jnp``, no Pallas) walk the same DFA over
the same padded buffer; both are also held against
`scan_states_host`. The facade's forced `dfa-scan` / `device-only` modes
and its last resort without the native walk (where it used to raise) are
held against the JAX facade and the oracle. Every output is an integer:
the tolerance is exact equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ahocorasick_tpu as J
import ahocorasick_tpu.ops.block_scan as JB
import ahocorasick_tpu_torch as T
import ahocorasick_tpu_torch.ops.block_scan as TBS
import ahocorasick_tpu_torch.ops.walk_kernels as WK

CASES = {
    # max pattern length 5 (halo 8), n not a power of two
    "odd_lengths": ([b"abcde", b"bcd", b"cab", b"a"], 9_001, b"abcde "),
    # n below the halo (max length 40 -> halo 64)
    "short_haystack": ([b"ab" * 20, b"ba", b"bab"], 37, b"ab"),
    # the empty pattern matches at every position, the start state too
    "empty_pattern": ([b"", b"ab", b"bc"], 5_000, b"abc"),
    # byte classes off: the identity alphabet
    "no_byte_classes": ([b"he", b"she", b"his", b"hers"], 12_345,
                        b"hisre "),
    # many blocks, multi-block halo carry (lanes > 1024)
    "large": ([b"needle", b"needles", b"eed", b"dle"], 300_001,
              b"needls "),
}


def _searchers(name):
    pats, n, alpha = CASES[name]
    bc = name != "no_byte_classes"
    rng = np.random.default_rng(len(name))
    hay = rng.choice(list(alpha), n).astype(np.uint8).tobytes()
    jac = J.AhoCorasick(pats, byte_classes=bc)
    tac = T.AhoCorasick(pats, byte_classes=bc, device="cpu")
    return pats, hay, jac, tac


@pytest.mark.parametrize("name", list(CASES))
def test_walk_equals_jax_jits(name):
    pats, hay, jac, tac = _searchers(name)
    jda = JB.DeviceAutomaton(jac._dfa)
    tda = TBS.DeviceAutomaton(tac._dfa, "cpu")
    assert tda.halo == jda.halo and tda.alphabet_len == jda.alphabet_len
    buf, n, block_len, halo = tda._prepare(hay)
    jbuf, jn, jblock, jhalo = jda._prepare(hay)
    assert (n, block_len, halo) == (jn, jblock, jhalo)
    np.testing.assert_array_equal(buf.numpy(), jbuf)
    # The raw padded states of one walk.
    states = WK.walk_states_plain(tda.trans_flat, tda.classes, buf,
                                  tda.alphabet_len, tda.start_id, block_len,
                                  halo)
    want = np.asarray(JB._scan_states_jit(
        jda.trans_flat, jda.classes, jnp.asarray(jbuf),
        jnp.int32(jda.alphabet_len), jnp.int32(jda.start_id), block_len,
        halo))
    np.testing.assert_array_equal(states.numpy(), want)
    np.testing.assert_array_equal(states[:n].numpy(),
                                  TBS.scan_states_host(tac._dfa, hay))
    # Count and compaction.
    jtotal = int(JB._count_matches_jit(
        jda.trans_flat, jda.classes, jda.match_count, jnp.asarray(jbuf),
        jnp.int32(n), jnp.int32(jda.alphabet_len), jnp.int32(jda.start_id),
        block_len, halo))
    assert int(WK.walk_count_plain(
        tda.trans_flat, tda.classes, buf, tda.alphabet_len, tda.start_id,
        block_len, halo, tda.match_count, 0, n)) == jtotal
    assert tda.count_matches(hay) == jda.count_matches(hay)
    k = 1 << max(int(len(hay) - 1).bit_length(), 6)
    jpos, jsid = JB._compact_matches_jit(
        jnp.asarray(want), jnp.int32(n), jnp.int32(jda.max_match_id), k)
    pos, sids = TBS._compact_matches(states, n, tda.max_match_id)
    cnt = len(pos)
    assert cnt > 0 or name == "short_haystack"
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos)[:cnt])
    np.testing.assert_array_equal(sids.numpy(), np.asarray(jsid)[:cnt])
    ends, sids2 = tda.match_positions(hay)
    jends, jsids = jda.match_positions(hay)
    np.testing.assert_array_equal(ends, jends)
    np.testing.assert_array_equal(sids2, jsids)


def test_empty_haystack():
    tac = T.AhoCorasick([b"", b"ab"], device="cpu")
    tda = TBS.DeviceAutomaton(tac._dfa, "cpu")
    assert tda.scan_states(b"").shape == (0,)
    assert tda.count_matches(b"") == 1  # the empty pattern at 0
    ends, sids = tda.match_positions(b"")
    assert len(ends) == len(sids) == 0


def test_halo_longer_than_a_block():
    """A 200-byte pattern needs a 256-byte halo over 128-byte blocks: the
    port builds the halo windows by index, where the JAX package's
    roll-and-reshape windows fail (ROADMAP.md fault R7); held against the
    host walk and the oracle."""
    pats = [b"a" * 200, b"ab", b"ba"]
    hay = (b"a" * 300 + b"ba") * 20
    tac = T.AhoCorasick(pats, device="cpu")
    tda = TBS.DeviceAutomaton(tac._dfa, "cpu")
    _, _, block_len, halo = tda._prepare(hay)
    assert halo > block_len
    np.testing.assert_array_equal(tda.scan_states(hay),
                                  TBS.scan_states_host(tac._dfa, hay))
    forced = T.AhoCorasick(pats, engine="dfa-scan", device_threshold=0,
                           device="cpu")
    oracle = T.AhoCorasick(pats, engine="oracle", device="cpu")
    assert _triples(forced.find_overlapping_iter(hay)) == _triples(
        oracle.find_overlapping_iter(hay))
    assert forced.count_matches(hay) == tda.count_matches(hay)


@pytest.mark.parametrize("n", [4096, 4095, 8192])
def test_halo_longer_than_a_block_fills_its_bucket(n):
    """A haystack that fills (or nearly fills) its power-of-two bucket has
    no zero padding at the buffer's end: the first blocks' halo steps that
    fall before the buffer's start must be skipped, not wrapped onto the
    haystack's own tail (which would report 'a' * 200 inside block 1)."""
    pats = [b"a" * 200, b"ab"]
    hay = b"a" * n
    tac = T.AhoCorasick(pats, device="cpu")
    tda = TBS.DeviceAutomaton(tac._dfa, "cpu")
    buf, _, block_len, halo = tda._prepare(hay)
    assert halo > block_len and len(buf) - n < halo
    host = TBS.scan_states_host(tac._dfa, hay)
    np.testing.assert_array_equal(tda.scan_states(hay), host)
    oracle = T.AhoCorasick(pats, engine="oracle", device="cpu")
    want = _triples(oracle.find_overlapping_iter(hay))
    assert tda.count_matches(hay) == len(want) == n - 199
    ends, _ = tda.match_positions(hay)
    np.testing.assert_array_equal(ends, np.arange(200, n + 1))
    forced = T.AhoCorasick(pats, engine="dfa-scan", device_threshold=0,
                           device="cpu")
    assert _triples(forced.find_overlapping_iter(hay)) == want
    assert forced.count_matches(hay) == len(want)


# ---------------------------------------------------------------------------
# Facade
# ---------------------------------------------------------------------------
def _triples(it):
    return [m.astuple() for m in it]


@pytest.mark.parametrize("mode", ["dfa-scan", "device-only"])
def test_forced_walk_equals_jax_facade(mode, monkeypatch):
    """A set no filter engine takes (an empty pattern) under a forced
    device mode runs the device walk in both facades, from 0 bytes."""
    calls = []
    orig = TBS.DeviceAutomaton.match_positions
    monkeypatch.setattr(TBS.DeviceAutomaton, "match_positions",
                        lambda self, h: calls.append(len(h)) or orig(self, h))
    pats = [b"", b"ab", b"abc", b"cab"]
    hay = np.random.default_rng(9).choice(list(b"abc "), 3000).astype(
        np.uint8).tobytes()
    jac = J.AhoCorasick(pats, engine=mode, device_threshold=0)
    tac = T.AhoCorasick(pats, engine=mode, device_threshold=0, device="cpu")
    assert _triples(tac.find_iter(hay)) == _triples(jac.find_iter(
        J.Input(hay)))
    assert calls == [len(hay)]
    assert tac.count_matches(hay) == jac.count_matches(J.Input(hay))
    assert tac._dev_automaton is not None


def test_without_native_walk_the_device_walk_serves(monkeypatch):
    """With the native library unavailable, an ineligible set on a
    haystack at or above the device threshold runs the device walk
    (the port used to raise there)."""
    from ahocorasick_tpu_torch.automata import native

    monkeypatch.setattr(native, "dfa_positions", lambda dfa, h: None)
    monkeypatch.setattr(native, "dfa_count", lambda dfa, h: None)
    pats = [b"", b"he", b"she", b"hers"]
    hay = b"ushers she said, he hers " * 200
    tac = T.AhoCorasick(pats, device_threshold=1024, device="cpu")
    oracle = T.AhoCorasick(pats, engine="oracle", device="cpu")
    assert tac._bitap_engine() is None
    assert _triples(tac.find_overlapping_iter(hay)) == _triples(
        oracle.find_overlapping_iter(hay))
    assert tac.count_matches(hay) == len(_triples(
        oracle.find_overlapping_iter(hay)))
    assert tac._dev_automaton is not None
    # Below the threshold the host scalar walk serves.
    small = T.AhoCorasick(pats, device_threshold=1 << 20, device="cpu")
    assert _triples(small.find_iter(hay)) == _triples(oracle.find_iter(hay))
    assert small._dev_automaton is None


def test_device_only_takes_the_filter_engines_first():
    """engine='device-only' on a set the bit-parallel engine declines
    takes the fingerprint engine, as in the JAX facade, not the walk."""
    rng = np.random.default_rng(4)
    pats = sorted({rng.choice(list(b"abcdefgh"), int(rng.integers(4, 9)))
                   .astype(np.uint8).tobytes() for _ in range(600)})
    hay = rng.choice(list(b"abcdefghij "), 20_000).astype(np.uint8).tobytes()
    tac = T.AhoCorasick(pats, engine="device-only", device="cpu")
    oracle = T.AhoCorasick(pats, engine="oracle", device="cpu")
    assert tac._bitap_engine() is None
    assert tac.count_matches(hay) == len(_triples(
        oracle.find_overlapping_iter(hay)))
    assert tac._fp is not None and tac._dev_automaton is None
    assert torch.device("cpu") == tac.device()
