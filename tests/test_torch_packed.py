"""The port's packed searcher (`ahocorasick_tpu_torch.packed`) on the CPU.

- The cases of the JAX package's packed tests (tests/test_packed.py) and
  its packed positional sweep (tests/test_positional.py), run on the port
  with the forces None, "rabinkarp" and "teddy" (the JAX tests never force
  Teddy).
- Port results held against the JAX `Searcher` on the same inputs: every
  corpus case with the forces "rabinkarp" and "teddy" (host verify, the
  fingerprint in plain jnp), a seeded subset with the default engine
  (Pallas interpret mode).
- The Teddy candidate mask held bit for bit against the JAX
  `_fingerprint_jit`, and `memory_usage` against the JAX searcher's.

Every searcher runs with ``device("cpu")``, so the kernels' plain PyTorch
versions run. Outputs are integers: the tolerance is exact equality.
"""

import random

import numpy as np
import pytest
import torch

import corpus
from ahocorasick_tpu.packed import Config as JConfig
from ahocorasick_tpu.packed import MatchKind as JKind
from ahocorasick_tpu.packed import teddy as JT
from ahocorasick_tpu_torch import AhoCorasick, MatchKind as CoreKind
from ahocorasick_tpu_torch.packed import (
    PATTERN_LIMIT,
    Builder,
    Config,
    MatchKind,
    Searcher,
)
from ahocorasick_tpu_torch.packed import teddy as TT
from ahocorasick_tpu_torch.utils.search import Span

KINDS = [MatchKind.LEFTMOST_FIRST, MatchKind.LEFTMOST_LONGEST]
FORCES = [None, "rabinkarp", "teddy"]
# Padding variations of packed/tests.rs:42-51 (tests/test_packed.py).
PADS = [0, 1, 2, 7, 15, 16, 17, 40, 128, 260]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The kernels' plain versions run many small torch operations. With
    several test processes on one host, torch's intra-op threads contend
    (one case of this file took 50x longer beside five copies of itself),
    so these tests run torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cfg(kind=MatchKind.LEFTMOST_FIRST, force=None):
    c = Config().match_kind(kind).device("cpu")
    if force == "rabinkarp":
        c.only_rabin_karp(True)
    elif force == "teddy":
        c.only_teddy(True)
    return c


def jcfg(kind, force):
    c = JConfig().match_kind(JKind(kind.value))
    if force == "rabinkarp":
        c.only_rabin_karp(True)
    elif force == "teddy":
        c.only_teddy(True)
    return c


def searcher(patterns, kind=MatchKind.LEFTMOST_FIRST, force=None):
    return cfg(kind, force).builder().extend(patterns).build()


def packed_cases(kind):
    coll = (
        corpus.AC_LEFTMOST_FIRST
        if kind is MatchKind.LEFTMOST_FIRST
        else corpus.AC_LEFTMOST_LONGEST
    )
    for name, patterns, haystack, expected in corpus.iter_tests(coll):
        if not patterns or any(len(p) == 0 for p in patterns):
            continue
        if len(patterns) > 128:
            continue
        yield name, patterns, haystack, expected


def triples(it):
    return [m.astuple() for m in it]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("force", FORCES)
def test_packed_find_iter(kind, force):
    for name, patterns, haystack, expected in packed_cases(kind):
        s = searcher(patterns, kind, force)
        assert s is not None
        got = triples(s.find_iter(haystack))
        assert got == expected, (
            f"{name} kind={kind} force={force}: patterns={patterns!r}"
            f" haystack={haystack!r}: got {got}, want {expected}"
        )


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("force", ["rabinkarp", "teddy"])
def test_packed_find_iter_equals_jax(kind, force):
    """Every corpus case, port against the JAX searcher (no Pallas on
    these forces: Rabin-Karp on the host, Teddy's fingerprint in jnp)."""
    n = 0
    for name, patterns, haystack, _ in packed_cases(kind):
        got = triples(searcher(patterns, kind, force).find_iter(haystack))
        js = jcfg(kind, force).builder().extend(patterns).build()
        assert got == triples(js.find_iter(haystack)), name
        n += 1
    assert n > 50


def test_packed_default_engine_equals_jax():
    """A seeded subset through the default engines of both packages (the
    JAX bit-parallel kernel in Pallas interpret mode)."""
    rng = random.Random(23)
    for kind in KINDS:
        cases = list(packed_cases(kind))
        for name, patterns, haystack, _ in rng.sample(cases, 6):
            got = triples(searcher(patterns, kind).find_iter(haystack))
            js = jcfg(kind, None).builder().extend(patterns).build()
            assert got == triples(js.find_iter(haystack)), name


@pytest.mark.parametrize("force", FORCES)
@pytest.mark.parametrize("pad", PADS)
def test_packed_padding_variations(pad, force):
    s = searcher(["abc", "xyz", "ab", "yz"], force=force)
    base = "abcxxyzz"
    for mode in ("prefix", "suffix", "both"):
        pre = "Z" * pad if mode in ("prefix", "both") else ""
        suf = "Z" * pad if mode in ("suffix", "both") else ""
        got = triples(s.find_iter(pre + base + suf))
        off = len(pre)
        want = [(0, off + 0, off + 3), (1, off + 4, off + 7)]
        assert got == want, f"pad={pad} mode={mode} force={force}: {got}"


def test_packed_inert_on_empty_pattern():
    # api.rs:303-322: adding an empty pattern makes build() return None.
    assert cfg().builder().extend(["a", ""]).build() is None
    assert cfg().builder().build() is None


def test_packed_pattern_limit():
    pats = ["p%03d" % i for i in range(PATTERN_LIMIT + 1)]
    assert cfg().builder().extend(pats).build() is None
    assert cfg().builder().extend(pats[:PATTERN_LIMIT]).build() is not None


@pytest.mark.parametrize("force", FORCES)
def test_packed_vs_core_leftmost(force):
    random.seed(9)
    for _ in range(25):
        k = random.randint(1, 8)
        pats = list({
            "".join(random.choice("ab") for _ in range(random.randint(1, 5)))
            for _ in range(k)
        })
        h = "".join(random.choice("abz") for _ in range(300))
        s = searcher(pats, force=force)
        core = AhoCorasick(pats, match_kind=CoreKind.LEFTMOST_FIRST,
                           device="cpu")
        assert triples(s.find_iter(h)) == triples(core.find_iter(h)), (
            pats, h[:50])


@pytest.mark.parametrize("force", FORCES)
def test_packed_find_in_span(force):
    s = searcher(["teddy", "bear"], force=force)
    h = "a teddy bear"
    m = s.find_in(h, Span(3, len(h)))
    assert m is not None and m.astuple() == (1, 8, 12)
    assert s.find(h).astuple() == (0, 2, 7)
    assert s.find_in(h, Span(9, len(h))) is None


def _large_set():
    random.seed(17)
    pats = sorted({
        "".join(random.choice("abcdefgh") for _ in range(
            random.randint(17, 24)
        ))
        for _ in range(120)
    })[:120]
    planted = "".join(random.choice("abcdefghij") for _ in range(4000))
    h = planted[:500] + pats[3] + planted[500:900] + pats[77] + planted[900:]
    return pats, h


def test_packed_large_set_rides_fingerprint_engine():
    """128 long patterns exceed the exact kernel's 2048-byte bound: the
    packed default engine rides the bucketed fingerprint filter and
    agrees with the core leftmost-first searcher and with Teddy."""
    pats, h = _large_set()
    assert sum(len(p) for p in pats) > 2048
    s = searcher(pats)
    # The fingerprint engine is constructed lazily on first use.
    assert s._bitap is None and s._fp is None
    assert s._fp_engine() is not None and s._fp is not None
    assert s._fp.device == torch.device("cpu")
    core = AhoCorasick(pats, match_kind=CoreKind.LEFTMOST_FIRST,
                       device="cpu")
    got = triples(s.find_iter(h))
    assert got == triples(core.find_iter(h))
    assert got == triples(searcher(pats, force="teddy").find_iter(h))
    assert len(got) >= 2


def test_packed_hostile_input_falls_to_teddy():
    """A candidate-dense input makes the fingerprint engine decline
    (None); the searcher then answers through Teddy."""
    pats = ["ab" * 10 + "%02d" % i for i in range(100)]
    assert sum(len(p) for p in pats) > 2048
    h = "ab" * 80000 + pats[5] + pats[42]
    s = searcher(pats)
    assert s._fp_engine() is not None
    got = triples(s.find_iter(h))
    assert s._fp.hostile
    core = AhoCorasick(pats, match_kind=CoreKind.LEFTMOST_FIRST,
                       device="cpu", device_threshold=1 << 62)
    assert got == triples(core.find_iter(h))
    assert len(got) == 2


def _sweep_haystack(hay: bytes, maxlen: int):
    """tests/test_positional.py: every offset 0..260 of `hay` packed into
    one buffer; returns (buffer, base offset of each copy)."""
    sep = b"Z" * max(maxlen, 4)
    parts, bases, pos = [], [], 0
    for off in range(261):
        parts.append(b"Z" * off)
        pos += off
        bases.append(pos)
        parts += [hay, sep]
        pos += len(hay) + len(sep)
    return b"".join(parts), bases


@pytest.mark.parametrize("force", FORCES)
def test_positional_sweep_packed_api(force):
    """tests/test_positional.py:69-82 on the port."""
    buf, bases = _sweep_haystack(b"the foxtrot!", 7)
    s = cfg(force=force).builder().extend(
        [b"fox", b"foxtrot", b"ox"]).build()
    # Leftmost-first: "fox" (pattern 0) wins over "foxtrot" at the same
    # start.
    assert triples(s.find_iter(buf)) == [(0, b + 4, b + 7) for b in bases]


@pytest.mark.parametrize("f", [1, 2, 3, 4])
@pytest.mark.parametrize("n", [7, 100, 4095, 4096, 5000])
def test_teddy_mask_equals_jax(f, n):
    """The candidate mask, bit for bit, against `_fingerprint_jit`, for
    every mask length, below 4,096 (the minimum bucket), at a full bucket
    and at a length that is not a power of two."""
    rng = np.random.default_rng(100 * f + n)
    alpha = np.frombuffer(b"abcdxyz\x00\xff", np.uint8)
    pats = [alpha[rng.integers(0, len(alpha), int(rng.integers(f, 9)))]
            .tobytes() for _ in range(12)]
    pats[0] = pats[0][:f]
    hay = bytearray(alpha[rng.integers(0, len(alpha), n)].tobytes())
    for p in pats:
        at = int(rng.integers(0, max(n - len(p), 1)))
        hay[at:at + len(p)] = p[:n - at]
    hay = bytes(hay)
    ts = TT.TeddySearcher(pats, "cpu")
    assert ts.tables.mask_len == f
    got = ts.candidate_mask(hay).numpy()

    import jax.numpy as jnp
    jt = JT.TeddySearcher(pats)
    buf = np.zeros(JT._bucket(n), np.uint8)
    buf[:n] = np.frombuffer(hay, np.uint8)
    want = np.asarray(JT._fingerprint_jit(
        jnp.asarray(buf), jt._m_lo, jt._m_hi, jnp.int32(n - f + 1), f))
    assert got.shape == want.shape == (JT._bucket(n),)
    np.testing.assert_array_equal(got, want)
    assert got.any()
    np.testing.assert_array_equal(ts.candidates(hay), jt.candidates(hay))


def test_candidates_at_the_edges():
    """Teddy's candidates (one ``torch.nonzero`` of the mask) equal the
    JAX searcher's count-and-compact at the edges: no candidate, a
    haystack shorter than the fingerprint, and candidates at the first
    and the last valid start of a haystack that fills its bucket."""
    pats = [b"abcd", b"wxyz"]
    ts = TT.TeddySearcher(pats, "cpu")
    jt = JT.TeddySearcher(pats)
    full = b"abcd" + b"." * 4088 + b"wxyz"
    for hay in (b"", b"abc", b"." * 5000, full, b"abcdwxyz"):
        got = ts.candidates(hay)
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, jt.candidates(hay))
    assert ts.candidates(full).tolist() == [0, 4092]


@pytest.mark.parametrize("which", ["bitap", "fingerprint", "teddy",
                                   "rabinkarp"])
def test_memory_usage_equals_jax(which):
    pats = ["teddy", "bear", "Sherlock", "ab"]
    force = which if which in ("teddy", "rabinkarp") else None
    if which == "fingerprint":
        pats, _ = _large_set()
    s = searcher(pats, force=force)
    js = jcfg(MatchKind.LEFTMOST_FIRST, force).builder().extend(pats).build()
    if which == "fingerprint":
        assert s._fp_engine() is not None and js._fp_engine() is not None
    assert s.memory_usage() == js.memory_usage() > 0


def test_default_device_is_cuda():
    """Config's device defaults to "cuda": without a CUDA device the
    searcher is not built (ROADMAP P6)."""
    assert Config()._device == "cuda"
    if torch.cuda.is_available():
        assert Searcher.new(["ab"]).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Searcher.new(["ab"])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Builder().extend(["ab"]).build()
    s = searcher(["ab"])
    assert s.device == torch.device("cpu")
    assert s._bitap.device == torch.device("cpu")
    assert s._teddy.device == torch.device("cpu")
