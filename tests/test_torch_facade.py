"""The port's facade (`ahocorasick_tpu_torch.AhoCorasick`) on the CPU.

- The conformance corpus (tests/corpus.py) against its expected triples,
  in the configurations of the JAX package's corpus runner plus a forced
  cascade one, which the JAX runner lacks.
- A seeded subset held against the JAX facade (Pallas interpret mode).
- The error-contract, stream and fuzz cases of the JAX package's own
  tests, ported.
- The forced fingerprint, cascade, dfa-scan and device-only engines held
  against the JAX facade's.

Every searcher is built with ``device="cpu"``, so the kernels' plain
PyTorch versions run. All outputs are integer triples or bytes: the
tolerance is exact equality.
"""

import functools
import io
import random

import numpy as np
import pytest

import corpus
import ahocorasick_tpu as J
from ahocorasick_tpu_torch import (
    AhoCorasick as _AhoCorasick,
    AhoCorasickBuilder,
    AhoCorasickKind,
    Anchored,
    Input,
    MatchError,
    MatchKind,
    OverlappingState,
    StartKind,
)
from ahocorasick_tpu_torch.stream import (
    stream_find_iter,
    stream_replace_all,
    stream_replace_all_with,
)

AhoCorasick = functools.partial(_AhoCorasick, device="cpu")

CONFIGS = [
    # Every haystack through the bit-parallel kernels' plain versions;
    # ineligible sets (empty patterns) take the native walk.
    ("bitap", dict(engine="bitap", device_threshold=0)),
    # The blocked device DFA walk, every haystack.
    ("dfa_scan", dict(engine="dfa-scan", device_threshold=0)),
    # Same dense-table semantics through the host scalar walk, with byte
    # classes disabled (identity alphabet).
    ("device_nobc", dict(engine="dfa-scan", byte_classes=False)),
    ("oracle", dict(engine="oracle")),
    ("auto", dict()),
    # The filter engines, forced even for sets the exact engine takes;
    # sets they decline (empty patterns) take the native walk.
    ("fingerprint", dict(engine="fingerprint", device_threshold=0)),
    ("cascade", dict(engine="cascade", device_threshold=0)),
    ("contig_sparse", dict(engine="oracle", dense_depth=0,
                           kind=AhoCorasickKind.CONTIGUOUS_NFA)),
    ("contig_dense", dict(engine="oracle", dense_depth=1 << 20,
                          kind=AhoCorasickKind.CONTIGUOUS_NFA)),
]

NONOVERLAPPING_COLLECTIONS = [
    ("standard", MatchKind.STANDARD, corpus.AC_STANDARD_NON_OVERLAPPING),
    ("leftmost_first", MatchKind.LEFTMOST_FIRST, corpus.AC_LEFTMOST_FIRST),
    ("leftmost_longest", MatchKind.LEFTMOST_LONGEST,
     corpus.AC_LEFTMOST_LONGEST),
]

ANCHORED_COLLECTIONS = [
    ("standard", MatchKind.STANDARD,
     corpus.AC_STANDARD_ANCHORED_NON_OVERLAPPING),
    ("leftmost_first", MatchKind.LEFTMOST_FIRST,
     corpus.AC_LEFTMOST_FIRST_ANCHORED),
    ("leftmost_longest", MatchKind.LEFTMOST_LONGEST,
     corpus.AC_LEFTMOST_LONGEST_ANCHORED),
]


def triples(it):
    return [m.astuple() for m in it]


# ---------------------------------------------------------------------------
# Conformance corpus
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cfg_name,cfg", CONFIGS)
@pytest.mark.parametrize("kind_name,kind,collection",
                         NONOVERLAPPING_COLLECTIONS)
def test_find_iter(cfg_name, cfg, kind_name, kind, collection):
    for name, patterns, haystack, expected in corpus.iter_tests(collection):
        ac = AhoCorasick(patterns, match_kind=kind, **cfg)
        got = triples(ac.try_find_iter(Input(haystack)))
        assert got == expected, (name, patterns, haystack, kind_name,
                                 cfg_name, got)


@pytest.mark.parametrize("cfg_name,cfg", CONFIGS)
@pytest.mark.parametrize("kind_name,kind,collection", ANCHORED_COLLECTIONS)
def test_find_iter_anchored(cfg_name, cfg, kind_name, kind, collection):
    for name, patterns, haystack, expected in corpus.iter_tests(collection):
        ac = AhoCorasick(patterns, match_kind=kind,
                         start_kind=StartKind.BOTH, **cfg)
        inp = Input(haystack, anchored=Anchored.YES)
        got = triples(ac.try_find_iter(inp))
        assert got == expected, (name, patterns, haystack, kind_name,
                                 cfg_name, got)


@pytest.mark.parametrize("cfg_name,cfg", CONFIGS)
def test_find_overlapping_iter(cfg_name, cfg):
    for name, patterns, haystack, expected in corpus.iter_tests(
        corpus.AC_STANDARD_OVERLAPPING
    ):
        ac = AhoCorasick(patterns, match_kind=MatchKind.STANDARD, **cfg)
        got = triples(ac.try_find_overlapping_iter(Input(haystack)))
        assert got == expected, (name, patterns, haystack, cfg_name, got)
        if not cfg_name.startswith("contig"):
            assert ac.count_matches(Input(haystack)) == len(expected)


@pytest.mark.parametrize("cfg_name,cfg", CONFIGS)
@pytest.mark.parametrize(
    "kind",
    [MatchKind.STANDARD, MatchKind.LEFTMOST_FIRST, MatchKind.LEFTMOST_LONGEST],
)
def test_ascii_case_insensitive(cfg_name, cfg, kind):
    for name, patterns, haystack, expected in corpus.iter_tests(
        [corpus.ASCII_CASE_INSENSITIVE,
         corpus.ASCII_CASE_INSENSITIVE_NON_OVERLAPPING]
    ):
        ac = AhoCorasick(patterns, match_kind=kind,
                         ascii_case_insensitive=True, **cfg)
        got = triples(ac.try_find_iter(Input(haystack)))
        assert got == expected, (name, patterns, haystack, kind, cfg_name,
                                 got)


@pytest.mark.parametrize("cfg_name,cfg", CONFIGS)
def test_ascii_case_insensitive_overlapping(cfg_name, cfg):
    for name, patterns, haystack, expected in corpus.iter_tests(
        [corpus.ASCII_CASE_INSENSITIVE,
         corpus.ASCII_CASE_INSENSITIVE_OVERLAPPING]
    ):
        ac = AhoCorasick(patterns, match_kind=MatchKind.STANDARD,
                         ascii_case_insensitive=True, **cfg)
        got = triples(ac.try_find_overlapping_iter(Input(haystack)))
        assert got == expected, (name, patterns, haystack, cfg_name, got)


# ---------------------------------------------------------------------------
# Against the JAX facade (seeded subset)
# ---------------------------------------------------------------------------
KINDS = [MatchKind.STANDARD, MatchKind.LEFTMOST_FIRST,
         MatchKind.LEFTMOST_LONGEST]
ALPHA = [97, 98, 99, 65, 66, 0, 255, 32]


@pytest.mark.parametrize("seed", range(3))
def test_seeded_against_jax_facade(seed):
    """Same seeded patterns, haystacks and knobs through both facades,
    both forced onto their bit-parallel engines (interpret-mode Pallas
    on the JAX side)."""
    rng = np.random.default_rng(500 + seed)
    for _ in range(4):
        pats = [bytes(rng.choice(ALPHA, size=int(rng.integers(1, 7)))
                      .astype(np.uint8))
                for _ in range(int(rng.integers(1, 6)))]
        hay = bytes(rng.choice(ALPHA, size=int(rng.integers(0, 600)))
                    .astype(np.uint8))
        mk = KINDS[int(rng.integers(3))]
        ci = bool(rng.integers(2))
        jk = J.MatchKind(mk.value)
        jac = J.AhoCorasick(pats, match_kind=jk, ascii_case_insensitive=ci,
                            engine="bitap", device_threshold=0)
        tac = AhoCorasick(pats, match_kind=mk, ascii_case_insensitive=ci,
                          engine="bitap", device_threshold=0)
        assert tac._bitap_engine() is not None
        assert triples(tac.find_iter(Input(hay))) == triples(
            jac.find_iter(J.Input(hay))), (pats, hay[:40], mk, ci)
        if mk.is_standard():
            assert triples(tac.find_overlapping_iter(Input(hay))) == \
                triples(jac.find_overlapping_iter(J.Input(hay)))
            assert tac.count_matches(Input(hay)) == \
                jac.count_matches(J.Input(hay))
        reps = [b"<%d>" % i for i in range(len(pats))]
        assert tac.replace_all_bytes(hay, reps) == \
            jac.replace_all_bytes(hay, reps)


def test_ineligible_set_against_jax_facade():
    """Empty patterns put a set outside the bit-parallel engine: both
    facades take their native walks."""
    pats = [b"", b"ab", b"b"]
    hay = b"abba cab " * 30
    jac = J.AhoCorasick(pats)
    tac = AhoCorasick(pats)
    assert tac._bitap_engine() is None
    assert triples(tac.find_iter(Input(hay))) == triples(
        jac.find_iter(J.Input(hay)))
    assert tac.count_matches(Input(hay)) == jac.count_matches(J.Input(hay))


# ---------------------------------------------------------------------------
# Routing and device
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode,kind", [
    ("cascade", MatchKind.STANDARD),
    ("cascade", MatchKind.LEFTMOST_LONGEST),
    ("dfa-scan", MatchKind.STANDARD),
    ("dfa-scan", MatchKind.LEFTMOST_FIRST),
    ("device-only", MatchKind.STANDARD),
])
def test_forced_engines_equal_jax_facade(mode, kind):
    """Each engine mode the port once lacked runs through both facades
    (the JAX one with interpret-mode Pallas) with the same triples; the
    builder setter accepts it too."""
    rng = np.random.default_rng(29)
    pats = sorted({bytes(rng.choice(list(b"abcdefgh"),
                                    int(rng.integers(3, 9))).astype(np.uint8))
                   for _ in range(40)})
    hay = bytes(rng.choice(list(b"abcdefghij "), 3000).astype(np.uint8))
    kw = dict(engine=mode, device_threshold=0)
    jac = J.AhoCorasick(pats, match_kind=J.MatchKind(kind.value), **kw)
    tac = AhoCorasick(pats, match_kind=kind, **kw)
    want = triples(jac.find_iter(J.Input(hay)))
    assert triples(tac.find_iter(Input(hay))) == want and len(want) > 20
    if kind.is_standard():
        assert triples(tac.find_overlapping_iter(Input(hay))) == triples(
            jac.find_overlapping_iter(J.Input(hay)))
        assert tac.count_matches(Input(hay)) == jac.count_matches(
            J.Input(hay))
    served = {"cascade": tac._cascade, "dfa-scan": tac._dev_automaton,
              "device-only": tac._fp if tac._bitap is None else tac._bitap}
    assert served[mode] is not None
    assert AhoCorasickBuilder(device="cpu").engine(mode)._engine == mode


@pytest.mark.parametrize("kind", KINDS)
def test_forced_fingerprint_against_jax_facade(kind):
    """engine="fingerprint" on a set the bit-parallel engine also accepts:
    both facades run the fingerprint engine (host verify at this size)."""
    rng = np.random.default_rng(23)
    pats = sorted({bytes(rng.choice(list(b"abcdefgh"),
                                    int(rng.integers(3, 9))).astype(np.uint8))
                   for _ in range(60)})
    hay = bytes(rng.choice(list(b"abcdefghij "), 6000).astype(np.uint8))
    jac = J.AhoCorasick(pats, engine="fingerprint",
                        match_kind=J.MatchKind(kind.value))
    tac = AhoCorasick(pats, engine="fingerprint", match_kind=kind)
    assert tac._bitap_engine() is None
    assert triples(tac.find_iter(Input(hay))) == triples(
        jac.find_iter(J.Input(hay)))
    assert tac._fp is not None
    if kind.is_standard():
        assert triples(tac.find_overlapping_iter(Input(hay))) == triples(
            jac.find_overlapping_iter(J.Input(hay)))
        assert tac.count_matches(Input(hay)) == jac.count_matches(
            J.Input(hay)) > 50


def test_unknown_engine_and_device():
    with pytest.raises(ValueError):
        AhoCorasick(["abc"], engine="teddy")
    with pytest.raises(ValueError):
        _AhoCorasick(["abc"], device="meta")


def test_default_device_is_cuda(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _AhoCorasick(["abc"])
    assert AhoCorasick(["abc"]).device().type == "cpu"


def test_large_haystack_routes_to_pad_byte_kernel(monkeypatch):
    """n >= BAKED_MIN with a pad byte packs with the pad byte (G2's
    layout); results stay exact."""
    import ahocorasick_tpu_torch.ops.bitap as TB

    monkeypatch.setattr(TB, "BAKED_MIN", 4096)
    pats = ["Sherlock Holmes", "John Watson", "Holmes"]
    hay = ("x Sherlock Holmes met John Watson. " * 200).encode()
    ac = AhoCorasick(pats)
    eng = ac._bitap_engine()
    assert eng._use_baked(len(hay)) and eng.prepare(hay).baked
    truth = AhoCorasick(pats, engine="oracle")
    assert triples(ac.find_overlapping_iter(hay)) == triples(
        truth.find_overlapping_iter(hay))
    assert ac.count_matches(hay) == 600


# ---------------------------------------------------------------------------
# Error contracts (tests/test_errors.py, ported)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize(
    "kind", [MatchKind.LEFTMOST_FIRST, MatchKind.LEFTMOST_LONGEST]
)
def test_leftmost_rejects_overlapping(kind):
    ac = AhoCorasick(["foo", "foofoo"], match_kind=kind)
    with pytest.raises(MatchError) as ei:
        list(ac.try_find_overlapping_iter(Input("foofoo")))
    assert ei.value.kind == "unsupported-overlapping"
    with pytest.raises(MatchError):
        ac.try_find_overlapping(Input("foofoo"), OverlappingState())
    with pytest.raises(MatchError):
        ac.count_matches(Input("foofoo"))


def test_standard_supports_overlapping():
    ac = AhoCorasick(["foo", "foofoo"], match_kind=MatchKind.STANDARD)
    got = triples(ac.find_overlapping_iter(Input("foofoo")))
    assert got == [(0, 0, 3), (1, 0, 6), (0, 3, 6)]


@pytest.mark.parametrize("start_kind",
                         [StartKind.UNANCHORED, StartKind.BOTH])
def test_unanchored_accepted(start_kind):
    ac = AhoCorasick(["b"], start_kind=start_kind)
    assert ac.find(Input("ab")).astuple() == (0, 1, 2)


@pytest.mark.parametrize("start_kind", [StartKind.ANCHORED, StartKind.BOTH])
def test_anchored_accepted(start_kind):
    ac = AhoCorasick(["a"], start_kind=start_kind)
    inp = Input("ab").set_anchored(Anchored.YES)
    assert ac.find(inp).astuple() == (0, 0, 1)


def test_anchored_rejected_when_unanchored_only():
    ac = AhoCorasick(["a"], start_kind=StartKind.UNANCHORED)
    inp = Input("a").set_anchored(Anchored.YES)
    with pytest.raises(MatchError) as ei:
        ac.try_find(inp)
    assert ei.value.kind == "invalid-input-anchored"
    with pytest.raises(MatchError):
        list(ac.try_find_iter(inp))


def test_unanchored_rejected_when_anchored_only():
    ac = AhoCorasick(["a"], start_kind=StartKind.ANCHORED)
    with pytest.raises(MatchError) as ei:
        ac.try_find(Input("a"))
    assert ei.value.kind == "invalid-input-unanchored"
    with pytest.raises(MatchError):
        list(ac.try_find_iter(Input("a")))
    with pytest.raises(MatchError):
        ac.try_replace_all("a", ["b"])


def test_anchored_consistency_all_apis():
    ac = AhoCorasick(["x"], start_kind=StartKind.ANCHORED)
    unanchored = Input("x")
    with pytest.raises(MatchError):
        list(ac.try_find_overlapping_iter(unanchored))
    with pytest.raises(MatchError):
        ac.count_matches(unanchored)
    assert ac.is_match(Input("xy").set_anchored(Anchored.YES))


def test_contiguous_state_id_overflow(monkeypatch):
    from ahocorasick_tpu_torch.automata import contiguous, noncontiguous
    from ahocorasick_tpu_torch.utils.errors import BuildError

    monkeypatch.setattr(contiguous, "_NEXT_LIMIT", 16)
    nfa = noncontiguous.compile_nfa(
        [b"abcdef", b"ghijkl", b"mnopqr"], builder="python"
    )
    with pytest.raises(BuildError) as ei:
        contiguous.build_contiguous(nfa, 3)
    assert ei.value.kind == "state-id-overflow"


def test_noncontiguous_state_id_overflow(monkeypatch):
    from ahocorasick_tpu_torch.automata import noncontiguous
    from ahocorasick_tpu_torch.utils.errors import BuildError

    monkeypatch.setattr(noncontiguous, "MAX_SMALL_INDEX", 8)
    with pytest.raises(BuildError) as ei:
        noncontiguous.compile_nfa([b"abc", b"def", b"ghi"],
                                  builder="python")
    assert ei.value.kind == "state-id-overflow"


def test_pattern_id_overflow(monkeypatch):
    from ahocorasick_tpu_torch.automata import noncontiguous
    from ahocorasick_tpu_torch.utils.errors import BuildError

    monkeypatch.setattr(noncontiguous, "MAX_SMALL_INDEX", 2)
    with pytest.raises(BuildError) as ei:
        noncontiguous.compile_nfa([b"a", b"b", b"c"], builder="python")
    assert ei.value.kind == "pattern-id-overflow"


def test_search_respects_input_span():
    ac = AhoCorasick(["foo"])
    hay = "foofoo"
    assert triples(ac.find_iter(Input(hay).span(3, 6))) == [(0, 3, 6)]
    assert triples(ac.find_iter(Input(hay).span(1, 6))) == [(0, 3, 6)]
    assert list(ac.find_iter(Input(hay).span(1, 5))) == []


def test_case_insensitive_build_not_exponential():
    pats = ["Sherlock", "Holmes", "Watson", "#&#&_@&#", "BrUh"] * 4
    ac = AhoCorasick(pats, ascii_case_insensitive=True,
                     match_kind=MatchKind.LEFTMOST_FIRST)
    m = ac.find(Input("x shERLock y"))
    assert m is not None and m.astuple()[1:] == (2, 10)


def test_rare_byte_prefilter_bounds():
    ac = AhoCorasick(["iti"])
    assert triples(ac.find_iter(Input("osssssssssssssssiti"))) == [
        (0, 16, 19)]
    ac = AhoCorasick(["e_sugar", "s_sugar"])
    hay = "testing e_sugar and s_sugar yum"
    assert triples(ac.find_iter(Input(hay))) == [(0, 8, 15), (1, 20, 27)]


def test_earliest_semantics():
    ac = AhoCorasick(["foo", "foofoo"], match_kind=MatchKind.LEFTMOST_LONGEST)
    assert ac.find(Input("foofoo")).astuple() == (1, 0, 6)
    assert ac.find(Input("foofoo").set_earliest(True)).astuple() == (0, 0, 3)


def test_debug_dump():
    from ahocorasick_tpu_torch.utils.debug import sparse_transitions

    ac = AhoCorasick(["abc", "bc", "b"], match_kind=MatchKind.LEFTMOST_FIRST)
    s = ac.debug_str()
    assert "noncontiguous::NFA(" in s and "dfa::DFA(" in s
    assert "*" in s and "fail =>" in s
    assert list(sparse_transitions([(0, 5), (1, 5), (2, 7), (9, 7)])) == [
        (0, 1, 5), (2, 2, 7), (9, 9, 7)
    ]
    assert "more states" in ac.debug_str(max_states=2)


def _drain(a, h, limit=None, st=None):
    st = OverlappingState() if st is None else st
    out = []
    while limit is None or len(out) < limit:
        a.try_find_overlapping(Input(h), st)
        m = st.get_match()
        if m is None:
            break
        out.append(m.astuple())
    return out, st


def test_overlapping_resumable_device_backed():
    pats = ["foo", "foofoo", "oo"]
    hay = b"foofoo" * 40
    ac = AhoCorasick(pats, device_threshold=16)
    aco = AhoCorasick(pats, engine="oracle")
    got, _ = _drain(ac, hay)
    want, _ = _drain(aco, hay)
    assert got == want and len(got) > 100
    got_partial, st = _drain(ac, hay, limit=5)
    want_partial, sto = _drain(aco, hay, limit=5)
    assert got_partial == want_partial
    hay2 = hay + b"foo"
    assert _drain(ac, hay2, st=st)[0] == _drain(aco, hay2, st=sto)[0]


def test_overlapping_drained_then_input_switch():
    pats = ["foo", "oo"]
    hay1 = b"xxfoo xx"
    hay2 = b"zzzzzfoo"
    ac = AhoCorasick(pats, device_threshold=4)
    aco = AhoCorasick(pats, engine="oracle")

    def run(a):
        st = OverlappingState()
        seq = []
        for _ in range(16):
            a.try_find_overlapping(Input(hay1), st)
            m = st.get_match()
            seq.append(None if m is None else m.astuple())
            if m is None:
                break
        for _ in range(4):
            a.try_find_overlapping(Input(hay2), st)
            m = st.get_match()
            seq.append(None if m is None else m.astuple())
        return seq

    assert run(ac) == run(aco)


# ---------------------------------------------------------------------------
# Streams (tests/test_stream.py, ported)
# ---------------------------------------------------------------------------
def _stream_cases():
    for name, patterns, haystack, expected in corpus.iter_tests(
        corpus.AC_STANDARD_NON_OVERLAPPING
    ):
        if any(len(p) == 0 for p in patterns):
            continue
        yield name, patterns, haystack, expected


@pytest.mark.parametrize("chunk_size", [1, 3, 1 << 20])
def test_stream_find_iter_corpus(chunk_size):
    for name, patterns, haystack, expected in _stream_cases():
        ac = AhoCorasick(patterns)
        got = triples(stream_find_iter(ac, io.BytesIO(haystack.encode()),
                                       chunk_size=chunk_size))
        assert got == expected, (name, chunk_size, got)


@pytest.mark.parametrize("chunk_size", [1, 7, 1 << 20])
def test_stream_replace_all(chunk_size):
    ac = AhoCorasick(["fox", "brown", "quick"])
    w = io.BytesIO()
    stream_replace_all(ac, io.BytesIO(b"The quick brown fox jumps." * 5), w,
                       [b"sloth", b"grey", b"slow"], chunk_size=chunk_size)
    assert w.getvalue() == b"The slow grey sloth jumps." * 5


def test_stream_replace_matches_inline_replace():
    rnd = random.Random(11)
    pats = ["ab", "bc", "ca"]
    reps = [b"X", b"YY", b""]
    for _ in range(10):
        h = "".join(rnd.choice("abc") for _ in range(500)).encode()
        ac = AhoCorasick(pats)
        want = ac.replace_all_bytes(h, reps)
        for cs in (1, 13, 100000):
            w = io.BytesIO()
            stream_replace_all(ac, io.BytesIO(h), w, reps, chunk_size=cs)
            assert w.getvalue() == want, (h[:30], cs)


def test_stream_rejects_leftmost_and_empty():
    ac = AhoCorasick(["x"], match_kind=MatchKind.LEFTMOST_FIRST)
    with pytest.raises(MatchError) as ei:
        list(stream_find_iter(ac, io.BytesIO(b"x")))
    assert ei.value.kind == "unsupported-stream"
    ac = AhoCorasick(["x", ""])
    with pytest.raises(MatchError) as ei:
        list(stream_find_iter(ac, io.BytesIO(b"x")))
    assert ei.value.kind == "unsupported-empty"


def test_stream_replace_with_callback():
    ac = AhoCorasick(["cat", "dog"])
    w = io.BytesIO()
    stream_replace_all_with(ac, io.BytesIO(b"a cat and a dog"), w,
                            lambda m, matched: matched.upper())
    assert w.getvalue() == b"a CAT and a DOG"
    w = io.BytesIO()
    ac.try_stream_replace_all_with(io.BytesIO(b"a cat"), w,
                                   lambda m, matched: b"<" + matched + b">")
    assert w.getvalue() == b"a <cat>"


def test_stream_boundary_regression():
    magic = b"1234j"
    begin = 65_535
    data = bytearray(b"\x00" * 100_000)
    data[begin:begin + len(magic)] = magic
    ac = AhoCorasick([magic])
    whole = triples(ac.find_iter(bytes(data)))
    for cs in (65_536, 8192, 1):
        got = triples(stream_find_iter(ac, io.BytesIO(bytes(data)),
                                       chunk_size=cs))
        assert got == whole == [(0, begin, begin + len(magic))], (cs, got)


# ---------------------------------------------------------------------------
# Fuzz cross-product (tests/test_fuzz.py, ported to the engines this
# package has: bitap and auto, against the oracle walk)
# ---------------------------------------------------------------------------
def _gen_case(rng):
    pats = []
    for _ in range(int(rng.integers(1, 8))):
        ln = int(rng.integers(0, 9))  # empty patterns included
        pats.append(bytes(rng.choice(ALPHA, size=ln).astype(np.uint8)))
    if all(len(p) == 0 for p in pats):
        pats[0] = b"a"
    hay = bytes(rng.choice(ALPHA, size=int(rng.integers(0, 800)))
                .astype(np.uint8))
    cfg = dict(
        match_kind=KINDS[int(rng.integers(3))],
        ascii_case_insensitive=bool(rng.integers(2)),
        byte_classes=bool(rng.integers(2)),
        prefilter=bool(rng.integers(2)),
        dense_depth=[0, 1, 2, 3, 1 << 20][int(rng.integers(5))],
        kind=[None, AhoCorasickKind.CONTIGUOUS_NFA,
              AhoCorasickKind.DFA][int(rng.integers(3))],
    )
    engine = ["bitap", "auto"][int(rng.integers(2))]
    return pats, hay, cfg, engine


@pytest.mark.parametrize("seed", range(12))
def test_fuzz_cross_product(seed):
    rng = np.random.default_rng(1000 + seed)
    for _ in range(16):
        pats, hay, cfg, engine = _gen_case(rng)
        truth = AhoCorasick(pats, engine="oracle", **cfg)
        ac = AhoCorasick(pats, engine=engine, device_threshold=0, **cfg)
        assert triples(ac.find_iter(Input(hay))) == triples(
            truth.find_iter(Input(hay))), (pats, hay[:40], cfg, engine)
        if cfg["match_kind"].is_standard():
            assert triples(ac.find_overlapping_iter(Input(hay))) == \
                triples(truth.find_overlapping_iter(Input(hay)))
        reps = [b"<%d>" % i for i in range(len(pats))]
        assert ac.try_replace_all_bytes(hay, reps) == \
            truth.try_replace_all_bytes(hay, reps)
