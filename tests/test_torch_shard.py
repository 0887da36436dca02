"""The port's mesh-sharded search (`ahocorasick_tpu_torch.parallel.shard`)
on the CPU.

- The cases of the JAX package's tests/test_shard.py on meshes of 1, 2 and
  8 `cpu` entries, each equal to the port's single-device facade.
- Tiny cases equal to the JAX sharded functions on the JAX package's
  8-device CPU mesh (tests/conftest.py): bitap count, staged count, bitap
  and fingerprint pairs, cascade pairs (Pallas in interpret mode).
- The two differences from the JAX module: the staged cap clamped to the
  stream count (ROADMAP R2) and no fill byte before the haystack (R8).
- The asserts of `dryrun_multichip` (__graft_entry__.py) on the port.

Every engine runs with ``device="cpu"`` (the kernels' plain PyTorch
versions). Outputs are integers: the tolerance is exact equality.
"""

import io
import random

import numpy as np
import pytest
import torch

from ahocorasick_tpu_torch import AhoCorasick as _AhoCorasick
from ahocorasick_tpu_torch import Input, MatchKind, semantics
from ahocorasick_tpu_torch.ops.bitap import BitapEngine
from ahocorasick_tpu_torch.ops.cascade import CascadeEngine
from ahocorasick_tpu_torch.ops.fingerprint import FingerprintEngine
from ahocorasick_tpu_torch.ops.staged import StagedEngine
from ahocorasick_tpu_torch.parallel.shard import (
    Mesh,
    ShardedSearcher,
    make_mesh,
    sharded_bitap_count,
    sharded_bitap_match_pairs,
    sharded_cascade_match_pairs,
    sharded_count_matches,
    sharded_fp_match_pairs,
    sharded_staged_count,
    sharded_stream_replace_all,
)
from torch_suite import per_test_time_limit  # noqa: F401

NDEVS = [1, 2, 8]
SYL = ("bar bel bor dan dar del dor fan far gar gor hal han har kar kel "
       "kor lan lor mar mor nal nar").split()


def AhoCorasick(pats, **kw):
    kw.setdefault("device", "cpu")
    return _AhoCorasick(pats, **kw)


def cpu_mesh(ndev):
    return Mesh(["cpu"] * ndev)


def total_overlapping(ac, h):
    return sum(1 for _ in ac.find_overlapping_iter(Input(h)))


def pairs(ac, h):
    return [(m.pattern, m.end) for m in ac.find_overlapping_iter(Input(h))]


def straddled(pat: bytes, n: int, ndev: int = 8, fill=b"."):
    """n bytes of ``fill`` with ``pat`` across every shard boundary."""
    h = bytearray(fill * n)
    shard = -(-n // ndev)
    for i in range(1, ndev):
        p = i * shard - len(pat) // 2
        h[p:p + len(pat)] = pat
    return bytes(h)


def fp_case():
    """tests/test_shard.py's fingerprint case: 300 patterns beyond the
    bit-parallel bounds, planted across 8 shard boundaries."""
    rng = np.random.default_rng(41)
    pats = sorted({
        rng.choice(list(b"abcdefgh"), int(rng.integers(4, 12)))
        .astype(np.uint8).tobytes()
        for _ in range(300)
    })
    assert sum(len(p) for p in pats) > 2048
    h = rng.choice(list(b"abcdefghijk"), 20000).astype(np.uint8).tobytes()
    hb = bytearray(h)
    shard = -(-len(hb) // 8)
    for i in range(1, 8):
        p = pats[i * 17 % len(pats)]
        pos = i * shard - len(p) // 2
        hb[pos:pos + len(p)] = p
    return pats, bytes(hb)


def cascade_case(n=24000, count=400, seed=44):
    """tests/test_shard.py's cascade case: syllable names in filler text,
    planted across every boundary of 8 shards, both crossing the edge and
    with the coarse prefix ending just before it."""
    rng = np.random.default_rng(seed)
    pats = set()
    while len(pats) < count:
        k = int(rng.integers(2, 5))
        pats.add("".join(
            SYL[int(rng.integers(len(SYL)))] for _ in range(k)).encode())
    pats = sorted(pats)
    filler = [w.encode() for w in "xu qo ki ve zam tup lyn".split()]
    parts = [pats[int(rng.integers(len(pats)))] if rng.random() < 0.02
             else filler[int(rng.integers(len(filler)))]
             for _ in range(n // 5)]
    h = bytearray(b" ".join(parts)[:n])
    shard = -(-len(h) // 8)
    for i in range(1, 8):
        p = pats[(i * 31) % len(pats)]
        pos = i * shard - len(p) // 2
        h[pos:pos + len(p)] = p
        p2 = pats[(i * 7) % len(pats)]
        pos2 = max(0, i * shard - 2)
        h[pos2:pos2 + len(p2)] = p2
    return pats, bytes(h)


def staged_case(ndev, n=60000):
    random.seed(11)
    pats = [b"needle", b"haystack", b"sherlock"]
    h = bytearray("".join(random.choice("xyzw ") for _ in range(n)).encode())
    shard = -(-n // ndev)
    for i in range(ndev):
        p = pats[i % len(pats)]
        pos = min(max(0, i * shard - len(p) // 2), n - len(p))
        h[pos:pos + len(p)] = p
    return pats, bytes(h)


# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------
def test_make_mesh():
    m = make_mesh(8, "cpu")
    assert m.size == 8 and m.devices == [torch.device("cpu")] * 8
    assert make_mesh(device="cpu").size == 1
    assert Mesh(["cpu", torch.device("cpu")]).size == 2
    with pytest.raises(ValueError):
        Mesh([])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Mesh(["cuda:0"])
        ac = AhoCorasick(["ab"])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ShardedSearcher(ac)


# ---------------------------------------------------------------------------
# tests/test_shard.py on the port, against the port's facade
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("ndev", NDEVS)
def test_sharded_count_matches_small(ndev):
    random.seed(3)
    h = "".join(random.choice("abc") for _ in range(5000)).encode()
    ac = AhoCorasick(["ab", "babc", "c", "ccc"])
    got = sharded_count_matches(ac._engine("device_walk"), h, cpu_mesh(ndev))
    assert got == total_overlapping(ac, h) == ac.count_matches(h)


@pytest.mark.parametrize("ndev", NDEVS)
def test_sharded_count_cross_shard_matches(ndev):
    # Matches that span shard boundaries are counted once, by the shard
    # in which they END (halo warm-up).
    h = straddled(b"xyxyxyxy", 40000)
    ac = AhoCorasick(["xyxyxyxy"])
    want = total_overlapping(ac, h)
    assert want >= 7
    assert sharded_count_matches(ac._engine("device_walk"), h,
                                 cpu_mesh(ndev)) == want


@pytest.mark.parametrize("ndev", NDEVS)
def test_sharded_count_empty_and_tiny(ndev):
    ac = AhoCorasick(["abc"])
    m = cpu_mesh(ndev)
    assert sharded_count_matches(ac._engine("device_walk"), b"", m) == 0
    assert sharded_count_matches(ac._engine("device_walk"), b"abc", m) == 1
    ace = AhoCorasick(["ab", ""])
    h = b"xxabyab"
    assert (sharded_count_matches(ace._engine("device_walk"), h, m)
            == ace.count_matches(h) == total_overlapping(ace, h))


@pytest.mark.parametrize("ndev", NDEVS)
def test_sharded_bitap_count(ndev):
    random.seed(5)
    pats = [b"ab", b"babc", b"c", b"ccc"]
    h = "".join(random.choice("abc") for _ in range(5000)).encode()
    ac = AhoCorasick(pats)
    eng = BitapEngine(pats, False, "cpu")
    assert sharded_bitap_count(eng, h, cpu_mesh(ndev)) == total_overlapping(
        ac, h)


@pytest.mark.parametrize("ndev", NDEVS)
def test_sharded_bitap_cross_shard_matches(ndev):
    h = straddled(b"xyxyxyxy", 40000)
    ac = AhoCorasick([b"xyxyxyxy"])
    want = total_overlapping(ac, h)
    assert want >= 7
    eng = BitapEngine([b"xyxyxyxy"], False, "cpu")
    m = cpu_mesh(ndev)
    assert sharded_bitap_count(eng, h, m) == want
    assert sharded_bitap_count(eng, b"", m) == 0
    assert sharded_bitap_count(eng, b"xyxyxyxy", m) == 1


@pytest.mark.parametrize("ndev", NDEVS)
def test_sharded_match_pairs(ndev):
    random.seed(11)
    h = "".join(random.choice("abcx") for _ in range(6000)).encode()
    ac = AhoCorasick(["ab", "babc", "c", "ccc", "abcabc"])
    pids, ends = sharded_bitap_match_pairs(ac._engine("bitap"), h,
                                           cpu_mesh(ndev))
    assert list(zip(pids.tolist(), ends.tolist())) == pairs(ac, h)


@pytest.mark.parametrize("ndev", NDEVS)
def test_sharded_match_pairs_cross_shard(ndev):
    h = straddled(b"xyxyxyxy", 40000)
    ac = AhoCorasick(["xyxyxyxy", "yx"])
    pids, ends = sharded_bitap_match_pairs(ac._engine("bitap"), h,
                                           cpu_mesh(ndev))
    want = pairs(ac, h)
    assert list(zip(pids.tolist(), ends.tolist())) == want
    assert len(want) == 7 * 4  # per planted block: 1 long + 3 "yx"


@pytest.mark.parametrize("ndev", NDEVS)
def test_sharded_searcher_find_iter_semantics(ndev):
    pats = ["Samwise", "Sam", "wise"]
    h = ("Sam and Samwise the wise " * 40).encode()
    for kind in (MatchKind.STANDARD, MatchKind.LEFTMOST_FIRST,
                 MatchKind.LEFTMOST_LONGEST):
        ac = AhoCorasick(pats, match_kind=kind)
        ms = ShardedSearcher(ac, cpu_mesh(ndev))._match_set(Input(h))
        got = [m.astuple() for m in
               semantics.select_non_overlapping(ms, kind, 0)]
        assert got == [m.astuple() for m in ac.find_iter(Input(h))]


@pytest.mark.parametrize("ndev", NDEVS)
def test_sharded_stream_replace_all(ndev):
    random.seed(17)
    body = "".join(
        random.choice(["the fox ", "a dog ", "foxtrot! ", "zzz "])
        for _ in range(3000)
    ).encode()
    ac = AhoCorasick(["fox", "dog", "foxtrot"])
    reps = [b"F", b"D", b"FT"]
    want = ac.try_replace_all_bytes(body, reps)
    out = io.BytesIO()
    sharded_stream_replace_all(ac, io.BytesIO(body), out, reps,
                               mesh=cpu_mesh(ndev),
                               chunk_size=997)  # many carry rounds
    assert out.getvalue() == want


@pytest.mark.parametrize("ndev", [2, 8])
def test_sharded_stream_replace_cross_chunk_and_shard(ndev):
    h = bytearray(b"." * 30000)
    for p in range(911, len(h) - 8, 911):
        h[p:p + 8] = b"xyxyxyxy"
    h = bytes(h)
    ac = AhoCorasick(["xyxyxyxy"])
    want = ac.try_replace_all_bytes(h, [b"<>"])
    out = io.BytesIO()
    sharded_stream_replace_all(ac, io.BytesIO(h), out, [b"<>"],
                               mesh=cpu_mesh(ndev), chunk_size=4096)
    assert out.getvalue() == want


@pytest.mark.parametrize("ndev", NDEVS)
def test_sharded_fingerprint_match_pairs(ndev):
    """Pattern sets beyond the exact engine's bounds shard through the
    fingerprint filter with host verification."""
    pats, h = fp_case()
    eng = FingerprintEngine(pats, False, "cpu")
    got = sharded_fp_match_pairs(eng, h, cpu_mesh(ndev))
    assert got is not None
    want = pairs(AhoCorasick(pats), h)
    assert list(zip(got[0].tolist(), got[1].tolist())) == want
    assert len(want) >= 7


@pytest.mark.parametrize("ndev", [2, 8])
def test_sharded_searcher_fingerprint_stream_replace(ndev):
    rng = np.random.default_rng(43)
    pats = sorted({
        rng.choice(list(b"mnopqrst"), int(rng.integers(5, 12)))
        .astype(np.uint8).tobytes()
        for _ in range(340)
    })
    assert sum(len(p) for p in pats) > 2048
    bb = bytearray(rng.choice(list(b"mnopqrstuvwx"), 12000)
                   .astype(np.uint8).tobytes())
    for p in range(500, len(bb) - 12, 1500):
        pat = pats[p % len(pats)]
        bb[p:p + len(pat)] = pat
    body = bytes(bb)
    ac = AhoCorasick(pats)
    reps = [b"<%d>" % i for i in range(len(pats))]
    want = AhoCorasick(pats, engine="oracle").try_replace_all_bytes(body,
                                                                    reps)
    ss = ShardedSearcher(ac, cpu_mesh(ndev))
    assert ss._eng is None and ss._fp_eng is not None
    out = io.BytesIO()
    sharded_stream_replace_all(ac, io.BytesIO(body), out, reps,
                               mesh=cpu_mesh(ndev), chunk_size=2048)
    assert out.getvalue() == want


def test_sharded_match_pairs_slabbed(monkeypatch):
    """Extraction larger than ndev * MAX_EXTRACT_CHUNK slabs the
    haystack and still gives the exact match set, including matches
    straddling slab boundaries."""
    from ahocorasick_tpu_torch.ops import bitap as B

    monkeypatch.setattr(B, "MAX_EXTRACT_CHUNK", 1 << 10)
    random.seed(13)
    n = 40000
    h = bytearray("".join(random.choice("abcx") for _ in range(n)).encode())
    slab = (1 << 10) * 8
    for i in range(1, 4):
        p = i * slab - 3
        h[p:p + 6] = b"abcabc"
    h = bytes(h)
    ac = AhoCorasick(["ab", "babc", "abcabc"])
    pids, ends = sharded_bitap_match_pairs(ac._engine("bitap"), h,
                                           cpu_mesh(8))
    assert list(zip(pids.tolist(), ends.tolist())) == pairs(ac, h)


@pytest.mark.parametrize("ndev", NDEVS)
def test_sharded_cascade_match_pairs(ndev):
    """The very-large-dictionary cascade over the mesh: G6 (the set has a
    strong pad byte) with ownership by prefix end, forward halos."""
    pats, h = cascade_case()
    eng = CascadeEngine(pats, False, "cpu")
    assert eng.pad_byte is not None
    got = sharded_cascade_match_pairs(eng, h, cpu_mesh(ndev))
    assert got is not None
    single = eng.match_pairs(h)
    np.testing.assert_array_equal(got[0], single[0])
    np.testing.assert_array_equal(got[1], single[1])
    want = pairs(AhoCorasick(pats), h)
    assert list(zip(got[0].tolist(), got[1].tolist())) == want
    assert len(want) >= 14


def test_sharded_cascade_no_pad_duplicates_and_side():
    """The cascade's other branches over 8 shards: no strong pad byte
    (G5 with the owned window), case-insensitive duplicate patterns
    (the CSR expansion) and a pattern beyond W_CASCADE (the sharded side
    engine)."""
    pats, h = cascade_case(n=12000, count=200, seed=45)
    allbytes = bytes(range(0, 256, 3))  # every low and high nybble
    long = b"Q" * 70
    pats = pats + [p.upper() for p in pats[:20]] + [allbytes, long]
    hb = bytearray(h)
    for at in (100, 5999, 8000):
        hb[at:at + len(long)] = long
    hb[3000:3000 + len(allbytes)] = allbytes
    hb[6003:6003 + 12] = pats[3].upper()[:12]
    h = bytes(hb)
    eng = CascadeEngine(pats, True, "cpu")
    assert eng.pad_byte is None and eng.side is not None
    assert eng.tables.dups8
    got = sharded_cascade_match_pairs(eng, h, cpu_mesh(8))
    assert got is not None
    ac = AhoCorasick(pats, ascii_case_insensitive=True,
                     device_threshold=1 << 62)
    want = pairs(ac, h)
    assert list(zip(got[0].tolist(), got[1].tolist())) == want
    assert any(p == len(pats) - 1 for p, _ in want)


@pytest.mark.parametrize("ndev", [2, 8])
def test_sharded_staged_count(ndev):
    """Two-stage count over the mesh equals the overlapping count,
    including matches straddling shard boundaries."""
    pats, h = staged_case(ndev)
    ac = AhoCorasick([p.decode() for p in pats])
    want = total_overlapping(ac, h)
    assert want >= ndev - 1
    eng = StagedEngine(pats, False, "cpu")
    assert sharded_staged_count(eng, h, cpu_mesh(ndev)) == want


def test_sharded_call_then_single_device_call():
    """A sharded call leaves each engine's own caps and results as they
    were: the same engine then answers single-device calls exactly."""
    pats, h = staged_case(2)
    st = StagedEngine(pats, False, "cpu")
    want = total_overlapping(AhoCorasick([p.decode() for p in pats]), h)
    single = st.match_pairs(h)
    caps = (st._cap_s, st._cap_w)
    assert sharded_staged_count(st, h, cpu_mesh(8)) == want
    assert (st._cap_s, st._cap_w) == caps
    assert st.count_matches(h) == want
    np.testing.assert_array_equal(st.match_pairs(h)[1], single[1])

    cpats, ch = cascade_case()
    cas = CascadeEngine(cpats, False, "cpu")
    assert sharded_cascade_match_pairs(cas, ch, cpu_mesh(8)) is not None
    assert cas._caps == {}
    one = cas.match_pairs(ch)
    assert cas.count_matches(ch) == len(one[0])
    got = sharded_cascade_match_pairs(cas, ch, cpu_mesh(2))
    np.testing.assert_array_equal(got[1], one[1])

    fpats, fh = fp_case()
    fp = FingerprintEngine(fpats, False, "cpu")
    sharded = sharded_fp_match_pairs(fp, fh, cpu_mesh(8))
    np.testing.assert_array_equal(fp.match_pairs(fh)[1], sharded[1])


@pytest.mark.parametrize("which", ["cascade", "fingerprint"])
def test_sharded_hostility_counts_owned_candidates(which, monkeypatch):
    """A sharded call turns hostile where the single-device candidate
    count passes the limit: each candidate counts once, in the shard that
    owns it (the cascade's unmasked G6 also flags positions in the halos
    and forward regions), and the call leaves the engine's ``hostile``
    flag as it was."""
    from ahocorasick_tpu_torch.ops import fingerprint as F

    if which == "cascade":
        pats, h = cascade_case()
        eng = CascadeEngine(pats, False, "cpu")
        assert eng.pad_byte is not None  # G6, no position mask
        ph = eng.prepare(h)
        _, bmp = F.bitmap(eng.tables.device_tensors("cpu")["coarse"], ph)
        ncand = F._rank_select(bmp, ph.L, 1)[0]

        def limit(lim):
            monkeypatch.setattr(eng, "_limits", lambda n: (lim, 1 << 40))
        run = sharded_cascade_match_pairs
    else:
        pats, h = fp_case()
        eng = FingerprintEngine(pats, False, "cpu")
        ncand = len(eng.candidates(h))

        def limit(lim):
            monkeypatch.setattr(eng, "_hostile_limit", lambda n: lim)
        run = sharded_fp_match_pairs
    single = eng.match_pairs(h)
    assert ncand > 8
    limit(ncand)
    got = run(eng, h, cpu_mesh(8))
    assert got is not None
    np.testing.assert_array_equal(got[0], single[0])
    np.testing.assert_array_equal(got[1], single[1])
    limit(ncand - 1)
    assert run(eng, h, cpu_mesh(8)) is None
    assert not eng.hostile


def test_staged_cap_clamped_to_the_streams():
    """ROADMAP R2: with 3,072 streams (not a power of two) and more than
    2,048 of them flagged, the grown cap passes 4,096 > 3,072; the JAX
    function then gives up (None), the port clamps the cap to 3,072 and
    counts."""
    from ahocorasick_tpu.ops.staged import StagedEngine as JStaged
    from ahocorasick_tpu.parallel import shard as JS

    pats = [b"abcdefgh", b"qrstuvwxyz"]
    rng = np.random.default_rng(2)
    n = 3 * 1024 * 512 - 600
    h = bytearray(rng.choice(list(b"ijklmnop"), n).astype(np.uint8)
                  .tobytes())
    for s in range(2600):
        at = s * 512 + 200
        h[at:at + 8] = b"abcdefgh" if s % 3 else b"abcdzzzz"
    h = bytes(h)
    st = StagedEngine(pats, False, "cpu")
    L, _, tiles = st._layout(st.halo + n)
    assert tiles * 1024 == 3072
    want = AhoCorasick(pats, device_threshold=1 << 62).count_matches(h)
    assert want == 2600 - 867
    assert sharded_staged_count(st, h, cpu_mesh(1)) == want
    import jax
    jmesh = JS.make_mesh(1)
    assert len(jax.devices()) >= 8
    assert JS.sharded_staged_count(JStaged(pats, False), h, jmesh) is None


@pytest.mark.parametrize("ndev", NDEVS)
def test_no_fill_byte_before_the_haystack(ndev):
    """ROADMAP R8: a pattern holding NUL bytes does not match across the
    haystack's start (the JAX module zero-fills the first shard's halo
    and reports (0, 2) here)."""
    pats = [b"\x00ab", b"ab\x00"]
    h = b"ab" + b"x" * 3000 + b"ab\x00"
    ac = AhoCorasick(pats)
    want = pairs(ac, h)
    assert want == [(1, len(h))]
    m = cpu_mesh(ndev)
    eng = BitapEngine(pats, False, "cpu")
    assert sharded_bitap_count(eng, h, m) == 1
    got = sharded_bitap_match_pairs(eng, h, m)
    assert list(zip(got[0].tolist(), got[1].tolist())) == want
    assert sharded_count_matches(ac._engine("device_walk"), h, m) == 1


def test_r8_in_the_jax_module():
    """The JAX sharded bit-parallel count of the same case: one false
    match at the haystack's start (kept as the reference's behaviour)."""
    from ahocorasick_tpu.ops.bitap import BitapEngine as JBitap
    from ahocorasick_tpu.parallel import shard as JS

    h = b"ab" + b"x" * 3000
    assert JS.sharded_bitap_count(JBitap([b"\x00ab"], False), h,
                                  JS.make_mesh(2)) == 1
    assert sharded_bitap_count(BitapEngine([b"\x00ab"], False, "cpu"), h,
                               cpu_mesh(2)) == 0


# ---------------------------------------------------------------------------
# Against the JAX sharded functions (8-device CPU mesh), tiny inputs
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_mesh():
    import jax
    from ahocorasick_tpu.parallel import shard as JS

    assert len(jax.devices()) >= 8, "conftest must provide 8 cpu devices"
    return JS.make_mesh(8)


def test_bitap_count_and_pairs_equal_jax(jax_mesh):
    from ahocorasick_tpu.ops.bitap import BitapEngine as JBitap
    from ahocorasick_tpu.parallel import shard as JS

    random.seed(21)
    pats = [b"ab", b"babc", b"ccc", b"abcabc"]
    h = "".join(random.choice("abcx") for _ in range(3000)).encode()
    eng, jeng = BitapEngine(pats, False, "cpu"), JBitap(pats, False)
    m = cpu_mesh(8)
    assert sharded_bitap_count(eng, h, m) == JS.sharded_bitap_count(
        jeng, h, jax_mesh)
    got = sharded_bitap_match_pairs(eng, h, m)
    want = JS.sharded_bitap_match_pairs(jeng, h, jax_mesh)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_staged_count_equals_jax(jax_mesh):
    from ahocorasick_tpu.ops.staged import StagedEngine as JStaged
    from ahocorasick_tpu.parallel import shard as JS

    pats, h = staged_case(8, n=24000)
    got = sharded_staged_count(StagedEngine(pats, False, "cpu"), h,
                               cpu_mesh(8))
    assert got == JS.sharded_staged_count(JStaged(pats, False), h, jax_mesh)
    assert got >= 7


def test_fp_pairs_equal_jax(jax_mesh):
    from ahocorasick_tpu.ops.fingerprint import FingerprintEngine as JFp
    from ahocorasick_tpu.parallel import shard as JS

    pats, h = fp_case()
    h = h[:8000]
    got = sharded_fp_match_pairs(FingerprintEngine(pats, False, "cpu"), h,
                                 cpu_mesh(8))
    want = JS.sharded_fp_match_pairs(JFp(pats, False), h, jax_mesh)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert len(got[0]) > 0


def test_cascade_pairs_equal_jax(jax_mesh):
    from ahocorasick_tpu.ops.cascade import CascadeEngine as JCascade
    from ahocorasick_tpu.parallel import shard as JS

    pats, h = cascade_case(n=6000, count=200, seed=46)
    got = sharded_cascade_match_pairs(CascadeEngine(pats, False, "cpu"), h,
                                      cpu_mesh(8))
    want = JS.sharded_cascade_match_pairs(JCascade(pats, False), h,
                                          jax_mesh)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert len(got[0]) > 0


# ---------------------------------------------------------------------------
# dryrun_multichip (__graft_entry__.py:68-215) on the port
# ---------------------------------------------------------------------------
FLAGSHIP = ["Sherlock Holmes", "John Watson", "Irene Adler",
            "Inspector Lestrade", "Professor Moriarty"]


@pytest.mark.parametrize("ndev", [2, 8])
def test_dryrun_multichip_asserts(ndev):
    mesh = cpu_mesh(ndev)
    ac = AhoCorasick(FLAGSHIP, device_threshold=0)
    h = b"... Sherlock Holmes met John Watson ... " * 64
    assert sharded_count_matches(ac._engine("device_walk"), h, mesh) == 128
    eng = ac._engine("bitap")
    assert eng is not None
    assert sharded_bitap_count(eng, h, mesh) == 128
    seng = StagedEngine(ac._patterns, False, "cpu")
    assert sharded_staged_count(seng, h, mesh) == 128
    pids, ends = sharded_bitap_match_pairs(eng, h, mesh)
    spids, sends = eng.match_pairs(h)
    assert pids.tolist() == spids.tolist()
    assert ends.tolist() == sends.tolist()
    assert len(pids) == 128

    reps = [b"<SH>", b"<JW>", b"<IA>", b"<IL>", b"<PM>"]
    out = io.BytesIO()
    sharded_stream_replace_all(ac, io.BytesIO(h), out, reps, mesh=mesh,
                               chunk_size=997)
    assert out.getvalue() == ac.try_replace_all_bytes(h, reps)

    pats, hf = fp_case()
    got = sharded_fp_match_pairs(FingerprintEngine(pats, False, "cpu"), hf,
                                 mesh)
    assert got is not None
    want = [(m.pattern, m.end) for m in
            AhoCorasick(pats, engine="oracle").find_overlapping_iter(hf)]
    assert list(zip(got[0].tolist(), got[1].tolist())) == want
    assert len(want) >= ndev - 1

    rng = np.random.default_rng(41)
    syl = SYL[:20]
    cpats = sorted({
        (syl[i % 20] + syl[(i * 7) % 20] + syl[(i * 13) % 20]).encode()
        for i in range(600)
    })
    assert CascadeEngine.eligible(cpats)
    hc = bytearray(rng.choice(list(b"xq kzu"), 9000).astype(np.uint8)
                   .tobytes())
    shard = -(-len(hc) // ndev)
    for i in range(ndev):
        p = cpats[(i * 19) % len(cpats)]
        pos = min(max(0, i * shard - len(p) // 2), len(hc) - len(p))
        hc[pos:pos + len(p)] = p
    hc = bytes(hc)
    ceng = CascadeEngine(cpats, False, "cpu")
    got = sharded_cascade_match_pairs(ceng, hc, mesh)
    assert got is not None
    single = ceng.match_pairs(hc)
    assert got[0].tolist() == single[0].tolist()
    assert got[1].tolist() == single[1].tolist()
    assert len(got[0]) >= ndev - 1
