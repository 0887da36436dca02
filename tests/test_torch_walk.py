"""The blocked DFA walk's plain versions (ops/walk_kernels.py) held against
the JAX package's walks.

`walk_states_plain` and `walk_count_plain` walk the same DFA over the same
padded buffer as the JAX jits `_scan_states_jit` and `_count_matches_jit`,
and count a shard's row as the JAX `parallel/shard.py::count_kernel`
does; all are held against `scan_states_host`. The kernels' layout
(`walk_plan`'s sub-blocks) gives the same states and counts as the JAX
layout. The kernels themselves run on the card (tests/test_torch_cuda.py);
here the ctypes signatures are held against the C prototypes. Every output
is an integer: the tolerance is exact equality.
"""

import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ahocorasick_tpu as J
import ahocorasick_tpu.ops.block_scan as JB
from ahocorasick_tpu.parallel.shard import count_kernel
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
    # only the empty pattern: max pattern length 0, halo 0, one class
    "halo_zero": ([b""], 3_000, b"xyz"),
    # byte classes off: the identity alphabet
    "no_byte_classes": ([b"he", b"she", b"his", b"hers"], 12_345,
                        b"hisre "),
    # a 200-byte pattern: a 256-byte halo over 128-byte blocks (R7)
    "halo_over_block": ([b"a" * 200, b"ab", b"ba"], 6_040, b"aaaab"),
}
JAX_CASES = [k for k in CASES if k != "halo_over_block"]


def _case(name):
    pats, n, alpha = CASES[name]
    bc = name != "no_byte_classes"
    hay = np.random.default_rng(len(name)).choice(list(alpha), n).astype(
        np.uint8).tobytes()
    tac = T.AhoCorasick(pats, byte_classes=bc, device="cpu")
    tda = TBS.DeviceAutomaton(tac._dfa, "cpu")
    return pats, bc, hay, tac, tda


def _args(tda, buf, block_len, halo):
    return (tda.trans_flat, tda.classes, buf, tda.alphabet_len,
            tda.start_id, block_len, halo)


@pytest.mark.parametrize("name", JAX_CASES)
def test_plain_walks_equal_jax_jits(name):
    pats, bc, hay, tac, tda = _case(name)
    jda = JB.DeviceAutomaton(J.AhoCorasick(pats, byte_classes=bc)._dfa)
    buf, n, block_len, halo = tda._prepare(hay)
    a = _args(tda, buf, block_len, halo)
    states = WK.walk_states_plain(*a)
    jbuf = jnp.asarray(buf.numpy())
    want = np.asarray(JB._scan_states_jit(
        jda.trans_flat, jda.classes, jbuf, jnp.int32(jda.alphabet_len),
        jnp.int32(jda.start_id), block_len, halo))
    np.testing.assert_array_equal(states.numpy(), want)
    np.testing.assert_array_equal(states[:n].numpy(),
                                  TBS.scan_states_host(tac._dfa, hay))
    jtotal = int(JB._count_matches_jit(
        jda.trans_flat, jda.classes, jda.match_count, jbuf, jnp.int32(n),
        jnp.int32(jda.alphabet_len), jnp.int32(jda.start_id), block_len,
        halo))
    got = WK.walk_count_plain(*a, tda.match_count, 0, n)
    assert got.dtype == torch.int64 and got.dim() == 0
    assert int(got) == jtotal
    # The CPU wrappers compute the plain versions.
    assert torch.equal(WK.walk_states(*a), states)
    assert int(WK.walk_count(*a, tda.match_count, 0, n)) == jtotal


@pytest.mark.parametrize("name", [k for k in JAX_CASES
                                  if k != "short_haystack"])
def test_windowed_count_equals_jax_shard_count_kernel(name):
    """One shard's row whose leading halo holds haystack bytes (so the JAX
    module's zero fill before the first shard plays no part), counted over
    the window [halo, halo + n_valid) as `count_kernel` counts it."""
    pats, bc, hay, tac, tda = _case(name)
    jda = JB.DeviceAutomaton(J.AhoCorasick(pats, byte_classes=bc)._dfa)
    halo = tda.halo
    n_valid = len(hay) - halo - 77
    shard = -(-n_valid // 128) * 128
    block_len = JB.choose_block_len(shard, halo)
    shard = -(-shard // block_len) * block_len
    row = np.zeros(halo + shard, np.uint8)
    row[:halo + n_valid] = np.frombuffer(hay, np.uint8)[:halo + n_valid]
    want = int(count_kernel(
        jda.trans_flat, jda.classes, jda.match_count, jnp.asarray(row),
        jnp.asarray([n_valid], dtype=jnp.int32), jnp.int32(jda.alphabet_len),
        jnp.int32(jda.start_id), block_len, halo))
    got = WK.walk_count_plain(*_args(tda, torch.from_numpy(row), block_len,
                                     halo), tda.match_count, halo,
                              halo + n_valid)
    assert int(got) == want
    host = TBS.scan_states_host(tac._dfa, row[:halo + n_valid].tobytes())
    mc = tda.match_count.numpy()
    assert want == int(mc[host[halo:]].sum())


@pytest.mark.parametrize("name", list(CASES))
def test_walk_plan_equals_the_jax_layout(name):
    """The kernels' sub-blocks (walk_plan) and the JAX layout's blocks give
    the same states, and the same counts over the whole haystack and over
    a window, also with a halo longer than a block."""
    _, _, hay, tac, tda = _case(name)
    buf, n, block_len, halo = tda._prepare(hay)
    sub = WK.walk_plan(len(buf), halo)
    assert sub >= max(16, 8 * halo) and sub & (sub - 1) == 0
    jax_layout = _args(tda, buf, block_len, halo)
    plan = _args(tda, buf, sub, halo)
    states = WK.walk_states_plain(*plan)
    np.testing.assert_array_equal(states.numpy(),
                                  WK.walk_states_plain(*jax_layout).numpy())
    np.testing.assert_array_equal(states[:n].numpy(),
                                  TBS.scan_states_host(tac._dfa, hay))
    for n0, n1 in ((0, n), (n // 3, n - n // 5)):
        assert int(WK.walk_count_plain(*plan, tda.match_count, n0, n1)) == (
            int(WK.walk_count_plain(*jax_layout, tda.match_count, n0, n1)))


def test_halo_over_block_equals_host_walk():
    """R7: the JAX jits' roll-and-reshape windows fail where the halo is
    longer than a block; the plain walk skips the halo steps before the
    buffer's start, on a haystack that fills its bucket too."""
    _, _, hay, tac, tda = _case("halo_over_block")
    for h in (hay, b"a" * 4096):
        buf, n, block_len, halo = tda._prepare(h)
        assert halo > block_len
        a = _args(tda, buf, block_len, halo)
        host = TBS.scan_states_host(tac._dfa, h)
        np.testing.assert_array_equal(WK.walk_states_plain(*a)[:n].numpy(),
                                      host)
        assert int(WK.walk_count_plain(*a, tda.match_count, 0, n)) == int(
            tda.match_count.numpy()[host].sum())
    assert tda.count_matches(b"a" * 4096) == 4096 - 199


def test_walk_plan():
    mib = 1 << 20
    assert WK.walk_plan(64 * mib, 16) == 256
    assert 64 * mib // 256 == WK.TARGET_THREADS
    assert WK.walk_plan(64 * mib, 64) == 512
    assert WK.walk_plan(128 << 10, 256) == 2048
    assert WK.walk_plan(4096, 0) == 16 and WK.walk_plan(4096, 1) == 16
    assert WK.count_blocks(64 * mib, 256) == 512
    assert WK.count_blocks(30_208, 64) == 1


def test_wrappers_check_their_arguments():
    _, _, hay, _, tda = _case("odd_lengths")
    buf, n, block_len, halo = tda._prepare(hay)
    a = _args(tda, buf, block_len, halo)
    with pytest.raises(TypeError):
        WK.walk_states(tda.trans_flat.long(), *a[1:])
    with pytest.raises(ValueError):
        WK.walk_count(*a, tda.match_count, 5, len(buf) + 1)
    with pytest.raises(ValueError):
        WK.walk_count(*a, tda.match_count[:-1], 0, n)
    with pytest.raises(ValueError):
        WK.walk_states(tda.trans_flat, tda.classes, buf, tda.alphabet_len,
                       tda.num_states, block_len, halo)
    # A table past the kernels' int32 index (a zero-stride view, no memory).
    huge = torch.zeros(1, dtype=torch.int32).expand(1 << 31)
    with pytest.raises(ValueError, match="int32"):
        WK.walk_states(huge, *a[1:])


def test_signatures_match_the_c_entry_points():
    """The ctypes argument codes of each entry point of csrc/dfa_walk.cu,
    the caller's stream last, read from the source: one code per C
    parameter (a pointer or the stream c_void_p, an int c_int, a long
    long c_longlong)."""
    with open(WK.LIBRARY.src) as f:
        src = f.read()
    code = {"int": ctypes.c_int, "long long": ctypes.c_longlong}
    assert set(WK.LIBRARY.signatures) == {"walk_states", "walk_count"}
    for name, argtypes in WK.LIBRARY.signatures.items():
        params = re.search(rf"\nint {name}\(([^)]*)\)", src).group(1)
        want = []
        for decl in params.split(","):
            typ = " ".join(decl.split()[:-1]).replace("const ", "")
            want.append(ctypes.c_void_p if "*" in typ else code[typ])
        assert want[-1] is ctypes.c_void_p  # the stream
        assert list(argtypes) == want, name
