"""The port's `select_nonzero_words` held against the JAX package's.

Inputs are the `tests/test_compaction.py` ones (seeded densities, sizes
and caps, including empty, cap-overflow and single-block shapes). Outputs
are integers: the tolerance is exact equality of the count, the first
min(count, cap) indices and values and the live mask; past the count the
port fills indices with the array size, which the JAX engine applies
after the call (`jnp.where(live, widx, size)`). `select_set_bits` is held
to the same: count, live mask, and (word, bit) of the first min(count,
cap) set bits.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ahocorasick_tpu.ops.compaction import (
    select_nonzero_words as jax_select,
    select_set_bits as jax_select_bits,
)
from ahocorasick_tpu_torch.ops.compaction import (
    select_nonzero_words,
    select_set_bits,
)


def _check(words: np.ndarray, cap: int):
    jt, jidx, jvals, jlive = jax_select(jnp.asarray(words), cap)
    count, idx, vals, live = select_nonzero_words(torch.from_numpy(words),
                                                  cap)
    assert count == int(jt) == np.count_nonzero(words)
    k = min(cap, count)
    np.testing.assert_array_equal(idx.numpy()[:k], np.asarray(jidx)[:k])
    np.testing.assert_array_equal(vals.numpy()[:k], np.asarray(jvals)[:k])
    np.testing.assert_array_equal(live.numpy(), np.asarray(jlive))
    fill = np.where(np.asarray(jlive), np.asarray(jidx), words.size)
    np.testing.assert_array_equal(idx.numpy(), fill)
    assert (vals.numpy()[k:] == 0).all()
    assert idx.dtype == torch.int64 and vals.dtype == torch.int32


@pytest.mark.parametrize("seed", range(4))
def test_select_nonzero_words_random(seed):
    rng = np.random.default_rng(100 + seed)
    for _ in range(5):
        n = int(rng.choice([128, 1024, 1 << 14]))
        dens = float(rng.choice([0.0, 0.01, 0.3]))
        words = np.where(rng.random(n) < dens,
                         rng.integers(1, 1 << 31, n), 0).astype(np.int32)
        _check(words, int(rng.choice([64, 512, 4096])))


def test_select_single_block_edge():
    words = np.zeros(128, np.int32)
    words[3] = 0b1010
    _check(words, 8)


def test_select_negative_words_and_overflow():
    # End words use all 32 bits: int32 values with the top bit set.
    words = np.zeros(4096, np.int32)
    words[[0, 5, 4095]] = [-1, np.int32(-(1 << 31)), 7]
    _check(words, 2)
    _check(words, 3)


def test_select_rejects_2d():
    with pytest.raises(ValueError):
        select_nonzero_words(torch.zeros((2, 128), dtype=torch.int32), 4)


def _check_bits(words: np.ndarray, cap: int):
    jt, jw, jb, jlive = jax_select_bits(jnp.asarray(words), cap)
    count, widx, bit, live = select_set_bits(torch.from_numpy(words), cap)
    bits = np.unpackbits(words.view(np.uint8), bitorder="little")
    assert count == int(jt) == int(bits.sum())
    k = min(cap, count)
    np.testing.assert_array_equal(live.numpy(), np.asarray(jlive))
    np.testing.assert_array_equal(widx.numpy()[:k], np.asarray(jw)[:k])
    np.testing.assert_array_equal(bit.numpy()[:k], np.asarray(jb)[:k])
    assert (widx.numpy()[k:] == words.size).all()
    assert (bit.numpy()[k:] == 0).all()
    # (word, bit) order is flat bit order.
    np.testing.assert_array_equal(
        (widx.numpy() * 32 + bit.numpy())[:k], np.flatnonzero(bits)[:k])


@pytest.mark.parametrize("seed", range(4))
def test_select_set_bits_random(seed):
    rng = np.random.default_rng(200 + seed)
    for _ in range(4):
        n = int(rng.choice([128, 1024, 1 << 13]))
        dens = float(rng.choice([0.0, 0.01, 0.2]))
        words = np.where(rng.random(n) < dens,
                         rng.integers(-(1 << 31), 1 << 31, n), 0
                         ).astype(np.int32)
        _check_bits(words, int(rng.choice([64, 512, 4096])))


def test_select_set_bits_edges():
    words = np.zeros(256, np.int32)
    words[[0, 7, 255]] = [np.int32(-(1 << 31)), -1, 1]
    for cap in (1, 2, 33, 34, 64):
        _check_bits(words, cap)
    with pytest.raises(ValueError):
        select_set_bits(torch.zeros((2, 128), dtype=torch.int32), 4)
