"""G3 and the staged pipeline of the port held against the JAX package's.

The G3 flags kernel (`_make_flags_kernel`, Pallas in interpret mode)
against the plain PyTorch version and the engine's flags, and the fused
extraction jit (`_staged_extract_jit`) against the port's candidates and
rescans, on the inputs and helpers of `tests/test_torch_staged.py`. Kept
apart from that file's engine cases, whose 100-word set compiles K = 83
kernels, so that the two run on different test workers. Every output is
an integer: the tolerance is exact equality.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import ahocorasick_tpu.ops.staged as JS
from ahocorasick_tpu_torch.ops import staged_kernels as SK
from test_torch_staged import CASES, R, _engines, _np
from torch_suite import per_test_time_limit  # noqa: F401


# ---------------------------------------------------------------------------
# Kernels: plain versions against the Pallas kernels
# ---------------------------------------------------------------------------
def _jax_flags(jeng, jph):
    t = jeng.fp
    kern = JS._make_flags_kernel(*t.baked_key(), t.k, jph.Lc, jeng.halo)
    Hw, Wc = jeng.halo // 4, jph.Lc // 4
    return _np(pl.pallas_call(
        kern, grid=(jph.tiles, jph.L // jph.Lc),
        in_specs=[
            pl.BlockSpec((Hw, R, 128), lambda i, j: (0, i, 0),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((Wc, R, 128), lambda i, j: (j, i, 0),
                         memory_space=pltpu.VMEM),
        ],
        out_specs=[pl.BlockSpec((1, R, 128), lambda i, j: (i, 0, 0),
                                memory_space=pltpu.VMEM)],
        out_shape=[jax.ShapeDtypeStruct((jph.tiles, R, 128), jnp.int32)],
        scratch_shapes=[pltpu.VMEM((t.k, R, 128), jnp.int32)],
        interpret=True,
    )(jph.halo_a, jph.body)[0])


@pytest.mark.parametrize("name", CASES)
def test_flags_plain_equals_pallas(name):
    """Raw flag words, halo hits included and stream 0's halo flag
    zeroed."""
    jeng, teng, hay = _engines(name)
    jph, tph = jeng.prepare(hay), teng.prepare(hay)
    want = _jax_flags(jeng, jph)
    lo, hi, sm, em = teng.fp.device_tensors("cpu")
    got = SK.staged_flags_plain(lo, hi, sm, em, tph.rows, teng.halo)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != 0).sum() > 5
    # The port's engine-level flags (the wrapper on a CPU tensor).
    np.testing.assert_array_equal(teng.flags(tph).numpy(), want)


# ---------------------------------------------------------------------------
# Pipelines against the fused JAX jits
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["names", "long_pattern"])
def test_pipeline_equals_staged_jits(name):
    jeng, teng, hay = _engines(name)
    jph, tph = jeng.prepare(hay), teng.prepare(hay)
    cap = 1024
    total, ncand = jeng.count_fn(jph, cap)()
    tn, cand = teng.candidates(tph, cap)
    counts, _ = teng.rescan(tph, cand, extract=False)
    assert tn == int(ncand) and int(counts.sum()) == int(total) > 0

    t = jeng.full
    Ke = len(t.end_limbs)
    fn = JS._staged_extract_jit(jeng.fp.baked_key(), t.baked_key(),
                                jeng.fp.k, t.k, jph.L, jph.Lc, jph.Lc,
                                jeng.halo, jph.tiles, cap, 4096, Ke)
    jtot, jnc, jcand, jnnzw, jwix, jvals = fn(
        jph.rows, jph.hrows, jph.halo_a, jph.body,
        jnp.asarray([0, jph.n], jnp.int32))
    np.testing.assert_array_equal(cand.numpy(), _np(jcand))
    counts, words = teng.rescan(tph, cand, extract=True)
    assert int(counts.sum()) == int(jtot)
    flat = words.reshape(-1)
    nz = torch.nonzero(flat).flatten().numpy()
    assert len(nz) == int(jnnzw)
    np.testing.assert_array_equal(nz, _np(jwix)[:len(nz)])
    np.testing.assert_array_equal(flat.numpy()[nz], _np(jvals)[:len(nz)])
