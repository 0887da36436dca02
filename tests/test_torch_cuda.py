"""The port's Hopper kernels on the card (marker `cuda`).

Each kernel is held against its plain PyTorch version on the same CUDA
tensors, and the facade is driven through the kernels with their launch
counters checked. Outputs are integers: the tolerance is exact equality.
Run on a machine with an NVIDIA GPU and nvcc:

    python -m pytest -m cuda tests/test_torch_cuda.py

Whether a card is present is decided inside the fixture, so every worker
collects the same tests; without a card they skip.
"""

import numpy as np
import pytest
import torch

from ahocorasick_tpu_torch import AhoCorasick
from ahocorasick_tpu_torch.ops import bitap as TB
from ahocorasick_tpu_torch.ops import bitap_kernels as TK

pytestmark = pytest.mark.cuda

NAMES = [b"Sherlock Holmes", b"John Watson", b"Irene Adler",
         b"Inspector Lestrade", b"Professor Moriarty"]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _hay(n, seed, pats):
    rng = np.random.default_rng(seed)
    buf = bytearray(rng.integers(32, 127, n, dtype=np.uint8).tobytes())
    for i, pos in enumerate(rng.integers(0, max(n - 64, 1), 50)):
        p = pats[i % len(pats)]
        buf[pos:pos + len(p)] = p
    return bytes(buf)


SETS = {
    "names": NAMES,
    "no_pad_byte": [bytes(range(8 * i, 8 * i + 8)) for i in range(32)],
    "k65": [bytes([i]) + b"ab" for i in range(92)],
    "k229": [bytes([i]) + b"ab" for i in range(256)],
}


@pytest.mark.parametrize("extract", [False, True])
@pytest.mark.parametrize("name", list(SETS))
def test_generic_kernel_equals_plain(dev, name, extract):
    eng = TB.BitapEngine(SETS[name], False, dev)
    hay = _hay(300_000, 1, SETS[name])
    ph = eng.prepare(hay, baked=False)
    lo, hi, sm, em = eng._args()
    n = len(hay)
    got = TK.bitap_scan_generic(lo, hi, sm, em, ph.halo_a, ph.body, 37, n,
                                extract)
    want = TK.bitap_scan_generic_plain(lo, hi, sm, em, ph.halo_a, ph.body,
                                       37, n, extract)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        if w is not None:
            assert torch.equal(g, w)


@pytest.mark.parametrize("extract", [False, True])
def test_baked_kernel_equals_plain(dev, extract):
    eng = TB.BitapEngine(NAMES, False, dev)
    hay = _hay(1 << 20, 2, NAMES)
    ph = eng.prepare(hay)
    assert ph.baked
    lo, hi, sm, em = eng._args()
    el = eng.tables.end_limbs
    got = TK.bitap_scan_baked(lo, hi, sm, em, el, ph.halo_a, ph.body,
                              extract)
    want = TK.bitap_scan_baked_plain(lo, hi, sm, em, el, ph.halo_a, ph.body,
                                     extract)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        if w is not None:
            assert torch.equal(g, w)


def test_facade_goes_through_kernels(dev):
    hay = _hay(1 << 20, 3, NAMES)
    ac = AhoCorasick([p.decode() for p in NAMES], device=dev)
    truth = AhoCorasick([p.decode() for p in NAMES], device="cpu",
                        engine="oracle")
    TK.reset_counts()
    assert ac.count_matches(hay) == truth.count_matches(hay)
    assert TK.baked_launches == 1 and TK.generic_launches == 0
    small = hay[:594_915]
    assert [m.astuple() for m in ac.find_iter(small)] == [
        m.astuple() for m in truth.find_iter(small)]
    assert TK.generic_launches == 1
