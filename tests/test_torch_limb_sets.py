"""The pattern sets of the limb-group rows (G1/G2 beyond 64 limbs).

One definition for the CPU tests (`tests/test_torch_limb_groups.py`), the
card tests (`tests/test_torch_cuda.py`) and `chip_smoke.py`, so that all
three hold the kernels on the same sets. This module imports numpy,
pytest and the tests' shared settings (`torch_suite.py`, torch and pytest)
at its top, and nothing of the port, so a script can load it beside any
checkout of the port.
"""

import numpy as np
import pytest

from torch_suite import per_test_time_limit  # noqa: F401


def random_words(count, lo, hi, seed):
    """``count`` distinct random lowercase words of lo..hi bytes."""
    rng = np.random.default_rng(seed)
    out = set()
    while len(out) < count:
        n = int(rng.integers(lo, hi + 1))
        out.add(rng.integers(97, 123, n, dtype=np.uint8).tobytes())
    return sorted(out)


# K = 65, 103 (128 words of 4-8 bytes, pad byte 0, no staged route: the
# shape of a mid-size keyword list), 229 (256 three-byte patterns, no pad
# byte), 461 (488 words of 3 bytes) and 1,121 (every one-byte pattern and
# 896 two-byte ones: 2,048 bytes, no pad byte), which run every group size
# (4, 8, 16 lanes of 32 limbs, 32 of 64); and 22 chains of 65 bytes,
# three limbs each, which cross the boundary of two lanes (limbs 30-32),
# so the carry between lanes is exercised.
SETS = {
    "k65": [bytes([i]) + b"ab" for i in range(92)],
    "k103": random_words(128, 4, 8, 0),
    "k229": [bytes([i]) + b"ab" for i in range(256)],
    "k461": random_words(488, 3, 3, 0),
    "k1121": [bytes([i]) for i in range(256)]
    + [bytes([i % 256, 97 + i // 256]) for i in range(896)],
    "lane_carry": random_words(22, 65, 65, 1),
}
K_OF = {"k65": 65, "k103": 103, "k229": 229, "k461": 461, "k1121": 1121}


def limb_sets():
    """{K: patterns} of the sets named by their K."""
    return {K: SETS[name] for name, K in K_OF.items()}


# The staged route beyond 64 limbs (G3/G4's limb groups). Decollided
# packing puts about one chain per limb, so a keyword list's 4-byte
# prefixes need nearly as many limbs as the list: 100 random lowercase
# words of 8-16 bytes give K = 83 and Kf = 75 (pad byte 0, staged-eligible:
# the facade's count of 4 MiB or more runs G3 at Kf = 75 and G4 at K = 83);
# with the 70-byte LONG pattern, past the device-verify window, the
# extraction takes the staged route too (K = 85, Kf = 76, Ke = 83, halo
# 128). 130 short names ending in "xyz" give K = 107 and Kf = 105 but are
# not staged-eligible: their tables go to the wrappers directly.
LONG = bytes(range(65, 91)) * 2 + b"abcdefghijklmnopqr"
STAGED_SETS = {
    "w100": random_words(100, 8, 16, 0),
    "w100_long": random_words(100, 8, 16, 0) + [LONG],
    "spill": [bytes([65 + i % 26, 97 + i // 26]) + b"abcdefghijklmnop"[:i % 7]
              + b"xyz" for i in range(130)],
}
# (K, Kf, staged-eligible at 64 MiB) of each staged set.
STAGED_K = {"w100": (83, 75, True), "w100_long": (85, 76, True),
            "spill": (107, 105, False)}


@pytest.mark.parametrize("name", list(STAGED_SETS))
def test_staged_set_packs_to_its_limbs(name):
    """Each staged set packs into the K limbs (its prefixes into the Kf)
    that STAGED_K gives, and is staged-eligible where it says so."""
    from ahocorasick_tpu_torch.ops.staged import StagedEngine

    pats = STAGED_SETS[name]
    eng = StagedEngine(pats, False, "cpu")
    K, Kf, eligible = STAGED_K[name]
    assert (eng.full.k, eng.fp.k) == (K, Kf)
    assert StagedEngine.eligible(pats, 64 << 20) == eligible


@pytest.mark.parametrize("name", list(SETS))
def test_set_packs_to_its_limbs(name):
    """Each set packs into the K limbs its name gives (the lane-crossing
    set into more than 64), within the bit-parallel engine's 2,048
    pattern bytes."""
    from ahocorasick_tpu_torch.ops.bitap import BitapTables
    from ahocorasick_tpu_torch.ops.bitap_kernels import MAX_REG_LIMBS

    pats = SETS[name]
    K = BitapTables(pats, False).k
    assert K == K_OF.get(name, K) and K > MAX_REG_LIMBS
    assert sum(map(len, pats)) <= 2048
