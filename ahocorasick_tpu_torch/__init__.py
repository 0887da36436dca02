"""ahocorasick_tpu_torch — the PyTorch and CUDA port of ahocorasick_tpu.

Multi-pattern string search with the capabilities of the `aho-corasick`
crate (BurntSushi/aho-corasick v1.1.3), on an NVIDIA GPU:

  - Host-side trie + BFS failure-link construction compiles pattern sets
    into flat int32 automaton tables (automata/; optional native C++
    builder in csrc/acbuild.cc).
  - The device engines, routed as the JAX package routes them: the exact
    bit-parallel shift-AND scan (ops/bitap.py, kernels G1/G2 in
    csrc/bitap.cu), the staged prefix-flag + rescan engine for large
    counts and extractions (ops/staged.py, G3/G4 in csrc/staged.cu) and
    the bucketed fingerprint filter with on-device verification for large
    pattern sets and fused extraction (ops/fingerprint.py, G5/G6 in
    csrc/fingerprint.cu), and the cascade engine for dictionaries of
    10k-100k+ patterns (ops/cascade.py: a G5/G6 pass over deduped prefixes,
    then exact-key probes and verification in torch); the kernels cut each
    haystack stream into segments, one CUDA thread each, on the shared
    shift-AND core (csrc/shift_and.cuh). The blocked device DFA walk
    (ops/block_scan.py; W1/W2 in csrc/dfa_walk.cu, one thread per
    sub-block) backs the forced `dfa-scan` / `device-only` modes.
  - Standard / leftmost-first / leftmost-longest semantics, overlapping
    search, anchored search, ASCII case folding, replacement and stream
    search/replace all reproduce the reference's (pattern, start, end)
    output exactly (semantics.py, oracle.py).

The JAX package ``ahocorasick_tpu`` is the reference this port is held
to; this package imports nothing from it and nothing from JAX.

Quick start::

    from ahocorasick_tpu_torch import AhoCorasick
    ac = AhoCorasick(["apple", "maple", "Snapple"])          # on "cuda"
    ac = AhoCorasick(["apple", "maple", "Snapple"], device="cpu")
    for m in ac.find_iter("Nobody likes maple in their apple flavored Snapple."):
        print(m.pattern, m.start, m.end)
"""

from . import transducer
from .ahocorasick import AhoCorasick, AhoCorasickBuilder, AhoCorasickKind
from .oracle import OverlappingState
from .utils.errors import BuildError, MatchError
from .utils.search import (
    Anchored,
    Input,
    Match,
    MatchKind,
    Span,
    StartKind,
)

__version__ = "0.1.0"

__all__ = [
    "AhoCorasick",
    "AhoCorasickBuilder",
    "AhoCorasickKind",
    "Anchored",
    "BuildError",
    "Input",
    "Match",
    "MatchError",
    "MatchKind",
    "OverlappingState",
    "Span",
    "StartKind",
    "transducer",
    "__version__",
]
