"""Pattern sets and haystacks from a seed.

Frozen copies of the generators that the card smoke test of the port used
(`_concat_words`, `english`, `build_words`, `build_dict_text`), so that a
change to the program or to that script never moves the benchmark's
inputs. Every generator is vectorised and deterministic for its seed.
The configuration and workload files name them through the small modules
of ``portbench/generators/``, one file per generator.
"""

from __future__ import annotations

from typing import List

import numpy as np

MIB = 1 << 20

# English-like filler of the JAX package's headline bench.
WORDS = (
    "the quick brown fox jumps over lazy dog time of day it was best "
    "worst epoch belief incredulity season light darkness hope despair"
).split()
# Syllables of the dictionary names (the JAX package's dict1k / dict100k
# generator) and of the prose filler words around them.
NAME_SYLLABLES = (
    "bar bel bor dan dar del dor fan far gar gor hal han har kar kel "
    "kor lan lor mar mor nal nar nor pal par ral ran rok sar sel sor "
    "tan tar tor val van var vor wan war zan zor"
).split()
PROSE_SYLLABLES = (
    "a be ce de e fi ge hi i je ke li me ni o pe qui re si te u ve "
    "we xi ye ze tion ing ed er ly un de re in con com pro per"
).split()
SYLLABLES = {"name": NAME_SYLLABLES, "prose": PROSE_SYLLABLES}


def rng_of(seed: int) -> np.random.Generator:
    """The generator of a run's ``--seed``: any whole number, negative or
    past 64 bits included."""
    return np.random.default_rng(seed % (1 << 64))


def _concat_words(vocab, pick, n: int, rng) -> bytes:
    """n bytes of words from ``vocab`` (each ending in a space), drawn by
    ``pick(rng, count)``, assembled with vectorised gathers in 8 MiB
    blocks."""
    flat = np.frombuffer(b"".join(vocab), np.uint8)
    lens = np.array([len(v) for v in vocab], np.int64)
    offs = np.cumsum(lens) - lens
    out, size = [], 0
    while size < n:
        idx = pick(rng, (8 * MIB) // 5)
        ln = lens[idx]
        dst = np.cumsum(ln) - ln
        gather = np.arange(int(ln.sum())) + np.repeat(offs[idx] - dst, ln)
        block = flat[gather]
        out.append(block)
        size += len(block)
    return np.concatenate(out)[:n].tobytes()


def english(n: int, rng: np.random.Generator, names: List[bytes],
            name_rate: float) -> bytes:
    """English-like text with ``names`` planted at ``name_rate`` per
    word."""
    vocab = [w.encode() + b" " for w in WORDS] + [p + b" " for p in names]
    p = np.full(len(vocab), (1 - name_rate) / len(WORDS))
    p[len(WORDS):] = name_rate / len(names)
    return _concat_words(vocab, lambda r, k: r.choice(len(vocab), size=k,
                                                      p=p), n, rng)


def build_words(count: int, seed: int, syllables: List[str],
                capitalize: float = 0.0) -> List[bytes]:
    """``count`` distinct words of 2-4 syllables, a share ``capitalize``
    of them capitalised, sorted."""
    rng = np.random.default_rng(seed)
    pats = set()
    while len(pats) < count:
        ns = int(rng.integers(2, 5))
        w = "".join(syllables[int(rng.integers(len(syllables)))]
                    for _ in range(ns))
        if capitalize and rng.random() < capitalize:
            w = w.capitalize()
        pats.add(w.encode())
    return sorted(pats)


def dict_text(n: int, rng: np.random.Generator, pats: List[bytes],
              density: float, filler: List[bytes]) -> bytes:
    """Prose-shaped text with planted dictionary hits: each word is a
    dictionary entry with probability ``density``, else one of the
    ``filler`` words, words separated by one space (the JAX package's
    bench generator, drawn in bulk)."""
    vocab = [w + b" " for w in pats] + [w + b" " for w in filler]
    P = len(pats)

    def pick(r, k):
        hit = r.random(k) < density
        return np.where(hit, r.integers(0, P, k),
                        P + r.integers(0, len(filler), k))
    return _concat_words(vocab, pick, n, rng)


def cut(stream: bytes, size: int, count: int) -> List[bytes]:
    """``count`` haystacks of ``size`` bytes, cut in turn from ``stream``."""
    return [stream[i * size:(i + 1) * size] for i in range(count)]
