"""Haystacks ``dict_prose``: English-like prose for a dictionary search,
one stream from the run's seed cut into the pool.

Each word of the stream is, independently, a dictionary entry (at
``hit_rate`` per word, uniform over the set), a near miss (at
``near_rate``: a word that shares an entry's first ``prefix_len`` bytes
and completes no entry, as "national" is to "nationally"; one drawn for
each entry, so that a prefix is met in proportion to its family), a long word
(at ``long_rate``: ``prefix_len`` or one more letters of prose syllables
that begin no entry, as "remember" or "tomorrow" begin no word of ten
letters or more) or else a short common word; words are separated by one
space. The near misses, up to three letters past a prefix, and the
``long_words`` long words are drawn once per pattern set from
``vocab_seed``. Only entries and near misses hold a window of
``prefix_len`` bytes equal to an entry's prefix, and only entries hold
matches; long words hold windows that a bucketed filter cannot tell
from a prefix.
"""

import numpy as np

from portbench import gen

SHORT = ("the of and to a in is you that it he was for on are as with "
         "his they i at be this have from or one had by not but what all "
         "were we when your can said there use an each which she do how "
         "their if will up other about out many then them these so some "
         "her would make like him into time has look two more go see no "
         "way could people my than first been call who its now find long "
         "down day did get come made may part know just over think also "
         "back after work well even want here life because good").split()
LETTERS = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", np.uint8)


def near_misses(patterns, spec) -> list:
    """One draw per entry: the entry's prefix and 0-3 random letters,
    kept where no entry is a substring of it. A prefix heads as many
    draws as it heads entries, so that near misses, like entries, meet
    the families in proportion to their sizes."""
    rng = np.random.default_rng(spec["vocab_seed"])
    plen = spec["prefix_len"]
    words = set(patterns)
    minlen = min(len(p) for p in patterns)
    out = []
    for p, k in zip(patterns, rng.integers(0, 4, len(patterns)).tolist()):
        w = p[:plen] + LETTERS[rng.integers(0, 26, k)].tobytes()
        if not any(w[i:i + ln] in words
                   for ln in range(minlen, len(w) + 1)
                   for i in range(len(w) - ln + 1)):
            out.append(w)
    return out


def long_words(patterns, spec) -> list:
    """``long_words`` distinct words of ``prefix_len`` to ``prefix_len``
    + 1 letters of prose syllables that begin no entry."""
    plen, k = spec["prefix_len"], spec["long_words"]
    heads = {p[:plen] for p in patterns}
    out = [w for w in gen.build_words(8 * k, spec["vocab_seed"],
                                      gen.PROSE_SYLLABLES)
           if plen <= len(w) <= plen + 1 and w[:plen] not in heads]
    keep = np.random.default_rng(spec["vocab_seed"]).choice(len(out), k,
                                                            replace=False)
    return [out[i] for i in sorted(keep.tolist())]


def pool(spec, patterns, size, count, seed):
    near = near_misses(patterns, spec)
    long = long_words(patterns, spec)
    vocab = [w + b" " for w in list(patterns) + near + long
             + [s.encode() for s in SHORT]]
    P, N, G, S = len(patterns), len(near), len(long), len(SHORT)
    bounds = np.cumsum([spec["hit_rate"], spec["near_rate"],
                        spec["long_rate"]])

    def pick(r, k):
        kind = np.searchsorted(bounds, r.random(k), side="right")
        first = np.array([0, P, P + N, P + N + G])[kind]
        size = np.array([P, N, G, S])[kind]
        return first + (r.random(k) * size).astype(np.int64)
    stream = gen._concat_words(vocab, pick, size * count, gen.rng_of(seed))
    return gen.cut(stream, size, count)
