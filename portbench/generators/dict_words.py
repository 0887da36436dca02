"""Pattern set ``dict_words``: an English-like dictionary of long words,
in the shape of aho-corasick 1.1.3's ``dictionary/english/length-10.txt``,
from the configuration's fixed ``seed``.

``count`` distinct lowercase ASCII words, every one at least ``min_len``
bytes and exactly ``long_count`` of them at least ``long_len`` bytes,
under exactly ``prefixes`` distinct ``prefix_len``-byte prefixes, as a
dictionary groups its words under shared stems (administ-ration,
administ-rative, ...). A family (the words under one prefix) holds one
word and a Poisson number more, at a rate drawn lognormal; the spread of
that rate is set so that a word drawn at random lies in a family of
``hit_family`` words on average: the mean family of the prefix windows a
text of the dictionary's words meets, as the cascade's expansion rows
per exact prefix window count it. A prefix is
English-like syllables, a third of them behind a morphological prefix
(con-, inter-, under-, ...); each family has a root that its words
share, and each word is its prefix, the root and a chain of English
suffixes (-ation, -al, -ly, ...) cut to the word's length, so that
shorter words of a family are often prefixes of longer ones (national,
nationally). Lengths fall from ``min_len`` up. Sorted, as the source
list is.
"""

import numpy as np

MORPH = ("con com pro pre inter trans over under counter dis re un in "
         "sub super out fore semi anti mis non").split()
ONSETS = ("b c d f g h l m n p r s t v w br cr dr fr gr pr tr st sp sc "
          "ch sh th pl cl bl fl gl str qu").split()
VOWELS = "a e i o u a e i o ea ou io ai ie".split()
CODAS = "_ _ _ n r s t l m nd nt st rt ct ss ll rm rn".split()
SUFFIXES = ("s es ed er ers ing ings ingly ly ion ions ation ations ment "
            "ments ness able ably ible ity ities ive ively ous ously ful "
            "fully less lessly ism ist ists ize ized izes izing ization "
            "ance ence ences ant ent al ally ial ic ical ically ure ures "
            "ship hood ward wise").split()
SHORT_DECAY = 0.78  # weight ratio of successive lengths below long_len
LONG_DECAY = 0.7    # and from long_len up to LONGEST
LONGEST = 27


def _syllables(rng, k: int) -> str:
    """At least k letters of English-like syllables."""
    out = ""
    while len(out) < k:
        out += (ONSETS[rng.integers(len(ONSETS))]
                + VOWELS[rng.integers(len(VOWELS))]
                + CODAS[rng.integers(len(CODAS))]).replace("_", "")
    return out


def _prefixes(rng, k: int, plen: int) -> list:
    """k distinct plen-letter prefixes."""
    seen = set()
    out = []
    while len(out) < k:
        head = MORPH[rng.integers(len(MORPH))] if rng.random() < 1 / 3 else ""
        p = (head + _syllables(rng, plen))[:plen]
        if p not in seen:
            seen.add(p)
            out.append(p)
    return out


def _lengths(rng, count, min_len, long_len, long_count) -> np.ndarray:
    short = np.arange(min_len, long_len)
    longs = np.arange(long_len, LONGEST + 1)
    ws = SHORT_DECAY ** np.arange(len(short))
    wl = LONG_DECAY ** np.arange(len(longs))
    lens = np.concatenate([
        rng.choice(short, count - long_count, p=ws / ws.sum()),
        rng.choice(longs, long_count, p=wl / wl.sum())])
    return rng.permutation(lens)


def family_sigma(words_per_prefix: float, hit_family: float) -> float:
    """The lognormal spread of the families' extra-word rates that
    gives families of mean ``words_per_prefix`` a size-biased mean of
    ``hit_family``: E[s^2] / E[s] for s = 1 + Poisson(rate)."""
    mean, extra = words_per_prefix, words_per_prefix - 1
    var_rate = hit_family * mean - mean * mean - extra
    return float(np.sqrt(np.log1p(var_rate / (extra * extra))))


def patterns(spec):
    rng = np.random.default_rng(spec["seed"])
    count, plen = spec["count"], spec["prefix_len"]
    npre = spec["prefixes"]
    heads = _prefixes(rng, npre, plen)
    roots = [_syllables(rng, 2)[:int(rng.integers(2, 5))] for _ in heads]
    # Every prefix heads at least one word, so that exactly `prefixes`
    # distinct prefixes are used; the rest fall on prefixes by weight.
    sigma = family_sigma(count / npre, spec["hit_family"])
    weight = rng.lognormal(0.0, sigma, npre)
    group = np.concatenate([rng.permutation(npre),
                            rng.choice(npre, count - npre,
                                       p=weight / weight.sum())])
    lens = _lengths(rng, count, spec["min_len"], spec["long_len"],
                    spec["long_count"])
    words = set()
    for g, ln in zip(group.tolist(), lens.tolist()):
        # The group's root first; where that word is taken, a root of
        # fresh syllables.
        root = roots[g]
        while True:
            w = heads[g] + root
            while len(w) < ln:
                w += SUFFIXES[rng.integers(len(SUFFIXES))]
            w = w[:ln]
            if w not in words:
                break
            root = _syllables(rng, 1)
        words.add(w)
    return sorted(w.encode() for w in words)
