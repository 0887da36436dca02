"""Haystacks ``english``: English-like words with the patterns planted at
``name_rate`` per word, one stream from the run's seed cut into the
pool."""

from portbench import gen


def pool(spec, patterns, size, count, seed):
    stream = gen.english(size * count, gen.rng_of(seed), patterns,
                         spec["name_rate"])
    return gen.cut(stream, size, count)
