"""Haystacks ``dict_text``: prose of ``filler_words`` filler words (from
``filler_seed``) with dictionary entries at ``density`` per word, one
stream from the run's seed cut into the pool."""

from portbench import gen


def pool(spec, patterns, size, count, seed):
    filler = gen.build_words(spec["filler_words"], spec["filler_seed"],
                             gen.PROSE_SYLLABLES)
    stream = gen.dict_text(size * count, gen.rng_of(seed), patterns,
                           spec["density"], filler)
    return gen.cut(stream, size, count)
