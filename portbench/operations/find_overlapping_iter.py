"""``list(searcher.find_overlapping_iter(h))``: every match as (pattern, start, end), in
the order the crate reports them."""

from portbench.answers import as_array as keep, list_gap as gap  # noqa: F401


def consumer(searcher):
    fn = searcher.find_overlapping_iter
    return lambda h: list(fn(h))


def expected(reference, hay):
    return reference.find_overlapping_iter(hay)


def matches(want):
    return len(want)
