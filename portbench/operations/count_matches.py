"""``int(searcher.count_matches(h))``: the count of overlapping matches."""


def consumer(searcher):
    fn = searcher.count_matches
    return lambda h: int(fn(h))


def keep(result):
    return result


def expected(reference, hay):
    return reference.count_matches(hay)


def gap(got, want):
    return abs(got - want)


def matches(want):
    return want
