"""Pattern set ``literal``: the configuration's ``literals``, as given."""


def patterns(spec):
    return [s.encode() for s in spec["literals"]]
