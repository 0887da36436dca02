"""Pattern set ``syllable_names``: ``count`` distinct words of 2-4
syllables of the ``syllables`` list (``name`` or ``prose``), a share
``capitalize`` capitalised, from the configuration's fixed ``seed``."""

from portbench import gen


def patterns(spec):
    return gen.build_words(spec["count"], spec["seed"],
                           gen.SYLLABLES[spec["syllables"]],
                           spec.get("capitalize", 0.0))
