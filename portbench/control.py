"""The control: the plain reference with one guarantee of the
configuration broken, put in the program's place.

A configuration's ``control`` names what it breaks: ``case_sensitive``
(the search ignores ASCII case folding) or ``block`` (the haystack is
searched as independent blocks of that many bytes, and matches across a
block's end are lost). A run of the harness with the control in the
program's place has to come out not correct.

``portbench/tests/test_pb_control.py`` runs it at each cell's own size
on the card, and at small sizes on the CPU.
"""

from .reference import Reference


def control_searcher(cfg, patterns, device):
    c, sem = cfg["control"], cfg["semantics"]
    return Reference(
        patterns, match_kind=sem["match_kind"],
        ascii_case_insensitive=(sem["ascii_case_insensitive"]
                                and not c.get("case_sensitive", False)),
        device=device, block=c.get("block"))
