"""The port's public facade, ``AhoCorasick(..., device=...)``, with the
configuration's semantics, imported from the checkout that holds this
benchmark's package."""

import os

import portbench

PORT = "ahocorasick_tpu_torch"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(portbench.__file__)))


def build(cfg, patterns, device):
    import ahocorasick_tpu_torch as port
    where = os.path.realpath(os.path.dirname(port.__file__))
    if not where.startswith(os.path.realpath(ROOT) + os.sep):
        raise ImportError(f"{PORT} imported from {where}, outside the "
                          f"checkout {ROOT}")
    sem = cfg["semantics"]
    return port.AhoCorasick(
        patterns, match_kind=port.MatchKind(sem["match_kind"]),
        ascii_case_insensitive=sem["ascii_case_insensitive"], device=device)
