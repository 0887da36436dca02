"""Packed multi-substring search (the reference's src/packed analog)."""

from .api import Builder, Config, MatchKind, Searcher, PATTERN_LIMIT  # noqa: F401
