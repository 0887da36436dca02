"""Error types mirroring the reference's error contracts.

See aho-corasick/src/util/error.rs:23-49 (BuildError) and :200-222
(MatchError). These are exceptions in Python, but the `kind` attribute
preserves the machine-readable contract.
"""

from __future__ import annotations


class BuildError(ValueError):
    """Raised when constructing an automaton fails.

    Kinds (mirroring util/error.rs:23-49):
      - "state-id-overflow"
      - "pattern-id-overflow"
      - "pattern-too-long"
    """

    def __init__(self, kind: str, message: str):
        super().__init__(message)
        self.kind = kind

    @classmethod
    def state_id_overflow(cls, max_id: int, attempted: int) -> "BuildError":
        return cls(
            "state-id-overflow",
            f"building the automaton failed because it required building more"
            f" states than can be identified, where the maximum ID for a state"
            f" is {max_id} but attempted to create {attempted}",
        )

    @classmethod
    def pattern_id_overflow(cls, max_id: int, attempted: int) -> "BuildError":
        return cls(
            "pattern-id-overflow",
            f"building the automaton failed because it required more patterns"
            f" than can be identified, where the maximum ID is {max_id} but"
            f" attempted to create {attempted}",
        )

    @classmethod
    def pattern_too_long(cls, pattern: int, length: int) -> "BuildError":
        return cls(
            "pattern-too-long",
            f"building the automaton failed because pattern {pattern} has"
            f" length {length}, which exceeds the maximum supported length",
        )


class MatchError(ValueError):
    """Raised when a search cannot be executed with the given configuration.

    Kinds (mirroring util/error.rs:200-222):
      - "invalid-input-anchored": anchored search requested but unsupported
      - "invalid-input-unanchored": unanchored search requested but unsupported
      - "unsupported-stream": stream search with non-standard match kind
      - "unsupported-overlapping": overlapping search with non-standard kind
      - "unsupported-empty": stream search with an empty pattern
    """

    def __init__(self, kind: str, message: str):
        super().__init__(message)
        self.kind = kind

    @classmethod
    def invalid_input_anchored(cls) -> "MatchError":
        return cls(
            "invalid-input-anchored",
            "anchored searches are not supported or enabled",
        )

    @classmethod
    def invalid_input_unanchored(cls) -> "MatchError":
        return cls(
            "invalid-input-unanchored",
            "unanchored searches are not supported or enabled",
        )

    @classmethod
    def unsupported_stream(cls, got) -> "MatchError":
        return cls(
            "unsupported-stream",
            f"match kind {got} is not supported for stream searches; only"
            f" standard semantics are supported",
        )

    @classmethod
    def unsupported_overlapping(cls, got) -> "MatchError":
        return cls(
            "unsupported-overlapping",
            f"match kind {got} is not supported for overlapping searches; only"
            f" standard semantics are supported",
        )

    @classmethod
    def unsupported_empty(cls) -> "MatchError":
        return cls(
            "unsupported-empty",
            "matching empty patterns is not supported for this search"
            " (stream searching does not support empty patterns)",
        )
