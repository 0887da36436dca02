"""Stream search & replace: chunked reads with carry-over.

The reference streams with a 64KB roll buffer that keeps the last
``max_pattern_len`` bytes across reads and carries the automaton state
(util/buffer.rs:107-123, automaton.rs:1036-1244). The TPU-native analog
processes large chunks through the blocked device scan and carries:

  - a tail of ``max_pattern_len - 1`` bytes (a match ending in the new
    chunk starts at most that far back), and
  - the non-overlapping selection cursor (the absolute end of the last
    reported match), exactly as the stream iterator carries its state.

Restrictions mirror the reference (automaton.rs:1071-1103): standard match
semantics only, and no empty patterns.
"""

from __future__ import annotations

from typing import Callable, Iterator, List, Sequence, Tuple

from . import semantics
from .utils.errors import MatchError
from .utils.search import Input, Match

DEFAULT_CHUNK_SIZE = 1 << 20  # 1 MiB per device scan


def _check_stream_supported(ac) -> None:
    if not ac.match_kind().is_standard():
        raise MatchError.unsupported_stream(ac.match_kind())
    if ac.patterns_len() and ac.min_pattern_len() == 0:
        raise MatchError.unsupported_empty()
    if ac.start_kind().value == "anchored":
        raise MatchError.invalid_input_unanchored()


def _read_chunks(reader, chunk_size: int):
    while True:
        data = reader.read(chunk_size)
        if not data:
            return
        yield bytes(data)


def _stream_rounds(
    ac, reader, chunk_size: int
) -> Iterator[Tuple[List[Match], bytes, int, int]]:
    """Chunked scanning rounds.

    Yields (matches, buf, abs_base, safe_point) per round, where ``buf``
    covers absolute offsets ``[abs_base, abs_base + len(buf))``, matches
    carry absolute offsets and end inside this round's new bytes, and
    ``safe_point`` is the absolute offset before which no future match can
    start (everything before it is final output for replacement).
    """
    overlap = max(ac.max_pattern_len() - 1, 0)
    tail = b""
    abs_base = 0
    cursor = 0  # absolute next-search position (last reported match end)
    first = True
    for chunk in _read_chunks(reader, chunk_size):
        buf = tail + chunk
        buf_end = abs_base + len(buf)
        ms = ac._match_set(Input(buf))
        ms.offset = abs_base
        new_bytes_from = 0 if first else abs_base + len(tail)
        matches = []
        for m in semantics.select_non_overlapping(
            ms, ac.match_kind(), max(cursor - abs_base, 0)
        ):
            # Matches ending inside the carried tail were reported by the
            # previous round.
            if m.end <= new_bytes_from:
                continue
            matches.append(m)
            cursor = m.end
        keep = min(overlap, len(buf))
        safe_point = max(buf_end - keep, cursor)
        yield matches, buf, abs_base, safe_point
        tail = buf[len(buf) - keep:] if keep else b""
        abs_base = buf_end - keep
        first = False
    # Final round: flush the carried tail.
    yield [], tail, abs_base, abs_base + len(tail)


def stream_find_iter(
    ac, reader, chunk_size: int = DEFAULT_CHUNK_SIZE
) -> Iterator[Match]:
    """Non-overlapping standard-semantics matches over a byte stream.

    Match offsets are absolute stream offsets (automaton.rs:1131-1133).
    """
    _check_stream_supported(ac)
    for matches, _buf, _base, _safe in _stream_rounds(ac, reader, chunk_size):
        yield from matches


def stream_replace_all(
    ac,
    reader,
    writer,
    replace_with: Sequence,
    chunk_size: int = DEFAULT_CHUNK_SIZE,
) -> None:
    """Stream replacement (ahocorasick.rs:1751-1828)."""
    reps = [r.encode("utf-8") if isinstance(r, str) else bytes(r)
            for r in replace_with]
    if len(reps) != ac.patterns_len():
        raise ValueError(
            f"stream_replace_all requires a replacement for every pattern"
            f" ({ac.patterns_len()}), got {len(reps)}"
        )

    def replacer(m: Match, _orig: bytes) -> bytes:
        return reps[m.pattern]

    stream_replace_all_with(ac, reader, writer, replacer, chunk_size)


def stream_replace_all_with(
    ac,
    reader,
    writer,
    replacer: Callable[[Match, bytes], bytes],
    chunk_size: int = DEFAULT_CHUNK_SIZE,
) -> None:
    """Callback stream replacement (ahocorasick.rs:1829-1865,
    automaton.rs:608-636).

    The callback receives (match, matched_bytes) and returns the
    replacement bytes (the analog of the reference closure writing to the
    writer). Exceptions propagate and abort the stream.
    """
    _check_stream_supported(ac)
    out_pos = 0  # absolute position: everything before this was written
    for matches, buf, abs_base, safe in _stream_rounds(
        ac, reader, chunk_size
    ):
        for m in matches:
            if m.start > out_pos:
                writer.write(buf[out_pos - abs_base:m.start - abs_base])
            writer.write(replacer(m, buf[m.start - abs_base:m.end - abs_base]))
            out_pos = m.end
        # Flush final non-match bytes (nothing before `safe` can be part
        # of a future match).
        if safe > out_pos:
            writer.write(buf[out_pos - abs_base:safe - abs_base])
            out_pos = safe
