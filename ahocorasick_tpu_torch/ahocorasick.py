"""The public facade: `AhoCorasick` + `AhoCorasickBuilder`.

API parity with the reference facade (aho-corasick/src/ahocorasick.rs):
construction with match-kind / start-kind / case-insensitivity / kind /
prefilter / dense-depth / byte-classes knobs, automatic backend selection,
search (find / find_iter / find_overlapping_iter / is_match), replacement
(replace_all family) and stream search/replace — with `try_*` fallible
variants raising `MatchError` for unsupported configurations
(ahocorasick.rs:2778-2789 enforce_anchored_consistency;
automaton.rs:404-408 overlapping requires standard semantics;
automaton.rs:1087-1103 stream requires standard semantics and no empty
patterns).

Architecture of the PyTorch port:

  - One host-side construction path (automata/noncontiguous.py) builds the
    automaton; a dense DFA table (automata/dfa.py) is compiled from it.
  - Unanchored searches run on the searcher's device, routed as the JAX
    facade routes them. Over a pattern set the exact bit-parallel engine
    accepts (`BitapEngine.eligible`), extraction tries the fingerprint
    fused extract (ops/fingerprint.py, when it verifies on the device),
    then the staged extract (ops/staged.py, n >= STAGED_MIN), then the
    single-pass bit-parallel extract (ops/bitap.py); counts try the staged
    count, then the bit-parallel count. Larger sets go to the filter
    engines: the fingerprint engine (ops/fingerprint.py), and above
    CASCADE_MIN_PATTERNS patterns (or when the fingerprint planner
    declines the set) the cascade engine (ops/cascade.py) first. The
    native C++ walk (automata/native.py) serves what they decline; short
    haystacks take the host scalar walk, and the blocked device DFA walk
    (ops/block_scan.py) is the last resort and the forced `dfa-scan` /
    `device-only` backend. All match semantics are O(#matches)
    post-filters (semantics.py).
  - Anchored searches and the leftmost+empty-pattern corner run the host
    oracle (oracle.py) — anchored walks are bounded by max_pattern_len
    transitions, so this is O(max_pattern_len) per search, not O(n).

The searcher runs on ``device`` (a builder knob, default ``"cuda"``): the
default raises when no CUDA device is present, and ``device="cpu"`` runs
the kernels' plain PyTorch versions. Every `engine=` mode of the JAX
facade runs here, routed as there.

Backend `kind` selection mirrors ahocorasick.rs:2213-2261; the kind
controls which automaton backs the *host* walk paths: CONTIGUOUS_NFA
walks the compressed single-array encoding (automata/contiguous.py), the
others the noncontiguous CSR arrays.
"""

from __future__ import annotations

import enum
from typing import Callable, Iterable, Iterator, List, Optional, Sequence

import numpy as np
import torch

from . import oracle, semantics
from .utils import log
from .automata.dfa import build_dfa
from .automata.noncontiguous import compile_nfa, patterns_to_bytes
from .ops.bitap import BitapEngine
from .ops.block_scan import DeviceAutomaton
from .ops.cascade import CascadeEngine
from .ops.fingerprint import FingerprintEngine
from .ops.staged import StagedEngine
from .utils.errors import MatchError
from .utils.search import (
    Anchored,
    BytesLike,
    Input,
    Match,
    MatchKind,
    StartKind,
    as_bytes,
    to_input,
)


class AhoCorasickKind(enum.Enum):
    """Automaton backend kinds (ahocorasick.rs:2627)."""

    NONCONTIGUOUS_NFA = "noncontiguous-nfa"
    CONTIGUOUS_NFA = "contiguous-nfa"
    DFA = "dfa"


ENGINE_MODES = ("auto", "oracle", "device-only", "bitap", "fingerprint",
                "cascade", "dfa-scan")

# Above this pattern count the cascade engine (ops/cascade.py) is offered
# before the fingerprint engine in auto mode: bucket selectivity degrades
# with set size while the cascade's exact-membership probes do not.
CASCADE_MIN_PATTERNS = 4096


def _check_engine(mode: str) -> None:
    if mode not in ENGINE_MODES:
        raise ValueError(f"unknown engine mode {mode!r}")


def _resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to search "
            "with the kernels' plain PyTorch versions on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


class AhoCorasick:
    """A multi-pattern searcher whose scans run on a torch device."""

    def __init__(self, patterns: Iterable, **builder_kwargs):
        """Build with default configuration; see `AhoCorasickBuilder`."""
        built = AhoCorasickBuilder(**builder_kwargs).build(patterns)
        self.__dict__.update(built.__dict__)

    @classmethod
    def builder(cls) -> "AhoCorasickBuilder":
        return AhoCorasickBuilder()

    @classmethod
    def _from_builder(
        cls,
        builder: "AhoCorasickBuilder",
        patterns: List[bytes],
    ) -> "AhoCorasick":
        self = object.__new__(cls)
        self._patterns = patterns
        self._match_kind = builder._match_kind
        self._start_kind = builder._start_kind
        self._case_insensitive = builder._ascii_case_insensitive
        self._prefilter_enabled = builder._prefilter
        self._byte_classes = builder._byte_classes
        _check_engine(builder._engine)
        self._engine_mode = builder._engine
        self._device_threshold = builder._device_threshold
        self._torch_device = _resolve_device(builder._device)

        # The "real" automaton with the configured match kind: drives the
        # oracle paths and introspection/memory accounting.
        self._nfa = compile_nfa(
            patterns,
            match_kind=self._match_kind,
            ascii_case_insensitive=self._case_insensitive,
        )
        # The standard-kind automaton provides the full (suffix-closed)
        # match set for the device engine; identical to _nfa when the
        # configured kind is standard.
        if self._match_kind.is_standard():
            self._match_nfa = self._nfa
        else:
            self._match_nfa = compile_nfa(
                patterns,
                match_kind=MatchKind.STANDARD,
                ascii_case_insensitive=self._case_insensitive,
            )
        if not builder._byte_classes:
            # Identity byte classes (parity knob; grows the device table).
            for nfa in {id(self._nfa): self._nfa,
                        id(self._match_nfa): self._match_nfa}.values():
                nfa.classes = np.arange(256, dtype=np.uint8)
                nfa.alphabet_len = 256

        self._dfa = build_dfa(self._match_nfa)
        self._dev_automaton: Optional[DeviceAutomaton] = None
        self._bitap: Optional[BitapEngine] = None
        self._bitap_checked = False
        self._staged: Optional[StagedEngine] = None
        self._fp: Optional[FingerprintEngine] = None
        self._fp_checked = False
        self._cascade: Optional[CascadeEngine] = None
        self._cascade_checked = False
        self._pre = None
        self._pre_checked = False
        self._dense_depth = builder._dense_depth
        self._contig = None

        self._has_empty = bool(
            len(self._nfa.pattern_lens)
            and int(self._nfa.pattern_lens.min()) == 0
        )

        # Backend kind reporting (ahocorasick.rs:2213-2261).
        if builder._kind is not None:
            self._kind = builder._kind
        elif (
            len(patterns) <= 100
            and self._start_kind is not StartKind.BOTH
        ):
            self._kind = AhoCorasickKind.DFA
        else:
            self._kind = AhoCorasickKind.CONTIGUOUS_NFA
        log.debug(
            "built searcher: %d patterns, kind=%s, match_kind=%s, "
            "nfa states=%d, dfa %d x %d (%d bytes)",
            len(patterns), self._kind.value, self._match_kind.value,
            self._nfa.num_states, self._dfa.num_states,
            self._dfa.alphabet_len, self._dfa.memory_usage(),
        )
        return self

    # ------------------------------------------------------------------
    # Introspection (ahocorasick.rs:1846-2024)
    # ------------------------------------------------------------------
    def kind(self) -> AhoCorasickKind:
        return self._kind

    def start_kind(self) -> StartKind:
        return self._start_kind

    def match_kind(self) -> MatchKind:
        return self._match_kind

    def min_pattern_len(self) -> int:
        return self._nfa.min_pattern_len

    def max_pattern_len(self) -> int:
        return self._nfa.max_pattern_len

    def patterns_len(self) -> int:
        return len(self._patterns)

    def device(self) -> torch.device:
        """The torch device the searcher's scans run on."""
        return self._torch_device

    def memory_usage(self) -> int:
        total = self._nfa.memory_usage()
        if self._match_nfa is not self._nfa:
            total += self._match_nfa.memory_usage()
        total += self._dfa.memory_usage()
        return total

    def debug_str(self, max_states: Optional[int] = None) -> str:
        """Full-automaton pretty dump — the analog of the reference's
        rich Debug impls (nfa/noncontiguous.rs:1691-1762,
        dfa.rs:305-381), its primary debugging affordance. Dumps the
        configured NFA and the compiled dense DFA."""
        from .utils import debug as _dbg

        return (
            _dbg.format_nfa(self._nfa, max_states)
            + "\n"
            + _dbg.format_dfa(self._dfa, max_states)
        )

    # ------------------------------------------------------------------
    # Checkpoint/restore (extension; see serialize.py)
    # ------------------------------------------------------------------
    def save(self, path: str) -> None:
        """Serialize the compiled searcher (tables included) to .npz."""
        from . import serialize

        serialize.save(self, path)

    @classmethod
    def load(cls, path: str, device="cuda") -> "AhoCorasick":
        """Restore a searcher saved with `save` (by this package or the
        JAX package) without recompiling; it searches on ``device``."""
        from . import serialize

        return serialize.load(path, device=device)

    # ------------------------------------------------------------------
    # Internals
    # ------------------------------------------------------------------
    def _device_automaton(self) -> DeviceAutomaton:
        """The blocked device DFA walk (ops/block_scan.py)."""
        if self._dev_automaton is None:
            self._dev_automaton = DeviceAutomaton(self._dfa,
                                                  self._torch_device)
        return self._dev_automaton

    def _bitap_engine(self) -> Optional[BitapEngine]:
        """The bit-parallel device engine (ops/bitap.py), or None when the
        pattern set is out of its bounds (empty patterns, > 2048 total
        pattern bytes, a pattern longer than 2048 bytes) or the mode
        forces the DFA walk or a filter engine."""
        if self._engine_mode in ("dfa-scan", "fingerprint", "cascade"):
            return None
        if not self._bitap_checked:
            self._bitap_checked = True
            if BitapEngine.eligible(self._patterns):
                self._bitap = BitapEngine(
                    self._patterns, self._case_insensitive,
                    self._torch_device,
                )
                log.debug(
                    "bitap engine: K=%d limbs, halo=%d, pad_byte=%r",
                    self._bitap.tables.k, self._bitap.halo,
                    self._bitap.tables.pad_byte,
                )
            else:
                log.debug("bitap ineligible; filter engines or native walk")
        return self._bitap

    def _staged_engine(self, n: int) -> Optional[StagedEngine]:
        """Two-stage fingerprint-prefilter engine (ops/staged.py) for
        haystacks of at least STAGED_MIN bytes, or None when ineligible."""
        if self._engine_mode not in ("auto", "bitap"):
            return None
        if not StagedEngine.eligible(
            self._patterns, n, self._case_insensitive
        ):
            return None
        if self._staged is None:
            self._staged = StagedEngine(
                self._patterns, self._case_insensitive, self._torch_device
            )
            log.debug(
                "staged engine: Kf=%d fingerprint limbs vs K=%d full",
                self._staged.fp.k, self._staged.full.k,
            )
        return self._staged

    def _fingerprint_engine(self, n: int) -> Optional[FingerprintEngine]:
        """Bucketed fingerprint filter + exact verification
        (ops/fingerprint.py). None when ineligible, below the device
        threshold, or previously found filter-hostile (candidate-dense
        input; the native walk is then faster). Its calls return None on
        filter-hostile input."""
        forced = self._engine_mode == "fingerprint"
        if self._engine_mode not in ("auto", "device-only", "fingerprint"):
            return None
        if not forced and n < self._device_threshold:
            return None
        if not self._fp_checked:
            self._fp_checked = True
            if FingerprintEngine.eligible(
                self._patterns, self._case_insensitive
            ):
                self._fp = FingerprintEngine(
                    self._patterns, self._case_insensitive,
                    self._torch_device,
                )
                log.debug(
                    "fingerprint engine: %d buckets, K=%d limbs, pad=%r",
                    self._fp.tables.num_buckets, self._fp.tables.k,
                    self._fp.tables.pad_byte,
                )
        if self._fp is not None and self._fp.hostile and not forced:
            log.count("declined.fingerprint")
            return None
        return self._fp

    def _cascade_engine(self, n: int) -> Optional[CascadeEngine]:
        """Cascade engine (ops/cascade.py): the device path for pattern
        sets beyond the fingerprint planner's bucket budget (10k-100k+
        patterns). None when ineligible, below the device threshold, or
        previously found hostile."""
        forced = self._engine_mode == "cascade"
        if self._engine_mode not in ("auto", "device-only", "cascade"):
            return None
        if not forced and n < self._device_threshold:
            return None
        if not self._cascade_checked:
            self._cascade_checked = True
            if CascadeEngine.eligible(
                self._patterns, self._case_insensitive
            ):
                self._cascade = CascadeEngine(
                    self._patterns, self._case_insensitive,
                    self._torch_device,
                )
        if (self._cascade is not None and self._cascade.hostile
                and not forced):
            log.count("declined.cascade")
            return None
        return self._cascade

    def _filter_engines(self, n: int) -> list:
        """Filter engines (fingerprint / cascade) in preference order.

        Both share the match_pairs/count_matches -> Optional protocol
        (None = hostile input, try the next engine / native walk). Past
        CASCADE_MIN_PATTERNS the cascade's deduped-prefix coarse filter
        plus exact-membership probes scales better than per-bucket
        fingerprint chains, so it leads; below, the fingerprint engine
        serves and the cascade is built only when the fingerprint engine
        is unavailable."""
        fp = self._fingerprint_engine(n)
        prefer_cascade = (
            len(self._patterns) > CASCADE_MIN_PATTERNS
            or self._engine_mode == "cascade"
        )
        if fp is not None and not prefer_cascade:
            return [fp]
        cas = self._cascade_engine(n)
        pair = (cas, fp) if prefer_cascade else (fp, cas)
        return [e for e in pair if e is not None]

    def _oracle_automaton(self):
        """The automaton backing host walk paths, per the reported kind:
        CONTIGUOUS_NFA walks the compressed single-array encoding
        (automata/contiguous.py), other kinds the noncontiguous arrays.
        Both implement the same host Automaton protocol and produce
        identical results (contiguous is a re-encoding)."""
        if self._kind is AhoCorasickKind.CONTIGUOUS_NFA:
            if self._contig is None:
                from .automata.contiguous import build_contiguous

                self._contig = build_contiguous(
                    self._nfa, self._dense_depth
                )
                log.debug(
                    "contiguous NFA: %d words (%d bytes vs %d "
                    "noncontiguous)",
                    len(self._contig.repr),
                    self._contig.memory_usage(),
                    self._nfa.memory_usage(),
                )
            return self._contig
        return self._nfa

    def _prefilter(self):
        """Host-path skip-ahead prefilter (utils/prefilter.py), or None."""
        if not self._pre_checked:
            self._pre_checked = True
            if self._prefilter_enabled:
                from .utils import prefilter as _pf

                self._pre = _pf.build(
                    self._patterns, self._case_insensitive
                )
                if self._pre is not None:
                    log.debug(
                        "prefilter: %s", type(self._pre).__name__
                    )
        return self._pre

    def _check_anchored(self, input: Input) -> None:
        """enforce_anchored_consistency (ahocorasick.rs:2778-2789)."""
        if input.anchored.is_anchored():
            if self._start_kind is StartKind.UNANCHORED:
                raise MatchError.invalid_input_anchored()
        else:
            if self._start_kind is StartKind.ANCHORED:
                raise MatchError.invalid_input_unanchored()

    def _use_oracle(self, input: Input) -> bool:
        # Anchored walks are bounded by max_pattern_len transitions and are
        # architecturally host-side (the filter engine is unanchored-only),
        # regardless of the engine-forcing mode.
        if input.anchored.is_anchored():
            return True
        # Leftmost + empty patterns is automaton-defined (see semantics.py).
        if self._match_kind.is_leftmost() and self._has_empty:
            return True
        if self._engine_mode == "oracle":
            return True
        return False

    def _match_set(self, input: Input) -> semantics.MatchSet:
        """Full overlapping match set of input's span.

        Device engines serve spans of at least `device_threshold` bytes, in
        the JAX facade's order; below it a host walk over the dense table
        is faster than a device dispatch.
        """
        hs = input.haystack[input.start:input.end]

        def match_set(pids, ends):
            starts = ends - self._dfa.pattern_lens[pids].astype(np.int64)
            return semantics.MatchSet(pids, starts, ends, input.start)

        bitap = self._bitap_engine()
        if bitap is not None and (
            len(hs) >= self._device_threshold
            or self._engine_mode == "bitap"
        ):
            # Extraction routing, as in the JAX facade: the fingerprint
            # fused extract (a 1-bit candidate bitmap + device verify),
            # then the staged extract (end words for flagged streams
            # only), then the single-pass bit-parallel extract, the
            # always-eligible floor. Every engine is exact; earlier ones
            # decline (None) on hostile inputs or ineligible sets.
            if self._engine_mode != "bitap":
                fp = self._fingerprint_engine(len(hs))
                if fp is not None and fp.dv is not None:
                    got = fp.match_pairs(hs)
                    if got is not None:
                        return match_set(*got)
                staged = self._staged_engine(len(hs))
                if staged is not None:
                    got = staged.match_pairs(hs)
                    if got is not None:
                        log.count("served.staged")
                        return match_set(*got)
            log.count("served.bitap")
            return match_set(*bitap.match_pairs(hs))
        for eng in self._filter_engines(len(hs)):
            got = eng.match_pairs(hs)
            if got is not None:  # None: filter-hostile input, fall back
                return match_set(*got)
        if self._engine_mode not in ("dfa-scan", "device-only"):
            # Pattern set beyond the device engines' bounds, a
            # filter-hostile input or a short haystack: the native
            # sequential DFA walk.
            from .automata import native as _native

            got = _native.dfa_positions(self._dfa, hs)
            if got is not None:
                log.count("served.native_walk")
                ends, sids = got
                return semantics.extract_match_set_from_positions(
                    self._dfa, ends, sids, input.start
                )
        if (
            len(hs) < self._device_threshold
            and self._engine_mode != "device-only"
        ):
            from .ops.block_scan import scan_states_host

            log.count("served.host_walk")
            states = scan_states_host(self._dfa, hs)
            return semantics.extract_match_set(
                self._dfa, states, input.start
            )
        # The blocked device DFA walk: only compacted (end, state) pairs
        # come back from the device.
        if len(hs) >= (1 << 16) and not getattr(self, "_scan_warned", False):
            # One kernel (W1, a dependent table gather per byte) and a
            # compaction over the full state array: well behind the
            # filter engines, so reaching it on a large haystack means a
            # forced engine knob (or a missing native library) routed
            # production traffic here. Warn once per searcher.
            self._scan_warned = True
            log.logger.warning(
                "blocked device DFA walk engaged for a %d-byte haystack; "
                "a gather per byte, not the production route — prefer "
                "engine='auto' (bitap/fingerprint/cascade/native "
                "selection)", len(hs),
            )
        log.count("served.device_walk")
        ends, sids = self._device_automaton().match_positions(hs)
        return semantics.extract_match_set_from_positions(
            self._dfa, ends, sids, input.start
        )

    def _match_set_oracle(self, input: Input) -> semantics.MatchSet:
        """Oracle-computed match set (tests / debugging)."""
        hs = input.haystack[input.start:input.end]
        triples = oracle.find_all_overlapping(self._match_nfa, hs)
        if triples:
            arr = np.asarray(triples, dtype=np.int64)
            return semantics.MatchSet(
                arr[:, 0], arr[:, 1], arr[:, 2], input.start
            )
        z = np.zeros(0, dtype=np.int64)
        return semantics.MatchSet(z, z, z, input.start)

    # ------------------------------------------------------------------
    # Searching
    # ------------------------------------------------------------------
    @log.spanned("call")
    def try_find(self, input) -> Optional[Match]:
        input = to_input(input)
        self._check_anchored(input)
        if self._use_oracle(input):
            return oracle.try_find_fwd(
                self._oracle_automaton(), input, self._prefilter()
            )
        ms = self._match_set(input)
        earliest = self._match_kind.is_standard() or input.earliest
        with log.span("select"):
            # The match set's starts are relative to the span: the span's
            # first byte is 0 (the JAX package passes input.start here and
            # skips the span's first input.start bytes).
            if earliest:
                return semantics.earliest_match(ms, 0)
            return semantics.first_non_overlapping(ms, self._match_kind, 0)

    def find(self, input) -> Optional[Match]:
        return self.try_find(input)

    def is_match(self, input) -> bool:
        input = to_input(input).set_earliest(True)
        return self.try_find(input) is not None

    @log.call_iter
    def try_find_iter(self, input) -> Iterator[Match]:
        input = to_input(input)
        self._check_anchored(input)
        if self._use_oracle(input):
            yield from oracle.find_iter(
                self._oracle_automaton(), input, self._prefilter()
            )
            return
        ms = self._match_set(input)
        with log.span("select"):
            yield from semantics.select_non_overlapping(
                ms, self._match_kind, 0
            )

    def find_iter(self, input) -> Iterator[Match]:
        return self.try_find_iter(input)

    def _overlap_devolve(self, state: oracle.OverlappingState) -> None:
        """Convert a device-backed overlapping state into the exact
        oracle-walk state by replaying the drained matches on the
        original input — resuming on a *different* input then behaves
        exactly like the reference's carried automaton state
        (automaton.rs:781-827)."""
        matches, idx, old_input, drained = state._dev
        state._dev = None
        replay = oracle.OverlappingState()
        for _ in range(idx):
            oracle.try_find_overlapping_fwd(
                self._match_nfa, old_input, replay
            )
        if drained:
            # The device path already served a None: the devolved state
            # must reflect the *exhausted* scan of old_input (at = end),
            # not the position of the last match — one extra oracle call
            # walks the remaining tail exactly as the reference's carried
            # state would (automaton.rs:1442-1537).
            oracle.try_find_overlapping_fwd(
                self._match_nfa, old_input, replay
            )
        state.mat = replay.mat
        state.id = replay.id
        state.at = replay.at
        state.next_match_index = replay.next_match_index

    @log.spanned("call")
    def try_find_overlapping(
        self, input, state: oracle.OverlappingState
    ) -> None:
        input = to_input(input)
        self._check_anchored(input)
        if not self._match_kind.is_standard():
            raise MatchError.unsupported_overlapping(self._match_kind)
        same_input = state._dev is not None and (
            state._dev[2].haystack is input.haystack
            and state._dev[2].start == input.start
            and state._dev[2].end == input.end
        )
        if state._dev is not None and not same_input:
            self._overlap_devolve(state)
        use_device = (
            state.id is None
            and not input.anchored.is_anchored()
            and not self._has_empty
            and self._engine_mode != "oracle"
            and (
                same_input
                or input.end - input.start >= self._device_threshold
            )
        )
        if not use_device:
            oracle.try_find_overlapping_fwd(self._match_nfa, input, state)
            return
        if state._dev is None:
            ms = self._match_set(input)
            with log.span("select"):
                state._dev = [
                    list(semantics.overlapping_iter(ms)), 0, input, False,
                ]
        matches, idx, _, _ = state._dev
        if idx < len(matches):
            state.mat = matches[idx]
            state._dev[1] = idx + 1
        else:
            state.mat = None
            state._dev[3] = True  # drained: a None was served

    def find_overlapping(
        self, input, state: oracle.OverlappingState
    ) -> None:
        self.try_find_overlapping(input, state)

    @log.call_iter
    def try_find_overlapping_iter(self, input) -> Iterator[Match]:
        input = to_input(input)
        self._check_anchored(input)
        if not self._match_kind.is_standard():
            raise MatchError.unsupported_overlapping(self._match_kind)
        if self._use_oracle(input):
            yield from oracle.find_overlapping_iter(self._match_nfa, input)
            return
        ms = self._match_set(input)
        with log.span("select"):
            yield from semantics.overlapping_iter(ms)

    def find_overlapping_iter(self, input) -> Iterator[Match]:
        return self.try_find_overlapping_iter(input)

    @log.spanned("call")
    def count_matches(self, input) -> int:
        """Total number of overlapping matches, reduced on device.

        (Extension: the common "how many hits" query without
        materializing triples on the host.)
        """
        input = to_input(input)
        self._check_anchored(input)
        if not self._match_kind.is_standard():
            raise MatchError.unsupported_overlapping(self._match_kind)
        hs = input.haystack[input.start:input.end]
        bitap = self._bitap_engine()
        if bitap is not None:
            staged = self._staged_engine(len(hs))
            if staged is not None:
                got = staged.count_matches(hs)
                if got is not None:  # None: candidate overflow, rescan
                    log.count("served.staged")
                    return got
            log.count("served.bitap")
            return bitap.count_matches(hs)
        for eng in self._filter_engines(len(hs)):
            got = eng.count_matches(hs)
            if got is not None:  # None: filter-hostile input, fall back
                return got
        if self._engine_mode not in ("dfa-scan", "device-only"):
            from .automata import native as _native

            got = _native.dfa_count(self._dfa, hs)
            if got is not None:
                log.count("served.native_walk")
                extra = 0
                start_id = self._dfa.special.start_unanchored_id
                if 2 <= start_id <= self._dfa.special.max_match_id:
                    extra = int(self._dfa.match_count[start_id])
                return got + extra
        log.count("served.device_walk")
        return self._device_automaton().count_matches(hs)

    # ------------------------------------------------------------------
    # Replacing (ahocorasick.rs:651-906)
    # ------------------------------------------------------------------
    @log.spanned("call")
    def try_replace_all(self, haystack: str, replace_with: Sequence[str]) -> str:
        if len(replace_with) != self.patterns_len():
            raise ValueError(
                f"replace_all requires a replacement for every pattern"
                f" ({self.patterns_len()}), got {len(replace_with)}"
            )
        out = self.try_replace_all_bytes(
            haystack.encode("utf-8"),
            [r.encode("utf-8") for r in replace_with],
        )
        return out.decode("utf-8")

    def replace_all(self, haystack: str, replace_with: Sequence[str]) -> str:
        return self.try_replace_all(haystack, replace_with)

    @log.spanned("call")
    def try_replace_all_bytes(
        self, haystack: bytes, replace_with: Sequence[bytes]
    ) -> bytes:
        if len(replace_with) != self.patterns_len():
            raise ValueError(
                f"replace_all requires a replacement for every pattern"
                f" ({self.patterns_len()}), got {len(replace_with)}"
            )
        pieces = []
        last = 0
        for m in self.try_find_iter(Input(haystack)):
            pieces.append(haystack[last:m.start])
            pieces.append(replace_with[m.pattern])
            last = m.end
        pieces.append(haystack[last:])
        return b"".join(pieces)

    def replace_all_bytes(
        self, haystack: bytes, replace_with: Sequence[bytes]
    ) -> bytes:
        return self.try_replace_all_bytes(haystack, replace_with)

    @log.spanned("call")
    def try_replace_all_with(
        self,
        haystack: str,
        replacer: Callable[[Match, str], Optional[str]],
    ) -> str:
        """Callback-based replacement (ahocorasick.rs:765-834).

        The callback receives (match, matched_text) and returns the
        replacement text, or None to stop replacing (the remainder is
        copied verbatim — the analog of the reference callback returning
        false).
        """
        data = haystack.encode("utf-8")

        def rb(m: Match, s: bytes) -> Optional[bytes]:
            r = replacer(m, s.decode("utf-8"))
            return None if r is None else r.encode("utf-8")

        return self.try_replace_all_with_bytes(data, rb).decode("utf-8")

    def replace_all_with(self, haystack, replacer):
        return self.try_replace_all_with(haystack, replacer)

    @log.spanned("call")
    def try_replace_all_with_bytes(
        self,
        haystack: bytes,
        replacer: Callable[[Match, bytes], Optional[bytes]],
    ) -> bytes:
        pieces = []
        last = 0
        for m in self.try_find_iter(Input(haystack)):
            rep = replacer(m, haystack[m.start:m.end])
            if rep is None:
                break
            pieces.append(haystack[last:m.start])
            pieces.append(rep)
            last = m.end
        pieces.append(haystack[last:])
        return b"".join(pieces)

    def replace_all_with_bytes(self, haystack, replacer):
        return self.try_replace_all_with_bytes(haystack, replacer)

    # ------------------------------------------------------------------
    # Streaming (ahocorasick.rs:906-1865); implemented in stream.py
    # ------------------------------------------------------------------
    def try_stream_find_iter(self, reader) -> Iterator[Match]:
        from .stream import stream_find_iter

        return stream_find_iter(self, reader)

    def stream_find_iter(self, reader) -> Iterator[Match]:
        return self.try_stream_find_iter(reader)

    def try_stream_replace_all(
        self, reader, writer, replace_with: Sequence[bytes]
    ) -> None:
        from .stream import stream_replace_all

        stream_replace_all(self, reader, writer, replace_with)

    def try_stream_replace_all_with(
        self,
        reader,
        writer,
        replacer: Callable[[Match, bytes], Optional[bytes]],
    ) -> None:
        from .stream import stream_replace_all_with

        stream_replace_all_with(self, reader, writer, replacer)

    def __repr__(self) -> str:
        return (
            f"AhoCorasick(patterns={self.patterns_len()},"
            f" kind={self._kind.value}, match_kind={self._match_kind.value},"
            f" start_kind={self._start_kind.value},"
            f" states={self._nfa.num_states})"
        )


class AhoCorasickBuilder:
    """Builder mirroring ahocorasick.rs:2134-2617."""

    def __init__(
        self,
        *,
        match_kind: MatchKind = MatchKind.STANDARD,
        start_kind: StartKind = StartKind.UNANCHORED,
        ascii_case_insensitive: bool = False,
        kind: Optional[AhoCorasickKind] = None,
        prefilter: bool = True,
        dense_depth: int = 3,
        byte_classes: bool = True,
        engine: str = "auto",
        device_threshold: int = 2048,
        device="cuda",
    ):
        self._match_kind = match_kind
        self._start_kind = start_kind
        self._ascii_case_insensitive = ascii_case_insensitive
        self._kind = kind
        self._prefilter = prefilter
        self._dense_depth = dense_depth
        self._byte_classes = byte_classes
        self._engine = engine
        self._device_threshold = device_threshold
        self._device = device

    # Fluent setters (reference-style names).
    def match_kind(self, kind: MatchKind) -> "AhoCorasickBuilder":
        self._match_kind = kind
        return self

    def start_kind(self, kind: StartKind) -> "AhoCorasickBuilder":
        self._start_kind = kind
        return self

    def ascii_case_insensitive(self, yes: bool) -> "AhoCorasickBuilder":
        self._ascii_case_insensitive = yes
        return self

    def kind(self, kind: Optional[AhoCorasickKind]) -> "AhoCorasickBuilder":
        self._kind = kind
        return self

    def prefilter(self, yes: bool) -> "AhoCorasickBuilder":
        self._prefilter = yes
        return self

    def dense_depth(self, depth: int) -> "AhoCorasickBuilder":
        self._dense_depth = depth
        return self

    def byte_classes(self, yes: bool) -> "AhoCorasickBuilder":
        self._byte_classes = yes
        return self

    def device_threshold(self, n: int) -> "AhoCorasickBuilder":
        """Extension: haystacks shorter than this scan on the host."""
        self._device_threshold = n
        return self

    def device(self, device) -> "AhoCorasickBuilder":
        """Extension: the torch device scans run on ("cuda", "cuda:1",
        "cpu"). The default "cuda" raises at build time when no CUDA
        device is present."""
        self._device = device
        return self

    def engine(self, mode: str) -> "AhoCorasickBuilder":
        """Extension: engine preference.

        'auto' (the device engines in the JAX facade's order, else the
        native walk; host walk for tiny haystacks), 'bitap' (force the
        bit-parallel kernels even for tiny haystacks), 'fingerprint' /
        'cascade' (force that filter engine), 'device-only' (device
        engines only: no native walk, and the blocked device DFA walk
        where the others decline, even for tiny haystacks), 'dfa-scan'
        (the blocked device DFA walk; extractions shorter than
        `device_threshold` take the host walk), 'oracle' (host reference
        walk) — the
        analog of the reference's test-only backend forcing knobs
        (packed/api.rs:137-188)."""
        _check_engine(mode)
        self._engine = mode
        return self

    def build(self, patterns: Iterable) -> AhoCorasick:
        pats = patterns_to_bytes(patterns)
        return AhoCorasick._from_builder(self, pats)
