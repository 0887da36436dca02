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
    facade routes them by one chain of steps (`_ROUTE` below): the
    bit-parallel, staged, fingerprint and cascade engines (ops/), the
    native C++ walk (automata/native.py), the host scalar walk and the
    blocked device DFA walk (ops/block_scan.py). All match semantics are
    O(#matches) post-filters (semantics.py).
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
from typing import (Callable, Iterable, Iterator, List, NamedTuple,
                    Optional, Sequence, Tuple)

import numpy as np
import torch

from . import oracle, semantics
from .utils import log
from .automata.dfa import build_dfa
from .automata.noncontiguous import compile_nfa, patterns_to_bytes
from .ops.bitap import BitapEngine
from .ops.block_scan import DeviceWalkEngine
from .ops.cascade import CascadeEngine
from .ops.fingerprint import FingerprintEngine
from .ops import staged as _staged
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


# The engines a searcher builds on demand (`AhoCorasick._engine`).
_ENGINES = {"bitap": BitapEngine, "staged": StagedEngine,
           "fingerprint": FingerprintEngine, "cascade": CascadeEngine,
           "device_walk": DeviceWalkEngine}


def _run_engine(ac, eng, op, hs, start):
    """An engine's count or match set; None where it declines."""
    if op == "count":
        return eng.count_matches(hs)
    got = eng.match_pairs(hs)
    if got is None:
        return None
    pids, ends = got
    starts = ends - ac._dfa.pattern_lens[pids].astype(np.int64)
    return semantics.MatchSet(pids, starts, ends, start)


def _run_fused(ac, fp, op, hs, start):
    """The fingerprint engine's extract where it verifies on the device."""
    return None if fp.dv is None else _run_engine(ac, fp, op, hs, start)


def _run_native_walk(ac, eng, op, hs, start):
    """The native sequential DFA walk (automata/native.py); None where its
    library is unavailable."""
    from .automata import native as _native

    dfa = ac._dfa
    if op == "count":
        got = _native.dfa_count(dfa, hs)
        start_id = dfa.special.start_unanchored_id
        if got is not None and 2 <= start_id <= dfa.special.max_match_id:
            got += int(dfa.match_count[start_id])
        return got
    got = _native.dfa_positions(dfa, hs)
    if got is None:
        return None
    return semantics.extract_match_set_from_positions(dfa, *got, start)


def _run_host_walk(ac, eng, op, hs, start):
    """The host scalar walk over the dense table."""
    from .ops.block_scan import scan_states_host

    return semantics.extract_match_set(
        ac._dfa, scan_states_host(ac._dfa, hs), start
    )


def _run_device_walk(ac, walk, op, hs, start):
    """The blocked device DFA walk: only compacted (end, state) pairs come
    back from the device."""
    if op == "count":
        return walk.count_matches(hs)
    if len(hs) >= (1 << 16) and not getattr(ac, "_scan_warned", False):
        # One kernel (W1, a dependent table gather per byte) and a
        # compaction over the full state array: well behind the filter
        # engines, so reaching it on a large haystack means a forced
        # engine knob (or a missing native library) routed production
        # traffic here. Warn once per searcher.
        ac._scan_warned = True
        log.logger.warning(
            "blocked device DFA walk engaged for a %d-byte haystack; "
            "a gather per byte, not the production route — prefer "
            "engine='auto' (bitap/fingerprint/cascade/native "
            "selection)", len(hs),
        )
    ends, sids = walk.match_positions(hs)
    return semantics.extract_match_set_from_positions(ac._dfa, ends, sids,
                                                      start)


class _Step(NamedTuple):
    """A step of _ROUTE: the engine or walk it runs (``name``), the ops it
    serves, the ``engine=`` modes that allow it and its size rule:
    ``"device"`` (at least ``device_threshold`` bytes, unless ``engine=``
    names this step), ``"host"`` (fewer) or ``"any"``. ``when(ac, n,
    tried)`` adds a rule over the pattern set, the size and the steps the
    call has tried; ``served`` says whether the route lays
    ``served.<name>`` (the filter engines lay their own)."""

    name: str
    ops: Tuple[str, ...]
    modes: Tuple[str, ...]
    size: str = "any"
    when: Optional[Callable] = None
    served: bool = True
    run: Callable = _run_engine


_COUNT, _EXTRACT, _BOTH = ("count",), ("extract",), ("count", "extract")
_BITAP_MODES = ("auto", "oracle", "device-only", "bitap")
_FILTER_MODES = ("auto", "device-only")
_NATIVE_MODES = ("auto", "oracle", "bitap", "fingerprint", "cascade")


def _staged_size(ac, n, tried):
    return n >= _staged.STAGED_MIN


def _cascade_leads(ac, n, tried):
    return len(ac._patterns) > CASCADE_MIN_PATTERNS


def _cascade_follows(ac, n, tried):
    return not _cascade_leads(ac, n, tried) and "fingerprint" not in tried


def _filter_found_dense(ac, n, tried):
    """Whether a filter engine of this searcher found its input
    candidate-dense (its sticky ``hostile`` flag)."""
    return any(getattr(ac._engines.get(name), "hostile", False)
               for name in ("cascade", "fingerprint"))


# The route of every unanchored search, in the JAX facade's order but for
# the device walk's count of candidate-dense inputs: each call runs the
# first step that is open to it and does not decline (an engine's None).
# Over a set the bit-parallel engine accepts, extraction tries the
# fingerprint fused extract, the staged extract (from
# STAGED_MIN bytes) and the single-pass extract; counts take the staged
# and bit-parallel counts at any size, under every mode that leaves the
# engine to them, `oracle` included. Larger sets go to the filter
# engines: past CASCADE_MIN_PATTERNS patterns the cascade leads; below,
# it is offered only where the fingerprint step was closed to the call.
# Counts that a filter engine found candidate-dense take the device walk
# (W2, one pass over the bytes, cheaper than verifying the candidates); the
# native walk serves the rest of what they decline, short extractions take
# the host walk, and the device walk is the last resort and the forced
# `dfa-scan` / `device-only` route. `engine="bitap"` over a set the
# bit-parallel engine declines takes the native walk.
_ROUTE = (
    _Step("fingerprint", _EXTRACT, _FILTER_MODES, "device",
          when=lambda ac, n, tried: ac._eligible("bitap"), served=False,
          run=_run_fused),
    _Step("staged", _EXTRACT, ("auto",), "device", when=_staged_size),
    _Step("staged", _COUNT, ("auto", "bitap"), when=_staged_size),
    _Step("bitap", _EXTRACT, _BITAP_MODES, "device"),
    _Step("bitap", _COUNT, _BITAP_MODES),
    _Step("cascade", _BOTH, _FILTER_MODES + ("cascade",), "device",
          when=_cascade_leads, served=False),
    _Step("fingerprint", _BOTH, _FILTER_MODES + ("fingerprint",), "device",
          served=False),
    _Step("cascade", _BOTH, _FILTER_MODES + ("cascade",), "device",
          when=_cascade_follows, served=False),
    _Step("device_walk", _COUNT, ("auto",), "device",
          when=_filter_found_dense, run=_run_device_walk),
    _Step("native_walk", _BOTH, _NATIVE_MODES, run=_run_native_walk),
    _Step("host_walk", _EXTRACT, _NATIVE_MODES + ("dfa-scan",), "host",
          run=_run_host_walk),
    _Step("device_walk", _BOTH, ENGINE_MODES, run=_run_device_walk),
)


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
        self._engines = {}      # name -> engine, None where ineligible
        self._eligibility = {}  # name -> whether the set is in its bounds
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
    def _eligible(self, name: str) -> bool:
        """Whether the pattern set is within engine ``name``'s bounds,
        decided once per searcher."""
        if name not in self._eligibility:
            p, ci = self._patterns, self._case_insensitive
            self._eligibility[name] = bool({
                "bitap": lambda: BitapEngine.eligible(p),
                "staged": lambda: StagedEngine.set_eligible(p, ci),
                "fingerprint": lambda: FingerprintEngine.eligible(p, ci),
                "cascade": lambda: CascadeEngine.eligible(p, ci),
                "device_walk": lambda: True,
            }[name]())
        return self._eligibility[name]

    def _engine(self, name: str):
        """Engine ``name`` of ``_ENGINES``, built by the first call that
        asks for it, or None where the pattern set is out of its bounds.
        The route (``_ROUTE``) decides which calls ask."""
        if name not in self._engines:
            eng = None
            if self._eligible(name):
                if name == "device_walk":
                    eng = DeviceWalkEngine(self._dfa, self._torch_device)
                else:
                    eng = _ENGINES[name](self._patterns,
                                        self._case_insensitive,
                                        self._torch_device)
                log.debug("built the %s engine", name)
            self._engines[name] = eng
        return self._engines[name]

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

    def _route(self, op: str, hs: bytes, start: int = 0):
        """Run the first step of ``_ROUTE`` that serves ``op`` ("count" or
        "extract") over ``hs``: the count, or the match set with offsets
        from ``start``. Lays ``served.<step>`` for the steps whose engine
        does not, and ``declined.<engine>`` where an engine found hostile
        by an earlier call is passed over."""
        n, mode, tried = len(hs), self._engine_mode, set()
        below = n < self._device_threshold
        for step in _ROUTE:
            if op not in step.ops or mode not in step.modes:
                continue
            if step.size == "device" and below and mode != step.name:
                continue
            if step.size == "host" and not below:
                continue
            if step.when is not None and not step.when(self, n, tried):
                continue
            eng = None
            if step.name in _ENGINES:
                eng = self._engine(step.name)
                if eng is None:
                    continue
                if getattr(eng, "hostile", False) and mode != step.name:
                    log.count("declined." + step.name)
                    continue
            tried.add(step.name)
            got = step.run(self, eng, op, hs, start)
            if got is not None:
                if step.served:
                    log.count("served." + step.name)
                return got
        raise AssertionError("the device walk serves every call")

    def _match_set(self, input: Input) -> semantics.MatchSet:
        """Full overlapping match set of input's span (see ``_ROUTE``)."""
        return self._route("extract", input.haystack[input.start:input.end],
                           input.start)

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
        return self._route("count", input.haystack[input.start:input.end])

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
