"""Diagnostics: the port's logger, and spans and counters per call.

Logging is the analog of the reference's `logging` feature, which gates
`debug!` macros behind a cargo feature (src/macros.rs:1-18,
Cargo.toml:27-30) to trace backend selection, build sizes and prefilter
choice. Here the standard library logger ``ahocorasick_tpu_torch`` plays
that role: silent unless the embedding application configures logging.

    import logging
    logging.getLogger("ahocorasick_tpu_torch").setLevel(logging.DEBUG)

Spans and counters measure where a search call's time goes. Each facade
entry point runs as one call (the root span ``call``); inside it the
engines open named spans (``prepare``, ``prepare.pack``, ``pass``,
``pass.read``, ...) and add counts in bulk (``h2d_bytes``, ``d2h_reads``,
``passes``). A call's record holds, per span name, its self time in
``time.perf_counter_ns`` nanoseconds (its time less its child spans') and
under ``"#" + name`` how often it was entered; per counter its sum. While
tracing is on, every garbage collection is a child span ``gc`` of the span
open at the time, and full (generation 2) collections count as
``gc_full``. Tracing is off by default: `span` then returns one shared
no-op object after one flag test, and `count` returns.

    from ahocorasick_tpu_torch.utils import log
    log.enable(ranges=True)     # inside one's own torch.profiler session
    hits = list(searcher.find_iter(haystack))
    log.disable()
    records = log.take()        # [{"call": ns, "#call": 1, ...}, ...]

With ``ranges`` each span also opens a profiler range ``"ac." + name``
(as ``torch.profiler.record_function`` does), which lays the program's
steps on the profiler's timeline beside the kernels and copies they
issue. The profiler lays each range on the device's timeline too, so a
reader of device activity leaves ``ac.`` ranges out.
"""

import collections
import functools
import gc
import itertools
import logging
import threading
import time

logger = logging.getLogger("ahocorasick_tpu_torch")

KEEP = 1 << 16  # records `take` holds: the last KEEP calls
STEP = 256      # items a traced entry point's iterator computes a step


def debug(msg: str, *args) -> None:
    if logger.isEnabledFor(logging.DEBUG):
        logger.debug(msg, *args)


# ---------------------------------------------------------------------------
# Spans and counters
# ---------------------------------------------------------------------------
_on = False
_range = None  # the profiler range type while ranges are on
_done = collections.deque(maxlen=KEEP)


class _State(threading.local):
    active = None  # the _Call running in this thread
    gc = None      # the span of the collection in progress


_tls = _State()


class _Off:
    """The span handed out while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, typ, val, tb):
        return None


_OFF = _Off()


class _Call:
    """One call's record and its innermost open span."""

    __slots__ = ("rec", "top")

    def __init__(self):
        self.rec = {}
        self.top = None


def _active():
    call = _tls.active
    return call if call is not None and call.top is not None else None


class _Span:
    __slots__ = ("name", "call", "parent", "t0", "child", "rf", "open")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        call = _active()
        if call is None:  # a span outside any call is its call's root
            call = _tls.active = _Call()
        self.call, self.parent = call, call.top
        self.child, self.open, self.rf = 0, True, None
        call.top = self
        self.t0 = time.perf_counter_ns()
        if _range is not None:
            self.rf = _range("ac." + self.name)
            self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self.open:
            now = time.perf_counter_ns()
            # Spans left open above this one (an iterator dropped without
            # being closed) end here.
            while self.call.top is not self:
                self.call.top._close(now)
            self._close(now)
        return False

    def _close(self, now: int):
        total = now - self.t0
        call, name, rec = self.call, self.name, self.call.rec
        rec[name] = rec.get(name, 0) + total - self.child
        rec["#" + name] = rec.get("#" + name, 0) + 1
        self.open = False
        call.top = self.parent
        if self.parent is not None:
            self.parent.child += total
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        if self.parent is None:
            _done.append(rec)
            if _tls.active is call:
                _tls.active = None


def span(name: str):
    """Context manager that adds its self time to the current call's
    record under ``name`` (a no-op while tracing is off)."""
    if not _on:
        return _OFF
    return _Span(name)


def spanned(name: str):
    """Decorator: each call of the function runs in `span(name)`."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            if not _on:
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)
        return run
    return wrap


def call_iter(fn):
    """Decorator for a generator function that is an entry point: while
    tracing is on, the iterator it returns runs in the span ``call`` from
    its first ``next()`` to its exhaustion or close, whatever runs between
    its steps, as a call of its own (or in the call running at that first
    ``next()``). It then computes STEP items at a time, so that keeping
    the calls of interleaved iterators apart costs little per item."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        it = fn(*args, **kwargs)
        return _as_call(it) if _on else it
    return run


def _as_call(it):
    prev = _active()
    root = _Span("call").__enter__()
    call = root.call
    try:
        while True:
            _tls.active = call
            try:
                items = list(itertools.islice(it, STEP))
            finally:
                _tls.active = prev
            if not items:
                return
            yield from items
            prev = _active()
    finally:
        prev = _active()
        _tls.active = call
        try:
            it.close()
        finally:
            root.__exit__(None, None, None)
            _tls.active = prev


def read(n: int = 1):
    """`span("pass.read")` around a host read of device data, which adds
    its ``n`` reads to the counter ``d2h_reads``."""
    if not _on:
        return _OFF
    count("d2h_reads", n)
    return _Span("pass.read")


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the current call's counter ``name`` (a no-op while
    tracing is off or outside any call)."""
    if not _on:
        return
    call = _active()
    if call is not None:
        call.rec[name] = call.rec.get(name, 0) + n


def _on_gc(phase: str, info: dict) -> None:
    if phase == "start":
        _tls.gc = _Span("gc").__enter__() if _active() is not None else None
        return
    s = _tls.gc
    if s is None:
        return
    _tls.gc = None
    s.__exit__(None, None, None)
    if info["generation"] == 2:
        s.call.rec["gc_full"] = s.call.rec.get("gc_full", 0) + 1


def enable(ranges: bool = False) -> None:
    """Turn spans and counters on; with ``ranges`` each span also opens a
    profiler range named ``"ac." + name`` (torch's ``_RecordFunctionFast``,
    a profiler range at an eighth of ``record_function``'s cost, where the
    installed torch has it)."""
    global _on, _range
    _range = None
    if ranges:
        import torch
        from torch.profiler import record_function

        _range = getattr(torch._C._profiler, "_RecordFunctionFast",
                         record_function)
    if _on_gc not in gc.callbacks:
        gc.callbacks.append(_on_gc)
    _on = True


def disable() -> None:
    """Turn spans and counters off (the default)."""
    global _on, _range
    _on, _range = False, None
    if _on_gc in gc.callbacks:
        gc.callbacks.remove(_on_gc)


def take() -> list:
    """The records of the calls ended since the last `take` (at most the
    last KEEP), oldest first; clears them."""
    out = []
    while _done:
        out.append(_done.popleft())
    return out
