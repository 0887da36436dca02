"""The port's spans and counters (`utils/log.py`) on the CPU.

Tracing is off by default and changes no answer; a call's spans partition
its time; each engine route records its pack, upload, reads and passes;
iterators that are interleaved or dropped keep their calls apart; garbage
collections land in the span ``gc``; `take` clears and is bounded. The
kernels run their plain versions here, so no time below is a device's.
"""

import gc
import time

import numpy as np
import pytest

import ahocorasick_tpu_torch as T
from ahocorasick_tpu_torch.ops import block_scan as TBS
from ahocorasick_tpu_torch.ops import fingerprint as TF
from ahocorasick_tpu_torch.ops import staged as TS
from ahocorasick_tpu_torch.ops.bitap import LANES
from ahocorasick_tpu_torch.utils import log

NAMES = ["Sherlock Holmes", "John Watson", "Irene Adler",
         "Inspector Lestrade", "Professor Moriarty"]
N = 300_000


def _hay(n=N, seed=5, pats=NAMES, every=4999):
    rng = np.random.default_rng(seed)
    buf = bytearray(rng.integers(97, 123, size=n, dtype=np.uint8).tobytes())
    for i, at in enumerate(range(101, n - 40, every)):
        p = pats[i % len(pats)].encode()
        buf[at:at + len(p)] = p
    return bytes(buf)


def _ac(engine, pats=NAMES, **kw):
    return T.AhoCorasick(pats, device="cpu", engine=engine, **kw)


@pytest.fixture
def tracing():
    log.take()
    log.enable()
    try:
        yield
    finally:
        log.disable()
        log.take()


def _spans(rec):
    return {k[1:] for k in rec if k.startswith("#")}


def _traced(fn):
    """fn()'s result and the records of the calls it made, tracing on."""
    log.take()
    log.enable()
    try:
        out = fn()
    finally:
        log.disable()
    return out, log.take()


# Each route: (engine, operation, thresholds lowered so the route serves
# the small haystack).
ROUTES = {
    "fingerprint.find_iter": ("fingerprint", "find_iter", {}),
    "fingerprint.find_iter.host_verify": (
        "fingerprint", "find_iter", {(TF, "FP_DV_MIN"): 1 << 30}),
    "fingerprint.count": ("fingerprint", "count_matches", {}),
    "staged.count": ("auto", "count_matches", {(TS, "STAGED_MIN"): 1 << 18}),
    "bitap.count": ("auto", "count_matches", {}),
    "bitap.find_iter": ("bitap", "find_iter", {}),
    "cascade.count": ("cascade", "count_matches", {}),
    "cascade.find_iter": ("cascade", "find_iter", {}),
    "dfa-scan.count": ("dfa-scan", "count_matches", {}),
    "dfa-scan.find_iter": ("dfa-scan", "find_iter", {}),
}
# The served.* counter each route records once per call.
SERVED = {
    "fingerprint.find_iter": "fingerprint_device",
    "fingerprint.find_iter.host_verify": "fingerprint_host",
    "fingerprint.count": "fingerprint_device",
    "staged.count": "staged",
    "bitap.count": "bitap",
    "bitap.find_iter": "bitap",
    "cascade.count": "cascade",
    "cascade.find_iter": "cascade",
    "dfa-scan.count": "device_walk",
    "dfa-scan.find_iter": "device_walk",
}


def _run(ac, op, hay):
    if op == "count_matches":
        return ac.count_matches(hay)
    return [m.astuple() for m in getattr(ac, op)(hay)]


def _packed_bytes(ac, route, n):
    """Bytes of the one buffer the route's engine packs and uploads."""
    kind = route.split(".")[0]
    if kind == "fingerprint":
        L, _, tiles = ac._fp._layout(n)
    elif kind == "staged":
        L, _, tiles = ac._staged._layout(n)
    elif kind == "bitap":
        L, tiles = ac._bitap._layout(n)
    elif kind == "cascade":
        L, tiles = ac._cascade._layout(n)
    else:
        return len(TBS.pack_haystack(b"\0" * n, ac._dev_automaton.halo)[0])
    return tiles * LANES * L


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_route_records_its_steps_and_answers_as_when_off(route,
                                                         monkeypatch):
    engine, op, lowered = ROUTES[route]
    for (mod, name), v in lowered.items():
        monkeypatch.setattr(mod, name, v)
    hay = _hay()
    ac = _ac(engine, match_kind=T.MatchKind.STANDARD)
    assert not log._on and log._on_gc not in gc.callbacks
    off = _run(ac, op, hay)
    assert log.take() == []
    on, recs = _traced(lambda: _run(ac, op, hay))
    assert log._on_gc not in gc.callbacks
    assert on == off and off  # the haystack holds matches
    (rec,) = recs
    assert rec["#call"] == 1 and rec["#prepare"] == 1
    assert {"prepare.pack", "prepare.upload", "pass", "pass.read"} <= (
        _spans(rec))
    assert rec["h2d_bytes"] == _packed_bytes(ac, route, len(hay))
    assert rec["d2h_reads"] >= rec["#pass.read"] >= 1
    assert rec["passes"] >= 1
    assert ("select" in rec) == (op != "count_matches")
    assert [k for k in rec if k.startswith("served.")] == [
        "served." + SERVED[route]]
    assert rec["served." + SERVED[route]] == 1
    assert not [k for k in rec if k.startswith("declined.")]
    assert ("#pass.verify" in rec) == (SERVED[route] == "fingerprint_host")
    assert all(rec[s] >= 0 for s in _spans(rec))


@pytest.mark.parametrize("op", ["find_iter", "count_matches", "find"])
def test_spans_partition_the_call(op, tracing):
    ac = _ac("fingerprint")
    hay = _hay()
    _run(ac, "count_matches", hay)  # caps and tables settle
    log.take()
    t0 = time.perf_counter_ns()
    if op == "find":
        ac.find(hay)
    else:
        _run(ac, op, hay)
    wall = time.perf_counter_ns() - t0
    (rec,) = log.take()
    total = sum(rec[s] for s in _spans(rec))
    assert abs(total - wall) <= 0.05 * wall, (total, wall, rec)
    assert _spans(rec) >= {"call", "prepare", "pass"}


@pytest.mark.parametrize("step", [1, log.STEP])
def test_interleaved_iterators_keep_their_calls_apart(step, tracing,
                                                      monkeypatch):
    monkeypatch.setattr(log, "STEP", step)
    ac = _ac("fingerprint")
    h1, h2 = _hay(seed=1), _hay(2 * N, seed=2)
    it1, it2 = ac.find_iter(h1), ac.find_iter(h2)
    got1, got2 = [], []
    for a, b in zip(it1, it2):
        got1.append(a)
        got2.append(b)
    got1 += list(it1)
    got2 += list(it2)
    r1, r2 = log.take()
    for rec, hay, got in ((r1, h1, got1), (r2, h2, got2)):
        assert rec["#call"] == rec["#prepare"] == rec["#select"] == 1
        assert rec["h2d_bytes"] == _packed_bytes(ac, "fingerprint",
                                                 len(hay))
        assert [m.astuple() for m in got] == _run(ac, "find_iter", hay)
    assert r1["h2d_bytes"] != r2["h2d_bytes"]


@log.call_iter
def _steps(n):
    for i in range(n):
        with log.span("step"):
            log.count("items")
        yield i


@pytest.mark.parametrize("step", [1, 2, log.STEP])
def test_each_step_runs_in_its_iterators_call(step, tracing, monkeypatch):
    monkeypatch.setattr(log, "STEP", step)
    a, b = _steps(3), _steps(5)
    got = [(x, y) for x, y in zip(a, b)] + [(None, y) for y in b]
    assert got == [(0, 0), (1, 1), (2, 2), (None, 3), (None, 4)]
    ra, rb = log.take()
    assert (ra["#step"], ra["items"], rb["#step"], rb["items"]) == (
        3, 3, 5, 5)
    assert ra["#call"] == rb["#call"] == 1


@pytest.mark.parametrize("step", [1, log.STEP])
def test_dropped_iterators_end_their_calls(step, tracing, monkeypatch):
    monkeypatch.setattr(log, "STEP", step)
    ac = _ac("fingerprint")
    hay = _hay()
    it = ac.find_iter(hay)
    first = next(it)
    assert log.take() == []           # its call is still open
    n = ac.count_matches(hay)         # a call while it is suspended
    del it                            # closed: its call ends
    assert ac.find(hay) == first      # find() drops its own selection
    r_count, r_iter, r_find = log.take()
    assert n and r_count["#call"] == 1 and "select" not in r_count
    for rec in (r_iter, r_find):
        assert rec["#call"] == rec["#select"] == rec["#prepare"] == 1
    # A nested entry point joins the call that runs it.
    out = ac.replace_all_bytes(hay, [b"x"] * len(NAMES))
    (rec,) = log.take()
    assert len(out) < len(hay) and rec["#call"] == 2 and rec["#prepare"] == 1


def test_a_collection_lands_in_gc(tracing):
    gc.collect()
    assert log.take() == []           # outside any call: not recorded
    with log.span("work"):
        t0 = time.perf_counter_ns()
        gc.collect()
        took = time.perf_counter_ns() - t0
    (rec,) = log.take()
    assert rec["#gc"] >= 1 and rec["gc_full"] >= 1
    assert 0 < rec["gc"] <= took and rec["work"] < took


def test_take_clears_and_is_bounded(tracing):
    for _ in range(log.KEEP + 3):
        with log.span("x"):
            log.count("items", 2)
    recs = log.take()
    assert len(recs) == log.KEEP and log.take() == []
    assert recs[-1]["items"] == 2 and recs[-1]["#x"] == 1
    log.count("items")                # outside any call: dropped
    assert log.take() == []


def test_off_is_one_shared_object_and_no_callback():
    assert not log._on
    assert log.span("a") is log.span("b") is log.read(3)
    assert log._on_gc not in gc.callbacks
    with log.span("a"):
        log.count("n")
    assert log.take() == []
    log.enable()
    log.enable()
    assert gc.callbacks.count(log._on_gc) == 1
    log.disable()
    assert log._on_gc not in gc.callbacks


def test_ranges_lay_the_spans_on_the_profiler_timeline():
    from torch.profiler import ProfilerActivity, profile

    ac = _ac("fingerprint")
    hay = _hay()
    want = [m.astuple() for m in ac.find_iter(hay)]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        log.enable(ranges=True)
        try:
            got = [m.astuple() for m in ac.find_iter(hay)]
        finally:
            log.disable()
    assert got == want
    names = {e.name for e in prof.events()}
    assert {"ac.call", "ac.prepare", "ac.prepare.pack", "ac.prepare.upload",
            "ac.pass", "ac.pass.read", "ac.select"} <= names
    (rec,) = log.take()
    assert rec["#call"] == 1


def test_tracing_loads_no_jax():
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys, ahocorasick_tpu_torch as T\n"
        "from ahocorasick_tpu_torch.utils import log\n"
        "log.enable(ranges=True)\n"
        "n = T.AhoCorasick(['ab'], device='cpu').count_matches(b'xab' * 900)\n"
        "log.disable()\n"
        "assert n == 900 and log.take()[0]['#call'] == 1\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'ahocorasick_tpu'))\n"
        "print(bad)\n"
        "raise SystemExit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
