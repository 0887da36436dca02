"""One run of one cell: set-up, a timed window of facade calls, the check
against the plain reference, and the result line.

Everything a cell needs is found by name: the cell in BENCHMARK.json and
``portbench/workloads/<cell>.json``, its configuration in
``portbench/configs/<config>.json``, each metric in
``portbench/metrics/<metric>.py`` (a function ``read(run)`` that returns a
number, or None where it finds nothing to read), and what those files
name in a module of its own: the pattern set's and the haystacks'
generators in ``portbench/generators/``, the operation in
``portbench/operations/``, the searcher in ``portbench/searchers/``.
Adding a cell, a configuration, a metric, a generator, an operation or a
searcher takes new files and BENCHMARK.json entries only.

The window is a closed loop with one caller: each call gets a haystack of
the pool as host ``bytes`` and starts when the previous call has returned
and its result is consumed, as the operation's file consumes it (the
``int``, or ``list()`` of the iterator).
A traced run (``trace``) lays spans around the engines' ``prepare`` and
``count_matches`` / ``match_pairs`` for the window, each span boundary
after a synchronise, and then profiles ``profile_calls`` more calls under
torch.profiler, each call and engine method under a ``record_function``
label and none synchronised.
"""

from __future__ import annotations

import functools
import gc
import importlib
import importlib.util
import json
import os
import pkgutil
import random
import sys
import time
import traceback
from typing import Callable, Dict, List, Optional

from .profile import LABEL, profiled
from .reference import Reference

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "ahocorasick_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "ahocorasick_tpu")
# Engine methods the traced run lays spans around, by span label.
SPAN_METHODS = {"prepare": "prepare", "count_matches": "engine",
                "match_pairs": "engine"}


class HarnessError(RuntimeError):
    """A run that cannot give a result (exits non-zero, prints none)."""


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def forbidden_modules(names) -> List[str]:
    """Top-level names among module ``names`` that are JAX or the JAX
    package, compared whole (``ahocorasick_tpu_torch`` is not
    ``ahocorasick_tpu``)."""
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


# ---------------------------------------------------------------------------
# Files, by name
# ---------------------------------------------------------------------------
def _json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_cell(root: str, name: str) -> Dict:
    """The cell ``name``: its BENCHMARK.json entries, workload, config and
    metric lists."""
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise HarnessError(f"no cell {name!r} in BENCHMARK.json")
    entry = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    workload = _json(os.path.join(root, "portbench", "workloads",
                                  f"{name}.json"))
    if workload["config"] != entry["config"]:
        raise HarnessError(f"{name}: workload file names config "
                           f"{workload['config']!r}, BENCHMARK.json "
                           f"{entry['config']!r}")

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]
    return dict(
        name=name, entry=entry, workload=workload,
        config=_json(os.path.join(root, configs[entry["config"]]["file"])),
        end_to_end=mine(bench["end_to_end"]),
        per_layer=mine(bench["per_layer"]),
    )


def load_named(root: str, kind: str, name: str):
    """The module ``portbench/<kind>/<name>.py`` of ``root``."""
    path = os.path.join(root, "portbench", kind, f"{name}.py")
    if not os.path.isfile(path):
        raise HarnessError(f"no {kind} {name!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(root: str, metric: str) -> Callable:
    """``read`` of ``portbench/metrics/<metric>.py``."""
    return load_named(root, "metrics", metric).read


def make_inputs(root: str, cfg: Dict, wl: Dict, seed: int):
    """The configuration's patterns and the workload's pool of haystacks
    from ``seed``, each by the generator its file names."""
    pspec, tspec = cfg["patterns"], wl["text"]
    patterns = load_named(root, "generators",
                          pspec["generator"]).patterns(pspec)
    pool = load_named(root, "generators", tspec["generator"]).pool(
        tspec, patterns, wl["haystack_bytes"], wl["pool"], seed)
    return patterns, pool


def reference_of(cfg: Dict, patterns: List[bytes], device) -> Reference:
    sem = cfg["semantics"]
    return Reference(patterns, match_kind=sem["match_kind"],
                     ascii_case_insensitive=sem["ascii_case_insensitive"],
                     device=device)


# ---------------------------------------------------------------------------
# Spans and labels around the engines
# ---------------------------------------------------------------------------
class Tracer:
    """Wraps the port's ``*Engine`` methods of SPAN_METHODS. ``mode``:
    None (pass through), ``"label"`` (a ``record_function`` range, no
    synchronise) or ``"span"`` (self time per label and call, each span
    boundary after a synchronise)."""

    def __init__(self, sync: Callable[[], None]):
        self.sync = sync
        self.mode: Optional[str] = None
        self.laid: List[str] = []
        self.calls: List[Dict[str, float]] = []
        self._saved = []
        self._stack: List[str] = []
        self._cur: Optional[Dict[str, float]] = None
        self._last = 0.0

    def install(self):
        try:
            ops = importlib.import_module(PORT + ".ops")
        except ImportError as e:
            log(f"[spans] {PORT}.ops cannot be imported ({e}): no spans")
            return
        for info in pkgutil.iter_modules(ops.__path__):
            mod = importlib.import_module(f"{PORT}.ops.{info.name}")
            for cname, cls in vars(mod).items():
                if (not cname.endswith("Engine") or not isinstance(cls, type)
                        or cls.__module__ != mod.__name__):
                    continue
                for meth, label in SPAN_METHODS.items():
                    if meth in vars(cls):
                        self._wrap(cls, meth, label)
        if not self.laid:
            log(f"[spans] no *Engine.{'/'.join(SPAN_METHODS)} found in "
                f"{PORT}.ops: span metrics are left out")

    def _wrap(self, cls, meth, label):
        orig = vars(cls)[meth]
        tracer = self

        @functools.wraps(orig)
        def wrapped(*a, **k):
            if tracer.mode == "span" and tracer._cur is not None:
                tracer._enter(label)
                try:
                    return orig(*a, **k)
                finally:
                    tracer._exit()
            if tracer.mode == "label":
                from torch.profiler import record_function
                with record_function(LABEL + label):
                    return orig(*a, **k)
            return orig(*a, **k)
        setattr(cls, meth, wrapped)
        self._saved.append((cls, meth, orig))
        self.laid.append(f"{cls.__name__}.{meth}")

    def uninstall(self):
        for cls, meth, orig in reversed(self._saved):
            setattr(cls, meth, orig)
        self._saved.clear()

    def _mark(self):
        self.sync()
        t = time.perf_counter()
        top = self._stack[-1] if self._stack else "facade"
        self._cur[top] = self._cur.get(top, 0.0) + t - self._last
        self._last = t

    def _enter(self, label):
        self._mark()
        self._stack.append(label)

    def _exit(self):
        self._mark()
        self._stack.pop()

    def begin_call(self):
        if self.mode == "span":
            self.sync()
            self._cur, self._stack, self._last = {}, [], time.perf_counter()

    def end_call(self):
        if self.mode == "span":
            self._mark()
            self.calls.append(self._cur)
            self._cur = None


# ---------------------------------------------------------------------------
# The run
# ---------------------------------------------------------------------------
class Run:
    """What the metric readers read: the cell, the window's calls, the
    spans and the profile."""

    def __init__(self, cell: Dict):
        self.cell = cell
        self.workload = cell["workload"]
        self.config = cell["config"]
        self.setup_s: float = 0.0
        self.window_s: float = 0.0
        self.durations: List[float] = []   # seconds, every window call
        self.bytes_done = 0                # haystack bytes of those calls
        self.spans: Optional[List[Dict[str, float]]] = None
        self.kept: List[tuple] = []        # (pool index, answer) to check
        self.failures: List[int] = []      # indices of calls that raised
        self.calls = 0                     # every call, profiled ones too
        self.profile: Optional[Dict] = None
        self.profile_pool: List[int] = []  # pool index of each profiled call
        self.pool_bytes: List[int] = []    # length of each pool haystack
        self.matches: Dict[int, int] = {}  # reference matches by pool index
        self.sm_hz: Optional[float] = None


def checked_calls(seed: int, pool: int, every: int) -> Callable:
    """Which window calls the check keeps: the first ``pool`` (one for
    each haystack of the pool), then a share 1/``every`` of the rest,
    drawn in call order from ``seed``."""
    draw = random.Random(seed)
    return lambda i: i < pool or draw.random() * every < 1


def _tenths(values: List[float]) -> List[float]:
    """The mean of each tenth of ``values``, in order."""
    n = len(values)
    parts = (values[k * n // 10:(k + 1) * n // 10] for k in range(10))
    return [sum(p) / max(1, len(p)) for p in parts]


def _window(w: Run, call, keep, pool, seconds, check, tracer, trace,
            prof_calls, on_cuda):
    """The closed loop for ``seconds``, filling ``w`` (spans laid in a
    traced run); then ``prof_calls`` more calls under the profiler, with
    labels and no spans. ``check(i)`` says whether call i's answer is
    kept for the check; keeping it (``keep``: as an array, which the
    garbage collector does not track) is the harness's own work and is
    taken out of the window's time."""
    book = [0.0]
    full_gc = []
    gc_t = [0.0]

    def on_gc(phase, info):
        if info["generation"] == 2:
            if phase == "start":
                gc_t[0] = time.perf_counter()
            else:
                full_gc.append(time.perf_counter() - gc_t[0])

    def one():
        i = w.calls
        h = pool[i % len(pool)]
        tracer.begin_call()
        t0 = time.perf_counter()
        try:
            res = call(h)
        except Exception:  # a failed call: counted, the loop goes on
            w.failures.append(i)
            if len(w.failures) == 1:
                log("[window] call failed:\n" + traceback.format_exc())
            res = None
        t1 = time.perf_counter()
        tracer.end_call()
        w.calls = i + 1
        if check(i) and res is not None:
            w.kept.append((i % len(pool), keep(res)))
            book[0] += time.perf_counter() - t1
        return t0, t1, len(h)

    tracer.mode = "span" if trace else None
    gc.callbacks.append(on_gc)
    try:
        t_start = time.perf_counter()
        deadline = t_start + seconds
        t1 = t_start
        while t1 < deadline:
            t0, t1, n = one()
            w.durations.append(t1 - t0)
            w.bytes_done += n
    finally:
        gc.callbacks.remove(on_gc)
    w.window_s = t1 - t_start - book[0]
    d = sorted(w.durations)
    q = {p: d[min(len(d) - 1, int(p * len(d)))] * 1e3
         for p in (0.5, 0.9, 0.95, 0.99)}
    log(f"[window] {len(d)} calls in {w.window_s:.3f} s (+{book[0]:.3f} s "
        f"keeping answers): ms p50 {q[0.5]:.3f} p90 {q[0.9]:.3f} p95 "
        f"{q[0.95]:.3f} p99 {q[0.99]:.3f} max {d[-1] * 1e3:.3f}; "
        f"{len(full_gc)} full collections, {sum(full_gc):.3f} s, "
        f"{len(gc.get_objects())} objects tracked")
    log("[tenths] mean call ms: " + " ".join(
        f"{1e3 * v:.3f}" for v in _tenths(w.durations)))
    if trace and tracer.calls:
        for label in ("prepare", "engine", "facade"):
            log(f"[tenths] {label} ms a call: " + " ".join(
                f"{1e3 * v:.3f}" for v in _tenths(
                    [c.get(label, 0.0) for c in tracer.calls])))
    if prof_calls:
        tracer.mode = "label"
        from torch.profiler import record_function

        def run_calls():
            for _ in range(prof_calls):
                w.profile_pool.append(w.calls % len(pool))
                with record_function(LABEL + "call"):
                    one()
            return prof_calls
        if on_cuda:
            w.profile = profiled(run_calls, log)
        else:
            run_calls()
    tracer.mode = None


def run(name: str, seed: int, seconds: float, trace: bool, *,
        t_process: float, root: str = ROOT, device: str = "cuda",
        searcher_factory: Callable = None, require_cuda: bool = True):
    """One run of cell ``name``; returns the result line's object.
    ``searcher_factory(cfg, patterns, device)`` replaces the program (the
    control); ``device="cpu"`` and ``require_cuda=False`` serve the tests
    on a machine without a card. Raises HarnessError where no result may
    be printed."""
    import torch

    cell = load_cell(root, name)
    on_cuda = device == "cuda"
    if require_cuda:
        if not torch.cuda.is_available():
            raise HarnessError("no CUDA device: torch.cuda.is_available() "
                               "is false")
        chips = cell["entry"]["chips"]
        if torch.cuda.device_count() < chips:
            raise HarnessError(f"the cell asks for {chips} cards, "
                               f"{torch.cuda.device_count()} present")
    sync = torch.cuda.synchronize if on_cuda else (lambda: None)
    wl, cfg = cell["workload"], cell["config"]
    op = load_named(root, "operations", wl["operation"])
    r = Run(cell)

    # Set-up: data, the searcher, warm-up over every haystack of the pool.
    patterns, pool = make_inputs(root, cfg, wl, seed)
    r.pool_bytes = [len(h) for h in pool]
    check = checked_calls(seed, len(pool), wl.get("check_every", 1))
    if searcher_factory is None:
        build = load_named(root, "searchers", cfg["searcher"]).build
        try:
            searcher = build(cfg, patterns, device)
        except ImportError as e:
            raise HarnessError(f"the program cannot be imported: {e}")
    else:
        searcher = searcher_factory(cfg, patterns, device)
    tracer = Tracer(sync)
    if trace:
        tracer.install()
    call = op.consumer(searcher)

    def timed(h):
        out = call(h)
        sync()
        return out
    try:
        for _ in range(wl.get("warmup_rounds", 1)):
            for h in pool:
                timed(h)
        if on_cuda and trace:
            r.sm_hz = card_sm_hz()
        r.setup_s = time.perf_counter() - t_process
        _window(r, timed, op.keep, pool, seconds,
                check, tracer, trace,
                wl.get("profile_calls", 0) if trace else 0, on_cuda)
    finally:
        tracer.uninstall()
    kept, failures = r.kept, r.failures
    if trace:
        r.spans = tracer.calls

    bad = forbidden_modules(list(sys.modules))
    if bad:
        raise HarnessError(f"modules loaded in the run: {', '.join(bad)}")
    peak = torch.cuda.max_memory_allocated() if on_cuda else 0
    kind = torch.cuda.get_device_name(0) if on_cuda else "cpu"

    # The program's state goes before the reference runs.
    del searcher, call, timed
    gc.collect()
    if on_cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = reference_of(cfg, patterns, device)
    want = {idx: op.expected(ref, pool[idx])
            for idx in sorted({i for i, _ in kept} | set(r.profile_pool))}
    r.matches = {i: op.matches(w) for i, w in want.items()}
    gaps = [op.gap(res, want[idx]) for idx, res in kept]
    wrong, worst = sum(g > 0 for g in gaps), max(gaps, default=0)
    log(f"[reference] {len(want)} haystacks in "
        f"{time.perf_counter() - t_ref:.1f} s")

    metrics = {}
    for m in cell["per_layer"] if trace else cell["end_to_end"]:
        value = load_reader(root, m["name"])(r)
        if value is None:
            log(f"[metric] {m['name']}: nothing to read in this run, "
                f"left out")
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    share = metrics.get("kernels_roofline", {}).get("value")
    if share is not None and share > 100:
        raise HarnessError(f"kernels_roofline {share}% > 100%: the bound "
                           f"counts too much work or the kernel time "
                           f"misses part of it")
    dev_info = {"platform": "gpu" if on_cuda else "cpu", "kind": kind,
                "count": 1, "memory_peak_bytes": peak}
    out = {"correct": None, "attempted": r.calls,
           "failed": len(failures), "metrics": metrics, "device": dev_info}
    if trace:
        p = r.profile or {}
        if on_cuda and "busy_s" not in p:
            raise HarnessError("the traced window's device activity was "
                               "not measured")
        dev_info["busy_s"] = p.get("busy_s")
        dev_info["window_s"] = p.get("window_s")
        if "device_ops" in p:
            out["breakdown"] = {"device_ops": p["device_ops"],
                                "idle_gaps": p["idle_gaps"]}
    checks = {"wrong_calls": {"value": wrong, "max": 0},
              "worst_gap": {"value": worst, "max": 0},
              "failed_calls": {"value": len(failures), "max": 0},
              "checked_calls": {"value": len(kept), "min": 1}}
    out["correct"] = bool(wrong == 0 and worst == 0 and not failures
                          and kept)
    out["checks"] = checks
    return out


def card_sm_hz() -> float:
    from .roofline import card_rates
    name, hz = card_rates()
    log(f"[card] {name}")
    return hz
