"""Drive the PyTorch port's main path on an NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed N]

Runs `ahocorasick_tpu_torch` (never JAX, never the JAX package) on the
card: builds the Hopper shift-AND kernels from csrc/bitap.cu with nvcc,
drives the facade at full size (the five-name set over a 64 MiB
English-like haystack, a 16 MiB extraction, the 594,915-byte headline
size, a 64 MiB set without a pad byte, a K = 229 limb set), holds every
result against host truth from `bytes.find`, holds each kernel bit for
bit against its plain PyTorch version, and times each kernel (CUDA
events around a CUDA graph of launches) beside its bound.

Phases, each raising on a mismatch:
  1. environment (card, power limit, torch, CUDA, nvcc);
  2. build (and the ptxas register/spill report);
  3. G2 count: 64 MiB, five names;
  4. G2 extract: find_overlapping_iter / find_iter on 16 MiB (two 8 MiB
     chunks), raw words against the plain version on one chunk;
  5. G1: count + find_iter at 594,915 bytes, count at 64 MiB for a set
     with no pad byte, a K = 229 set at a small size;
  6. timing of each kernel at those shapes; whole facade calls (host
     clock, ending in a synchronise) with the parts of `prepare`; a
     torch.profiler trace of one call each for the device's idle share;
  7. a `kernels` JSON line (launch counts from phases 3-5, errors, times,
     bounds), then the card's name and power limit, then the final
     `{"ok": true, ...}` line.

Exits non-zero without the final line when no CUDA device is present
or anything fails. Details go to chiprun_out/chip_smoke.json.
"""

import argparse
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

NAMES = [b"Sherlock Holmes", b"John Watson", b"Irene Adler",
         b"Inspector Lestrade", b"Professor Moriarty"]
WORDS = (
    "the quick brown fox jumps over lazy dog time of day it was best "
    "worst epoch belief incredulity season light darkness hope despair"
).split()
MIB = 1 << 20
HEADLINE_N = 594_915      # the reference's own headline corpus size
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
INT32_LANES_PER_SM = 64    # Hopper SM: 64 INT32 units
REPS = 20                  # kernel launches per timed CUDA graph
RUNS = 7                   # facade calls per end-to-end median


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------
def english(n: int, rng: np.random.Generator, name_p: float = 0.001):
    """English-like text with the five names at rate ``name_p`` per
    word, assembled with vectorised gathers in 8 MiB blocks."""
    vocab = [w.encode() + b" " for w in WORDS] + [p + b" " for p in NAMES]
    p = np.full(len(vocab), (1 - name_p) / len(WORDS))
    p[len(WORDS):] = name_p / len(NAMES)
    flat = np.frombuffer(b"".join(vocab), np.uint8)
    lens = np.array([len(v) for v in vocab], np.int64)
    offs = np.cumsum(lens) - lens
    out, size = [], 0
    while size < n:
        idx = rng.choice(len(vocab), size=(8 * MIB) // 5, p=p)
        ln = lens[idx]
        dst = np.cumsum(ln) - ln
        gather = np.arange(int(ln.sum())) + np.repeat(offs[idx] - dst, ln)
        block = flat[gather]
        out.append(block)
        size += len(block)
    return np.concatenate(out)[:n].tobytes()


def random_with(pats, n: int, inserts: int, rng):
    """Uniform random bytes with ``inserts`` copies of the patterns."""
    buf = rng.integers(0, 256, n, dtype=np.uint8)
    pos = rng.choice(n - 64, size=inserts, replace=False)
    for i, at in enumerate(np.sort(pos)):
        p = pats[i % len(pats)]
        buf[at:at + len(p)] = np.frombuffer(p, np.uint8)
    return buf.tobytes()


def host_pairs(pats, hay: bytes):
    """All overlapping (pid, start, end), by repeated bytes.find."""
    out = []
    for pid, p in enumerate(pats):
        i = hay.find(p)
        while i >= 0:
            out.append((pid, i, i + len(p)))
            i = hay.find(p, i + 1)
    return out


def overlapping_order(pats, pairs):
    """Report order of an overlapping search: end asc, then length desc,
    then pattern id asc."""
    return sorted(pairs, key=lambda t: (t[2], -len(pats[t[0]]), t[0]))


def standard_nonoverlapping(pats, pairs):
    """Standard-semantics find_iter from the overlapping set: the
    earliest-ending match that starts at or after the previous match's
    end, ties by the overlapping report order."""
    out, cursor = [], 0
    for t in overlapping_order(pats, pairs):
        if t[1] >= cursor:
            out.append(t)
            cursor = t[2]
    return out


# ---------------------------------------------------------------------------
# Environment and build
# ---------------------------------------------------------------------------
def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def ptxas_summary(report: str):
    """One line per compiled kernel: template args, registers, spills."""
    lines, name = [], None
    for ln in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = m.group(1)
            t = re.search(r"ILi(\d+)ELb([01])ELb([01])E", name)
            if t:
                name = (f"scan_kernel<KR={t.group(1)}, "
                        f"{'G2' if t.group(2) == '1' else 'G1'}, "
                        f"{'extract' if t.group(3) == '1' else 'count'}>")
        elif "spill" in ln or "Used" in ln:
            lines.append(f"  {name}: {ln.split(':', 1)[-1].strip()}")
    return lines


# ---------------------------------------------------------------------------
# Checks and timing
# ---------------------------------------------------------------------------
def max_abs_err(got, want):
    err = 0
    for g, w in zip(got, want):
        if w is None:
            continue
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"shape/dtype {g.shape} {w.shape}")
        e = int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
        err = max(err, e)
    if err:
        raise AssertionError(f"kernel disagrees with plain version: {err}")
    return err


def events_ms(fn):
    """Device time of ``fn`` on the current stream (CUDA events)."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b)


def kernel_ms(fn):
    """Per-launch device time of a kernel wrapper: REPS launches captured
    in one CUDA graph, so the wrapper's host-side checks and the launch
    path are out of the measurement; mean of 5 replays after a warm one."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(REPS):
            fn()
    graph.replay()
    ms = events_ms(lambda: [graph.replay() for _ in range(5)])
    del graph
    return ms / (5 * REPS)


def bound(K, kdim, n, tiles, extract, int_ops_per_s):
    """(bound_ms, bound_by) for a scan of the n haystack bytes: the larger
    of the bytes it must move (the n bytes and the tables read once, the
    per-stream counts and, when extracting, 4*kdim bytes of end words per
    haystack byte written once) over the memory rate, and the int32
    operations (2 + 8K per haystack byte) over the int32 rate. Padding
    and the halo's warm-up bytes are layout overhead, charged nothing."""
    moved = n + 34 * K * 4 + tiles * 1024 * 4
    if extract:
        moved += n * 4 * kdim
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = n * (2 + 8 * K) / int_ops_per_s * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def trace(fn):
    """One call under torch.profiler: (call ms, device-busy ms, the busy
    time by device activity). Busy time is the union of the device's
    kernel and copy intervals inside the call (the call's own annotation,
    which the profiler also lays on the device timeline, is left out);
    None when the trace holds no device activity."""
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("chip_smoke_call"):
            fn()
            torch.cuda.synchronize()
    evs = prof.events()
    call = next(e for e in evs if e.name == "chip_smoke_call")
    c0, c1 = call.time_range.start, call.time_range.end
    dev = sorted((max(e.time_range.start, c0), min(e.time_range.end, c1),
                  e.name) for e in evs
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and e.name != "chip_smoke_call")
    dev = [d for d in dev if d[1] > d[0]]
    if not dev:
        return (c1 - c0) / 1e3, None, {}
    busy, end, by = 0.0, c0, {}
    for a, b, name in dev:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
        by[name] = by.get(name, 0.0) + (b - a) / 1e3
    return (c1 - c0) / 1e3, busy / 1e3, by


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from ahocorasick_tpu_torch import AhoCorasick
        from ahocorasick_tpu_torch.ops import bitap as TB
        from ahocorasick_tpu_torch.ops import bitap_kernels as TK
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}",
              file=sys.stderr)
        return 2
    t_start = time.time()
    rng = np.random.default_rng(args.seed)
    dev = torch.device("cuda")
    report = {"seed": args.seed}

    # 1. Environment ---------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    card = smi("name,power.limit")
    max_mhz = float(smi("clocks.max.sm").split()[0])
    int_ops = INT32_LANES_PER_SM * torch.cuda.get_device_properties(
        0).multi_processor_count * max_mhz * 1e6
    nvcc = subprocess.run([TK._nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60, check=True).stdout
    log(f"[env] device: {kind} | nvidia-smi: {card}")
    log(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    log(f"[env] nvcc: {nvcc.strip().splitlines()[-1]}")
    log(f"[env] int32 rate {int_ops / 1e12:.2f} Tops/s "
        f"(64 lanes x SMs x {max_mhz:.0f} MHz max SM clock)")
    report["env"] = dict(kind=kind, smi=card, torch=torch.__version__,
                         cuda=torch.version.cuda, max_sm_mhz=max_mhz)

    # 2. Build ---------------------------------------------------------------
    t0 = time.time()
    TK.load_library()
    ptx = TK.build_report()
    log(f"[build] bitap.cu -> sm_90a in {time.time() - t0:.1f} s")
    for ln in ptxas_summary(ptx):
        log("[build]" + ln)
    report["ptxas"] = ptx

    names = [p.decode() for p in NAMES]
    ac = AhoCorasick(names, device=dev)
    eng = ac._bitap_engine()
    lo, hi, sm, em = eng._args()
    errs = {"G1": 0, "G2": 0}
    launches = {"G1": 0, "G2": 0}

    def drive(fn):
        """Run one main-path call; launch counts from it are kept."""
        TK.reset_counts()
        out = fn()
        torch.cuda.synchronize()
        launches["G1"] += TK.generic_launches
        launches["G2"] += TK.baked_launches
        return out, TK.generic_launches, TK.baked_launches

    # 3. G2 count, 64 MiB ------------------------------------------------------
    t0 = time.time()
    hay64 = english(64 * MIB, rng)
    truth = host_pairs(NAMES, hay64)
    got, g1, g2 = drive(lambda: ac.count_matches(hay64))
    assert eng.tables.pad_byte is not None and eng._use_baked(len(hay64))
    if got != len(truth) or g2 != 1 or g1 != 0:
        raise AssertionError(f"G2 count {got} vs {len(truth)}, "
                             f"launches G1 {g1} G2 {g2}")
    ph64 = eng.prepare(hay64)
    args64 = (lo, hi, sm, em, eng.tables.end_limbs, ph64.halo_a, ph64.body,
              False)
    errs["G2"] = max(errs["G2"], max_abs_err(
        TK.bitap_scan_baked(*args64), TK.bitap_scan_baked_plain(*args64)))
    log(f"[G2 count] 64 MiB: {got} matches = host truth; K={eng.tables.k}, "
        f"layout L={ph64.L} x {ph64.tiles} tiles; kernel = plain "
        f"({time.time() - t0:.1f} s)")

    # 4. G2 extract, 16 MiB ------------------------------------------------------
    t0 = time.time()
    hay16 = hay64[:16 * MIB]
    truth16 = host_pairs(NAMES, hay16)
    want_ov = overlapping_order(NAMES, truth16)
    got_ov, g1, g2 = drive(lambda: [m.astuple()
                                    for m in ac.find_overlapping_iter(hay16)])
    # Two 8 MiB chunks on G2; the chunk loop re-splits the overlapped
    # second chunk (8 MiB + max_len - 1 bytes), as the JAX package does,
    # leaving a tail of 2 * (max_len - 1) bytes for G1.
    if got_ov != want_ov or g2 != 2 or g1 > 1:
        raise AssertionError(f"G2 overlapping extract: {len(got_ov)} vs "
                             f"{len(want_ov)}, launches G1 {g1} G2 {g2}")
    got_it, g1, g2 = drive(lambda: [m.astuple() for m in ac.find_iter(hay16)])
    if got_it != standard_nonoverlapping(NAMES, truth16) or g2 != 2:
        raise AssertionError("G2 find_iter disagrees with host truth")
    chunk = eng.prepare(hay16[:TB.MAX_EXTRACT_CHUNK])
    argsx = (lo, hi, sm, em, eng.tables.end_limbs, chunk.halo_a, chunk.body,
             True)
    errs["G2"] = max(errs["G2"], max_abs_err(
        TK.bitap_scan_baked(*argsx), TK.bitap_scan_baked_plain(*argsx)))
    log(f"[G2 extract] 16 MiB: {len(got_ov)} overlapping, {len(got_it)} "
        f"find_iter = host truth; raw words of one 8 MiB chunk = plain "
        f"({time.time() - t0:.1f} s)")

    # 5. G1 ---------------------------------------------------------------------
    t0 = time.time()
    hay_h = hay64[:HEADLINE_N]
    truth_h = host_pairs(NAMES, hay_h)
    got, g1, g2 = drive(lambda: ac.count_matches(hay_h))
    if got != len(truth_h) or g1 != 1 or g2 != 0:
        raise AssertionError(f"G1 count {got} vs {len(truth_h)}")
    got_it, g1, g2 = drive(lambda: [m.astuple() for m in ac.find_iter(hay_h)])
    if got_it != standard_nonoverlapping(NAMES, truth_h) or g1 != 1:
        raise AssertionError("G1 find_iter disagrees with host truth")
    ph_h = eng.prepare(hay_h)
    for ex in (False, True):
        a = (lo, hi, sm, em, ph_h.halo_a, ph_h.body, 0, HEADLINE_N, ex)
        errs["G1"] = max(errs["G1"], max_abs_err(
            TK.bitap_scan_generic(*a), TK.bitap_scan_generic_plain(*a)))
    log(f"[G1 headline] {HEADLINE_N} B: {len(truth_h)} matches, "
        f"{len(got_it)} find_iter = host truth; kernel = plain "
        f"(count, extract)")

    nopad = [bytes(range(8 * i, 8 * i + 8)) for i in range(32)]
    ac_np = AhoCorasick(nopad, device=dev)
    eng_np = ac_np._bitap_engine()
    assert eng_np.tables.pad_byte is None
    hay_np = random_with(nopad, 64 * MIB, 20_000, rng)
    truth_np = host_pairs(nopad, hay_np)
    got, g1, g2 = drive(lambda: ac_np.count_matches(hay_np))
    if got != len(truth_np) or g1 != 1 or g2 != 0:
        raise AssertionError(f"G1 no-pad count {got} vs {len(truth_np)}")
    ph_np = eng_np.prepare(hay_np)
    a_np = eng_np._args() + (ph_np.halo_a, ph_np.body, 0, len(hay_np), False)
    errs["G1"] = max(errs["G1"], max_abs_err(
        TK.bitap_scan_generic(*a_np), TK.bitap_scan_generic_plain(*a_np)))
    log(f"[G1 no pad byte] 64 MiB, K={eng_np.tables.k}: {got} matches = "
        f"host truth; kernel = plain")

    k229 = [bytes([i]) + b"ab" for i in range(256)]
    ac_k = AhoCorasick(k229, device=dev)
    eng_k = ac_k._bitap_engine()
    assert eng_k.tables.k == 229
    hay_k = random_with(k229, 1 * MIB, 3000, rng)
    got, g1, g2 = drive(lambda: ac_k.count_matches(hay_k))
    if got != len(host_pairs(k229, hay_k)) or g1 != 1:
        raise AssertionError("G1 K=229 count disagrees with host truth")
    ph_k = eng_k.prepare(hay_k)  # the layout the facade launched
    for ex in (False, True):
        a = eng_k._args() + (ph_k.halo_a, ph_k.body, 0, len(hay_k), ex)
        errs["G1"] = max(errs["G1"], max_abs_err(
            TK.bitap_scan_generic(*a), TK.bitap_scan_generic_plain(*a)))
    log(f"[G1 K=229] 1 MiB, L={ph_k.L} x {ph_k.tiles} tiles: {got} matches "
        f"= host truth; kernel = plain (count, extract) "
        f"({time.time() - t0:.1f} s)")
    log(f"[launches] main path: G1 {launches['G1']}, G2 {launches['G2']}")

    # 6. Timing ------------------------------------------------------------------
    def row(name, K, kdim, ph, extract, kern, plain):
        ms = kernel_ms(kern)
        bms, by = bound(K, kdim, ph.n, ph.tiles, extract, int_ops)
        r = dict(name=name, K=K, bytes=ph.n, extract=extract, ms=ms,
                 plain_ms=events_ms(plain), bound_ms=bms, bound_by=by,
                 gbps=ph.n / ms / 1e6, share_of_bound=bms / ms)
        log(f"[time] {name}: {ms:.4f} ms ({r['gbps']:.1f} GB/s), plain "
            f"{r['plain_ms']:.1f} ms, bound {bms:.4f} ms ({by}), "
            f"{100 * bms / ms:.1f}% of bound | {card}")
        return r

    K3, Ke = eng.tables.k, len(eng.tables.end_limbs)
    ax = lambda ex: (lo, hi, sm, em, eng.tables.end_limbs,  # noqa: E731
                     ph64.halo_a, ph64.body, ex)
    cx = lambda ex: (lo, hi, sm, em, eng.tables.end_limbs,  # noqa: E731
                     chunk.halo_a, chunk.body, ex)
    hx = lambda ex: (lo, hi, sm, em, ph_h.halo_a, ph_h.body,  # noqa: E731
                     0, HEADLINE_N, ex)
    rows = [
        row("G2 count 64 MiB", K3, Ke, ph64, False,
            lambda: TK.bitap_scan_baked(*ax(False)),
            lambda: TK.bitap_scan_baked_plain(*ax(False))),
        row("G2 extract 8 MiB chunk", K3, Ke, chunk, True,
            lambda: TK.bitap_scan_baked(*cx(True)),
            lambda: TK.bitap_scan_baked_plain(*cx(True))),
        row("G1 count 594,915 B", K3, K3, ph_h, False,
            lambda: TK.bitap_scan_generic(*hx(False)),
            lambda: TK.bitap_scan_generic_plain(*hx(False))),
        row("G1 extract 594,915 B", K3, K3, ph_h, True,
            lambda: TK.bitap_scan_generic(*hx(True)),
            lambda: TK.bitap_scan_generic_plain(*hx(True))),
        row(f"G1 count 64 MiB no pad K={eng_np.tables.k}", eng_np.tables.k,
            eng_np.tables.k, ph_np, False,
            lambda: TK.bitap_scan_generic(*a_np),
            lambda: TK.bitap_scan_generic_plain(*a_np)),
    ]
    report["timings"] = rows
    report["launches"] = launches

    # End to end: host clock around one facade call that ends in a
    # synchronise, so packing, upload, transpose, scan and the host-side
    # reduction or decode all count. Median of RUNS calls; then one call
    # under the profiler for the device's busy time.
    def host_ms(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3

    def e2e(name, n, fn):
        ts = [host_ms(fn) for _ in range(RUNS)]
        ms = float(np.median(ts))
        call_ms, busy_ms, by = trace(fn)
        # Share of the traced call (the profiler slows the host side, so
        # this leans high) and of the untraced median.
        idle = None if busy_ms is None else 1 - busy_ms / call_ms
        idle_med = None if busy_ms is None else 1 - busy_ms / ms
        top = sorted(by.items(), key=lambda kv: -kv[1])[:4]
        log(f"[e2e] {name}: {ms:.3f} ms ({n / ms / 1e6:.3f} GB/s of "
            f"haystack) | {card}")
        log(f"[trace] {name}: call {call_ms:.3f} ms, device busy "
            + ("not measured (no device activity in the trace)"
               if busy_ms is None else
               f"{busy_ms:.3f} ms, idle {100 * idle:.1f}% of the traced "
               f"call, {100 * idle_med:.1f}% of the median call; "
               + "; ".join(f"{k[:48]} {v:.3f} ms" for k, v in top)))
        return dict(name=name, bytes=n, ms=ms, runs_ms=ts,
                    gbps=n / ms / 1e6, traced_call_ms=call_ms,
                    device_busy_ms=busy_ms, device_idle_share=idle,
                    device_idle_share_of_median=idle_med,
                    device_ms_by_name=by)

    report["end_to_end"] = [
        e2e("count_matches 64 MiB (G2)", len(hay64),
            lambda: ac.count_matches(hay64)),
        e2e("find_overlapping_iter 16 MiB (G2)", len(hay16),
            lambda: list(ac.find_overlapping_iter(hay16))),
        e2e("count_matches 594,915 B (G1)", len(hay_h),
            lambda: ac.count_matches(hay_h)),
        e2e("find_iter 594,915 B (G1)", len(hay_h),
            lambda: list(ac.find_iter(hay_h))),
    ]

    # The 64 MiB count's steps, RUNS times, each run beside a whole
    # count_matches call: the host pack, the pageable upload, the device's
    # stream-major transpose and the scan with its reduction, each ended
    # by a synchronise and read on the host clock, so the parts add up to
    # their sum; the upload and the transpose also in CUDA events.
    parts = {k: [] for k in ("count_matches", "sum_of_parts", "pack",
                             "upload", "transpose", "scan_and_sum",
                             "upload_events", "transpose_events")}
    for _ in range(RUNS):
        parts["count_matches"].append(host_ms(lambda: ac.count_matches(hay64)))
        t0 = time.perf_counter()
        x32 = torch.from_numpy(eng._pack(hay64, ph64.L, ph64.tiles,
                                         eng.tables.pad_byte))
        t1 = time.perf_counter()
        xd = x32.to(dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        halo, body = TB._to_stream_major(xd, ph64.L, ph64.tiles, eng.halo)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        c, _ = TK.bitap_scan_baked(lo, hi, sm, em, eng.tables.end_limbs,
                                   halo, body, False)
        assert int(c.sum()) == len(truth)
        t4 = time.perf_counter()
        for k, a, b in (("pack", t0, t1), ("upload", t1, t2),
                        ("transpose", t2, t3), ("scan_and_sum", t3, t4),
                        ("sum_of_parts", t0, t4)):
            parts[k].append((b - a) * 1e3)
        parts["upload_events"].append(events_ms(lambda: x32.to(dev)))
        parts["transpose_events"].append(events_ms(
            lambda: TB._to_stream_major(xd, ph64.L, ph64.tiles, eng.halo)))
        del x32, xd, halo, body, c
    med = {k: float(np.median(v)) for k, v in parts.items()}
    log("[e2e parts] count_matches 64 MiB, medians of "
        f"{RUNS}: " + ", ".join(f"{k} {v:.3f} ms" for k, v in med.items())
        + f" | {card}")
    report["prepare_parts"] = dict(runs_ms=parts, median_ms=med)

    # 7. Result lines --------------------------------------------------------------
    def entry(name, fn, line, r):
        return dict(name=name, route="cuda",
                    source="ahocorasick_tpu_torch/csrc/bitap.cu",
                    replaces=f"ahocorasick_tpu/ops/bitap.py:{line}",
                    launches=launches[name.split()[0]],
                    max_abs_err=errs[name.split()[0]], ms=r["ms"],
                    plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                    bound_by=r["bound_by"], library_ms=None, shape=r["name"],
                    function=fn)
    kernels = [
        entry("G1 bitap_generic_scan", "_make_kernel", 284, rows[2]),
        entry("G2 bitap_baked_scan", "_make_baked_kernel", 400, rows[0]),
    ]
    report["kernels"] = kernels
    report["seconds"] = time.time() - t_start
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    log(f"[done] {report['seconds']:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
