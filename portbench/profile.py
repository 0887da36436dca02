"""Device activity of a stretch of calls, read from torch.profiler.

A copy of the card smoke test's `trace` method, widened from one call to a
sub-window of calls: busy time is the union of the device's kernel, copy
and memset intervals; the benchmark's own labels (`record_function`
ranges, which the profiler also lays on the device timeline) are left out
of it. The device numbers are not measured (None) when the trace holds no
device activity, when any of it lies outside the window's range on the
host, or when it shows no host-to-device copy (every call uploads its
haystack): a trace that lost records would give too high an idle share.
"""

from __future__ import annotations

from typing import Callable, Dict, List

LABEL = "portbench."          # prefix of the benchmark's own labels
WINDOW = LABEL + "window"
TOP = 10                      # entries of each breakdown list
NAME = 160                    # letters kept of an operation's name


def _is_kernel(name: str) -> bool:
    return not (name.startswith("Memcpy") or name.startswith("Memset"))


def profiled(run_calls: Callable[[], int], log) -> Dict:
    """Run ``run_calls`` (returns how many calls it made; each call under a
    ``portbench.`` label) under torch.profiler and summarise it:
    ``calls``, ``window_s``, and, where measured, ``busy_s``, ``kernel_s``,
    ``launches``, ``device_ops`` and ``idle_gaps`` (each a list of at most
    TOP [name, seconds])."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            calls = run_calls()
            torch.cuda.synchronize()
    evs = prof.events()
    win = next(e for e in evs if e.name == WINDOW
               and e.device_type == torch.autograd.DeviceType.CPU)
    c0, c1 = win.time_range.start, win.time_range.end
    out = {"calls": calls, "window_s": (c1 - c0) / 1e6}
    dev, host = [], []
    for e in evs:
        r = (e.time_range.start, e.time_range.end, e.name)
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not e.name.startswith(LABEL):
                dev.append(r)
        elif e.name != WINDOW:
            host.append(r)
    dev.sort()
    if not dev:
        log("[profile] the trace holds no device activity: not measured")
        return out
    busy, end, by, gaps = 0.0, c0, {}, []
    for a, b, name in dev:
        if a > end:
            gaps.append((a - end, end))
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
        by[name] = by.get(name, 0.0) + (b - a) / 1e6
    if c1 > end:
        gaps.append((c1 - end, end))
    if dev[0][0] < c0 or end > c1:
        log(f"[profile] device activity from {(dev[0][0] - c0) / 1e3:.3f} "
            f"to {(end - c0) / 1e3:.3f} ms lies outside the "
            f"{(c1 - c0) / 1e3:.3f} ms window: not measured")
        return out
    if not any(k.startswith("Memcpy HtoD") for k in by):
        log("[profile] the trace holds no record of a haystack's upload: "
            "not measured")
        return out
    kernels = [(a, b) for a, b, name in dev if _is_kernel(name)]
    out.update(
        busy_s=busy / 1e6,
        kernel_s=sum(b - a for a, b in kernels) / 1e6,
        launches=len(kernels),
        device_ops=[[k[:NAME], v] for k, v in
                    sorted(by.items(), key=lambda kv: -kv[1])[:TOP]],
        idle_gaps=[[k, v] for k, v in
                   sorted(_idle_by_host(host, gaps).items(),
                          key=lambda kv: -kv[1])[:TOP]],
    )
    return out


def _idle_by_host(host: List, gaps: List) -> Dict[str, float]:
    """Seconds of the device's idle ``gaps`` ((length, start) in µs) by
    what the host was doing meanwhile: the innermost benchmark label open
    (``call`` outside any engine method: the facade) and the innermost
    other host operation open, if any."""
    idle = sorted((a, a + g) for g, a in gaps)
    marks = sorted([(a, 1, k) for k, (a, b, _) in enumerate(host)]
                   + [(b, 0, k) for k, (a, b, _) in enumerate(host)])
    open_: Dict[int, tuple] = {}
    out: Dict[str, float] = {}
    j, t = 0, idle[0][0] if idle else 0.0
    for at, is_start, k in marks + [(float("inf"), 0, None)]:
        # Charge [t, at) to what is open.
        while j < len(idle) and idle[j][1] <= t:
            j += 1
        jj = j
        while jj < len(idle) and idle[jj][0] < at:
            lo, hi = max(t, idle[jj][0]), min(at, idle[jj][1])
            if hi > lo:
                key = _doing(open_.values())
                out[key] = out.get(key, 0.0) + (hi - lo) / 1e6
            jj += 1
        t = at
        if k is None:
            break
        if is_start:
            open_[k] = host[k]
        else:
            open_.pop(k, None)
    return out


def _doing(open_) -> str:
    label = op = None
    for a, b, name in open_:
        if name.startswith(LABEL):
            if label is None or a >= label[0]:
                label = (a, name)
        elif op is None or a >= op[0]:
            op = (a, name)
    if label is None:
        text = "between calls"
    else:
        text = label[1][len(LABEL):]
        text = "facade" if text == "call" else text
    return text + (f" / {op[1][:NAME]}" if op else "")
