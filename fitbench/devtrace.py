"""The traced run: ``torch.profiler`` over the measured window, the
benchmark's own spans, and the reduction of the device's activity to the
numbers the per-layer readers take.

Spans are ``record_function`` ranges opened by the benchmark's own files
around each call into the program (``fitbench.window`` around the window,
``fitbench.fit`` around each fit), so they share the device events' clock.
Busy time is the union of the intervals in which any device operation
(kernel, copy or fill) ran, the arithmetic of the repository's smoke
script, frozen here.
"""
from __future__ import annotations

import bisect
import contextlib

WINDOW, FIT = "fitbench.window", "fitbench.fit"


def span(name: str, on: bool):
    """A benchmark span: a profiler range when tracing, else nothing."""
    if not on:
        return contextlib.nullcontext()
    from torch.profiler import record_function
    return record_function(name)


@contextlib.contextmanager
def profiled(on: bool, device_type: str):
    """Yield the profiler (None when ``on`` is false) for the window. On the
    card it records CPU and CUDA activity."""
    if not on:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device_type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof


def union(intervals):
    """Sorted, merged (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def clipped_total(merged, lo, hi, ends=None) -> float:
    """Length of the merged intervals inside [lo, hi]; ``ends`` is their
    list of ends, when the caller has it."""
    ends = ends if ends is not None else [m[1] for m in merged]
    i = bisect.bisect_right(ends, lo)
    tot = 0.0
    while i < len(merged) and merged[i][0] < hi:
        a, b = merged[i]
        tot += max(0.0, min(b, hi) - max(a, lo))
        i += 1
    return tot


def _host_op_at(ops, starts, t):
    """The innermost host op covering time t (the latest-starting one among
    the last 64 that began before t), or None."""
    i = bisect.bisect_right(starts, t)
    best = None
    for j in range(i - 1, max(-1, i - 65), -1):
        a, b, name = ops[j]
        if b >= t and (best is None or a > best[0]):
            best = (a, name)
    return None if best is None else best[1]


def summarize(prof) -> dict:
    """The window's device activity from a finished profiler: busy and
    window seconds, each fit's span with its busy seconds, device seconds
    and launches by operation name, and idle seconds by what the host was
    doing. Raises when the profiler recorded no device operation."""
    from torch.autograd import DeviceType
    events = prof.profiler.kineto_results.events()
    dev, spans, host = [], [], []
    for e in events:
        a, b = e.start_ns(), e.end_ns()
        if e.device_type() == DeviceType.CUDA:
            dev.append((a, b, e.name()))
        elif e.name() in (WINDOW, FIT):
            spans.append((a, b, e.name(), e.start_thread_id()))
        else:
            host.append((a, b, e.name(), e.start_thread_id()))
    # host ranges (the benchmark's spans, ``nccl:all_gather``) cast shadows
    # of the same name on the device timeline: they are no device work
    ranges = {WINDOW, FIT} | {h[2] for h in host}
    dev = [d for d in dev if d[2] not in ranges]
    windows = [s for s in spans if s[2] == WINDOW]
    if not windows:
        raise RuntimeError("the trace holds no window span")
    w0, w1, _, tid = windows[0]
    dev = [d for d in dev if d[1] > w0 and d[0] < w1]
    if not dev:
        raise RuntimeError("torch.profiler recorded no device operation in "
                           "the window")
    merged = union((a, b) for a, b, _ in dev)
    ends = [m[1] for m in merged]
    busy = clipped_total(merged, w0, w1, ends)
    fits = sorted((a, b) for a, b, name, _ in spans if name == FIT)
    fit_busy = [clipped_total(merged, a, b, ends) / 1e9 for a, b in fits]
    by_name = {}
    for a, b, name in dev:
        t, n = by_name.get(name, (0, 0))
        by_name[name] = (t + (b - a), n + 1)
    # idle gaps inside the window, named by the benchmark span and the
    # innermost host op on the window's thread at each gap's midpoint
    ops = sorted((a, b, name) for a, b, name, t in host if t == tid)
    starts = [o[0] for o in ops]
    fit_starts = [f[0] for f in fits]
    idle = {}
    edges = [w0] + [x for m in merged for x in m] + [w1]
    for k in range(0, len(edges), 2):
        a, b = max(edges[k], w0), min(edges[k + 1], w1)
        if b <= a:
            continue
        mid = (a + b) / 2
        j = bisect.bisect_right(fit_starts, mid) - 1
        where = FIT if j >= 0 and fits[j][1] >= mid else WINDOW
        op = _host_op_at(ops, starts, mid)
        key = f"{where} / {op or 'python'}"
        idle[key] = idle.get(key, 0.0) + (b - a) / 1e9
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": busy / 1e9,
        "fits": [((b - a) / 1e9, fb) for (a, b), fb in zip(fits, fit_busy)],
        "kernels": {k: [t / 1e9, n] for k, (t, n) in by_name.items()},
        "idle": idle,
    }


def kernel_seconds(summary: dict, *needles: str):
    """(seconds, launches) of the device operations whose name holds any
    of ``needles``."""
    t = n = 0
    for name, (s, c) in summary["kernels"].items():
        if any(x in name for x in needles):
            t += s
            n += c
    return t, n


def breakdown(summaries, top: int = 10) -> dict:
    """The operations of most device time and the idle seconds by what the
    host was doing, each averaged over the ranks' summaries."""
    ops, idle = {}, {}
    k = len(summaries)
    for s in summaries:
        for name, (t, _) in s["kernels"].items():
            ops[name] = ops.get(name, 0.0) + t / k
        for name, t in s["idle"].items():
            idle[name] = idle.get(name, 0.0) + t / k

    def ranked(d):
        return [[name[:160], t] for name, t in
                sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": ranked(ops), "idle_gaps": ranked(idle)}
