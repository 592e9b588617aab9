"""The program's own spans (``repro_torch.obs``, recorded under
``repro_torch.obs.recording``) laid over the profiler's trace of the
window.

Both are stamped on one clock (``time.time_ns``). For each span name this
gives its count and host seconds inside the fits, the device seconds of
the operations launched under it, and the device-idle seconds inside the
fits during which it was the innermost span on the fit's thread. A device
operation is matched to its launching runtime call (``cudaLaunchKernel``,
``cuLaunchKernel``, ``cudaMemcpyAsync``, ...) by correlation id, and that
call's start to the innermost span by time. Idle time and launches
inside a fit that no span covers go under ``(none)``, and device time
whose launch was not recorded goes under ``(unmatched)``. The idle partition takes the
device operations of ``devtrace.summarize`` and the same fits, so its
buckets add up to the fits' idle time, which ``host_ms_per_iter`` reads.

The profiler's device timestamps can sit off its host clock by up to
tens of milliseconds in a process, and drift against it by milliseconds
over a fit (the device clock's conversion), which would move idle gaps
onto the wrong span. So the device times are first put on the host
clock, one stretch at a time, each ending where a copy to pageable host
memory returns (the solve loop's one sync an iteration): an operation starts
no earlier than its launching call (the least shift), and the copy, which
its call waits for, ends before the call returns (the most). The middle
of that bracket is the stretch's shift; its width bounds the alignment's
error, and a negative width says the clocks drifted apart inside the
stretch.

On several ranks each rank also keeps, in order, the start of the first
NCCL kernel launched under each ``exchange`` span. ``exchange_wait_s``
lines the ranks' lists up.
"""
from __future__ import annotations

import bisect

from fitbench import devtrace

NONE, UNMATCHED = "(none)", "(unmatched)"
DISPATCH = ("iterate", "x_solve", "sweep", "stop_terms", "exchange")
NCCL = "nccl"


def innermost(spans):
    """Stretches of time, each with the innermost span open in it, from
    properly nested spans ``(start, end, name)``: sorted, non-overlapping
    ``(a, b, name, span_start)``. Time outside every span is left out."""
    out, stack, t = [], [], None

    def close_to(limit):
        nonlocal t
        while stack and stack[-1][0] <= limit:
            end, name, start = stack.pop()
            if end > t:
                out.append((t, end, name, start))
                t = end

    for a, b, name in sorted(spans, key=lambda s: (s[0], -s[1])):
        close_to(a)
        if stack and a > t:
            out.append((t, a, stack[-1][1], stack[-1][2]))
        stack.append((b, name, a))
        t = a
    close_to(float("inf"))
    return out


def _inside(intervals, starts, t) -> bool:
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and t < intervals[i][1]


def align(dev, launch):
    """``dev`` with its times moved onto the host clock, and the bracket
    ``(least, most)`` of each stretch's shift (ns; ``most`` is None for
    the stretch after the last copy)."""
    marks = sorted((launch[c][1], b) for a, b, name, c in dev
                   if c in launch and name.startswith("Memcpy DtoH")
                   and "Pageable" in name)
    ends = [m[0] for m in marks]
    lo = [None] * (len(marks) + 1)
    hi = [m[0] - m[1] for m in marks] + [None]

    def stretch(t):
        return bisect.bisect_left(ends, t)

    for a, _, _, c in dev:
        if c in launch:
            i = stretch(launch[c][0])
            lead = launch[c][0] - a
            lo[i] = lead if lo[i] is None else max(lo[i], lead)
    shift = [0 if x is None else max(x, 0) if y is None else (x + y) // 2
             for x, y in zip(lo, hi)]
    moved = []
    for a, b, name, c in dev:
        d = shift[stretch(launch[c][0] if c in launch else a)]
        moved.append((a + d, b + d, name, c))
    return moved, list(zip(lo, hi))


def attribute(dev, launch, fits, spans) -> dict:
    """The per-span table of one rank.

    ``dev``: device operations ``(start, end, name, correlation_id)``,
    the profiler's shadows of host ranges left out as
    ``devtrace.summarize`` leaves them out; ``launch``: the ``(start,
    end)`` of each runtime call by correlation id; ``fits``: the
    ``fitbench.fit`` spans ``(start, end)``; ``spans``: the program's
    spans on the fit's thread ``(start, end, name)``. Times in ns, the
    device's as the profiler gave them (``align`` moves them)."""
    fits = sorted(fits)
    fit_starts = [f[0] for f in fits]
    raw_lead = min((a - launch[c][0] for a, _, _, c in dev
                    if c in launch), default=None)
    dev, brackets = align(dev, launch)
    segs = innermost(spans)
    seg_starts = [s[0] for s in segs]
    table = {}

    def row(name):
        return table.setdefault(name, {"count": 0, "host_s": 0.0,
                                       "device_s": 0.0, "idle_s": 0.0})

    iters = 0
    for a, b, name in spans:
        if _inside(fits, fit_starts, a):
            r = row(name)
            r["count"] += 1
            r["host_s"] += (b - a) / 1e9
            iters += name == "iterate"

    def owner(t):
        i = bisect.bisect_right(seg_starts, t) - 1
        return segs[i] if i >= 0 and t < segs[i][1] else None

    early = early_ns = 0
    exchange = {}                  # exchange span start -> first NCCL start
    device_in_fits = 0.0
    ops = {}                       # span -> device seconds by operation
    for a, b, name, corr in dev:
        t = launch.get(corr, (None,))[0]
        if t is None:
            if _inside(fits, fit_starts, a):
                row(UNMATCHED)["device_s"] += (b - a) / 1e9
                device_in_fits += (b - a) / 1e9
            continue
        if not _inside(fits, fit_starts, t):
            continue
        device_in_fits += (b - a) / 1e9
        seg = owner(t)
        label = NONE if seg is None else seg[2]
        row(label)["device_s"] += (b - a) / 1e9
        by_op = ops.setdefault(label, {})
        by_op[name[:60]] = by_op.get(name[:60], 0.0) + (b - a) / 1e9
        if seg is None:
            continue
        if a < seg[3]:
            early += 1
            early_ns = max(early_ns, seg[3] - a)
        if seg[2] == "exchange" and NCCL in name.lower():
            exchange[seg[3]] = min(exchange.get(seg[3], a), a)

    # device idle inside the fits, split by the innermost span
    merged = devtrace.union((a, b) for a, b, *_ in dev)
    ends = [m[1] for m in merged]
    idle_total = 0.0
    for fa, fb in fits:
        gaps, t = [], fa
        i = bisect.bisect_right(ends, fa)
        while i < len(merged) and merged[i][0] < fb:
            if merged[i][0] > t:
                gaps.append((t, merged[i][0]))
            t = max(t, merged[i][1])
            i += 1
        if t < fb:
            gaps.append((t, fb))
        for ga, gb in gaps:
            idle_total += (gb - ga) / 1e9
            covered = 0
            j = max(0, bisect.bisect_right(seg_starts, ga) - 1)
            while j < len(segs) and segs[j][0] < gb:
                lo, hi = max(segs[j][0], ga), min(segs[j][1], gb)
                if hi > lo:
                    row(segs[j][2])["idle_s"] += (hi - lo) / 1e9
                    covered += hi - lo
                j += 1
            if gb - ga > covered:
                row(NONE)["idle_s"] += (gb - ga - covered) / 1e9
    return {"iters": iters, "spans": table,
            "fits_idle_s": idle_total, "fits_device_s": device_in_fits,
            "early": early, "early_max_ns": early_ns,
            "raw_lead_min_ns": raw_lead,
            "shift_ns": _range([(lo + hi) // 2 for lo, hi in brackets
                                if lo is not None and hi is not None]),
            "drifted": sum(1 for lo, hi in brackets if lo is not None
                           and hi is not None and hi < lo),
            "bracket_ns": _range([hi - lo for lo, hi in brackets
                                  if lo is not None and hi is not None]),
            "top_ops": {k: sorted(v.items(), key=lambda kv: -kv[1])[:3]
                        for k, v in ops.items()},
            "exchange_nccl_ns": [exchange[k] for k in sorted(exchange)]}


def _range(values):
    """[least, median, largest], or None for no values."""
    v = sorted(values)
    return [v[0], v[len(v) // 2], v[-1]] if v else None


def summarize(prof, events, tid) -> dict:
    """``attribute`` for a finished ``torch.profiler`` run and a
    ``Tracer``'s events (``Tracer.events()``), keeping the spans of the
    thread ``tid`` (``threading.get_ident()`` of the thread that ran the
    fits)."""
    from torch.autograd import DeviceType
    dev, launch, fits, host = [], {}, [], set()
    for e in prof.profiler.kineto_results.events():
        a, b, name = e.start_ns(), e.end_ns(), e.name()
        if e.device_type() == DeviceType.CUDA:
            dev.append((a, b, name, e.correlation_id()))
            continue
        host.add(name)
        if name == devtrace.FIT:
            fits.append((a, b))
        elif name.startswith("cu"):
            launch[e.correlation_id()] = (a, b)
    host.add(devtrace.WINDOW)
    dev = [d for d in dev if d[2] not in host]
    spans = [(e["ts_ns"], e["ts_ns"] + round(e["dur"] * 1000), e["name"])
             for e in events if e.get("ph") == "X" and e.get("tid") == tid
             and "ts_ns" in e]
    return attribute(dev, launch, fits, spans)


def exchange_wait_s(lists) -> float:
    """Seconds, summed over the exchanges and averaged over the ranks, by
    which each rank's NCCL kernel started before the latest rank's:
    ``lists[r][i]`` is rank r's start of its i-th exchange (ns)."""
    n = min(len(x) for x in lists)
    latest = [max(x[i] for x in lists) for i in range(n)]
    return sum(t - x[i] for x in lists for i, t in enumerate(latest)) \
        / len(lists) / 1e9


def per_iter_ms(summaries) -> dict:
    """The per-iteration milliseconds the split gives, averaged over the
    ranks' ``attribute`` tables: idle under ``host_sync`` (``sync_idle``),
    idle under the loop's launching spans (``dispatch_idle``), device time
    launched under ``stop_terms``, and on several ranks the exchange's
    wait for the slowest rank."""
    def mean(f):
        return sum(f(s) / s["iters"] for s in summaries) \
            / len(summaries) * 1e3

    def get(s, name, key):
        return s["spans"].get(name, {}).get(key, 0.0)

    out = {"sync_idle": mean(lambda s: get(s, "host_sync", "idle_s")),
           "dispatch_idle": mean(lambda s: sum(get(s, n, "idle_s")
                                               for n in DISPATCH)),
           "stop_terms": mean(lambda s: get(s, "stop_terms", "device_s"))}
    if len(summaries) > 1:
        out["exchange_wait"] = 1e3 * exchange_wait_s(
            [s["exchange_nccl_ns"] for s in summaries]) \
            / summaries[0]["iters"]
    return out


def table(summary) -> list:
    """Lines of the per-span table: count, host, device and idle seconds."""
    lines = [f"{'span':<14}{'count':>8}{'host_s':>12}{'device_s':>12}"
             f"{'idle_s':>12}"]
    for name, r in sorted(summary["spans"].items(),
                          key=lambda kv: -kv[1]["device_s"]):
        lines.append(f"{name:<14}{r['count']:>8}{r['host_s']:>12.6f}"
                     f"{r['device_s']:>12.6f}{r['idle_s']:>12.6f}")
    return lines
